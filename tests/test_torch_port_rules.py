"""Rules of the PyTorch port: it never imports JAX or the JAX package,
its entry points default to the card and refuse to fall back to the
CPU, and kernel_launch_count reports each route's launches."""

import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.predictors import MLPLambdaPredictor as JaxMLP
from repro_torch.core import ranking
from repro_torch.core.constraints import make_constraints
from repro_torch.core.predictors import (
    KNNLambdaPredictor,
    LinearLambdaPredictor,
    MeanLambdaPredictor,
    from_numpy,
    knn_quant_scan,
    pack_knn_db,
)
from repro_torch.kernels import ops
from repro_torch.kernels.fused_rank import (
    linear_rank_audited_cuda,
    rank_audited_cuda,
)
from repro_torch.kernels.knn_topk import knn_lambda_cuda, knn_rank_audited_cuda
from repro_torch.serving.engine import ServingEngine

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_neither_jax_nor_repro(path):
    assert path.exists()
    assert not _imported_roots(path) & {"jax", "jaxlib", "repro"}


def _small():
    rng = np.random.default_rng(0)
    t = {"u": rng.uniform(1, 5, (2, 64)), "a": rng.random((2, 3, 64)),
         "b": np.zeros((2, 3)), "lam": np.ones((2, 3)),
         "gamma": np.ones((2, 8)), "X": rng.normal(size=(2, 4)),
         "X_db": rng.normal(size=(20, 4)), "lam_db": np.ones((20, 3))}
    return {k: torch.tensor(v, dtype=torch.float32) for k, v in t.items()}


def _families(t):
    knn = KNNLambdaPredictor.fit(t["X_db"], t["lam_db"], k=5, device="cpu")
    return {"knn": knn,
            "knn_int8": knn.quantized("int8", slab=8, device="cpu"),
            "linear": LinearLambdaPredictor.fit(t["X_db"], t["lam_db"],
                                                device="cpu"),
            "mean": MeanLambdaPredictor.fit(t["X_db"], t["lam_db"],
                                            device="cpu")}


def _default_device_calls():
    t = _small()
    fam = _families(t)
    knn = fam["knn"]
    rank = (t["u"], t["a"], t["b"], t["lam"], t["gamma"])
    knn_args = (t["X"], t["X_db"], t["lam_db"], t["u"], t["a"], t["b"],
                t["gamma"])
    W, c = fam["linear"].W, fam["linear"].c
    linear_args = (t["u"], t["a"], t["b"], t["X"], W, c, t["gamma"])
    train = (t["X"], t["u"], t["a"], t["b"][0], t["gamma"][0])
    pipe = ranking.fit_pipeline(*train, m2=8, num_iters=2, knn_k=1,
                                device="cpu")
    hold = (t["X"], t["u"], t["a"], t["b"][0])
    return {
        "ServingEngine": lambda: ServingEngine(),
        "ops.predict_rank_audited": lambda: ops.predict_rank_audited(
            t["X"], knn, t["u"], t["a"], t["b"], t["gamma"], m2=8),
        "ops.predict_rank_audited(lam)": lambda: ops.predict_rank_audited(
            t["lam"], None, t["u"], t["a"], t["b"], t["gamma"], m2=8),
        "ops.rank_audited": lambda: ops.rank_audited(*rank, m2=8),
        "ops.knn_rank_audited": lambda: ops.knn_rank_audited(
            *knn_args, k=5, m2=8),
        "rank_audited_cuda": lambda: rank_audited_cuda(*rank, m2=8),
        "knn_rank_audited_cuda": lambda: knn_rank_audited_cuda(
            *knn_args, k=5, m2=8),
        "KNNLambdaPredictor.fit": lambda: KNNLambdaPredictor.fit(
            t["X_db"], t["lam_db"]),
        "from_numpy": lambda: from_numpy(
            {"X_db": np.ones((20, 4)), "lam_db": np.ones((20, 3))}, k=5),
        "from_numpy(linear)": lambda: from_numpy(
            {"W": np.ones((3, 4)), "c": np.ones(3)}),
        "from_numpy(mean)": lambda: from_numpy({"mean_lam": np.ones(3)}),
        "LinearLambdaPredictor.fit": lambda: LinearLambdaPredictor.fit(
            t["X_db"], t["lam_db"]),
        "MeanLambdaPredictor.fit": lambda: MeanLambdaPredictor.fit(
            t["X_db"], t["lam_db"]),
        "linear_rank_audited_cuda": lambda: linear_rank_audited_cuda(
            *linear_args, m2=8),
        "knn_lambda_cuda": lambda: knn_lambda_cuda(
            t["X"], t["X_db"], t["lam_db"], k=5),
        "ops.knn_lambda": lambda: ops.knn_lambda(
            t["X"], t["X_db"], t["lam_db"], k=5),
        "ops.linear_rank_audited": lambda: ops.linear_rank_audited(
            t["X"], W, c, t["u"], t["a"], t["b"], t["gamma"], relu=True,
            m2=8),
        "ops.predict_rank_audited(linear)": lambda: ops.predict_rank_audited(
            t["X"], fam["linear"], t["u"], t["a"], t["b"], t["gamma"],
            m2=8),
        "pack_knn_db": lambda: pack_knn_db(t["X_db"], mode="int8"),
        "KNNLambdaPredictor.quantized": lambda: knn.quantized("bf16"),
        "knn_quant_scan": lambda: knn_quant_scan(
            fam["knn_int8"].X_q, fam["knn_int8"].q_scale,
            fam["knn_int8"].y2_q, t["X"], k=5),
        "ops.knn_lambda(quant)": lambda: ops.knn_lambda(
            t["X"], t["X_db"], t["lam_db"], k=5, quant="int8"),
        "ops.predict_rank_audited(knn_int8)":
            lambda: ops.predict_rank_audited(
                t["X"], fam["knn_int8"], t["u"], t["a"], t["b"],
                t["gamma"], m2=8),
        "ops.predict_rank_audited(knn_chain)":
            lambda: ops.predict_rank_audited(
                t["X"], knn, t["u"], t["a"], t["b"], t["gamma"], m2=8,
                knn_chain=True),
        "make_constraints": lambda: make_constraints(
            [np.ones(4)], [1.0], [1.0]),
        "offline_solve": lambda: ranking.offline_solve(
            *train[1:], m2=8, num_iters=2),
        "fit_pipeline": lambda: ranking.fit_pipeline(
            *train, m2=8, num_iters=2, knn_k=1),
        "serve": lambda: ranking.serve(pipe, *hold, predictor="linear"),
        "rank_with_strategy": lambda: ranking.rank_with_strategy(
            pipe, "none", *hold),
    }


@pytest.mark.parametrize("name", sorted(_default_device_calls()))
def test_default_device_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _default_device_calls()[name]()


def test_kernel_launch_count_by_route():
    """Launches per micro-batch on an assumed card: lambda given 1,
    linear 1, mean 1, KNN 2, the KNN chain 3 (knn_lambda's two, then
    rank_audited), over the f32 or the quantized db alike; 0 where the
    plain path runs."""
    fam = _families(_small())
    knn = fam["knn"]
    for quant in (fam["knn_int8"], knn.quantized("bf16", device="cpu")):
        assert ops.kernel_launch_count(quant, 64) == 2
        assert ops.kernel_launch_count(quant, 64, knn_chain=True) == 3
        assert ops.kernel_launch_count(quant, 64, device="cpu") == 0
        assert ops.kernel_launch_count(quant, 129) == 0
    assert ops.kernel_launch_count(None, 64) == 1
    assert ops.kernel_launch_count(fam["linear"], 64) == 1
    assert ops.kernel_launch_count(fam["mean"], 64) == 1
    assert ops.kernel_launch_count(knn, 64) == 2
    assert ops.kernel_launch_count(knn, 64, knn_chain=True) == 3
    assert ops.kernel_launch_count(None, 128) == 1
    assert ops.kernel_launch_count(None, 129) == 0
    assert ops.kernel_launch_count(knn, 129) == 0
    assert ops.kernel_launch_count(fam["linear"], 129) == 0
    assert ops.kernel_launch_count(knn, 64, device="cpu") == 0
    assert ops.kernel_launch_count(fam["mean"], 64, device="cpu") == 0


def test_mlp_predictor_raises_not_implemented():
    t = _small()
    mlp = JaxMLP.fit(jnp.asarray(t["X_db"].numpy()),
                     jnp.asarray(t["lam_db"].numpy()), num_steps=2)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        ops.kernel_launch_count(mlp, 64)
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        ops.predict_rank_audited(t["X"], mlp, t["u"], t["a"], t["b"],
                                 t["gamma"], m2=8, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        ServingEngine(device="cpu").register_predictor("mlp", mlp, d_cov=4)


def test_unported_routes_raise_not_implemented():
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        ops.kernel_launch_count(object(), 64)
    t = _small()
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        ops.predict_rank_audited(t["X"], object(), t["u"], t["a"], t["b"],
                                 t["gamma"], m2=8, device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        ops._check_m2(129, torch.device("cuda"))
    assert ops._check_m2(129, torch.device("cpu")) is False
