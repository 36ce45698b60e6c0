"""Rules of the PyTorch port: it never imports JAX or the JAX package,
its entry points default to the card and refuse to fall back to the
CPU, and kernel_launch_count reports each route's launches."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.predictors import KNNLambdaPredictor, from_numpy
from repro_torch.kernels import ops
from repro_torch.kernels.fused_rank import rank_audited_cuda
from repro_torch.kernels.knn_topk import knn_rank_audited_cuda
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


def _default_device_calls():
    t = _small()
    knn = KNNLambdaPredictor.fit(t["X_db"], t["lam_db"], k=5, device="cpu")
    rank = (t["u"], t["a"], t["b"], t["lam"], t["gamma"])
    knn_args = (t["X"], t["X_db"], t["lam_db"], t["u"], t["a"], t["b"],
                t["gamma"])
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
    }


@pytest.mark.parametrize("name", sorted(_default_device_calls()))
def test_default_device_raises_without_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _default_device_calls()[name]()


def test_kernel_launch_count_by_route():
    t = _small()
    knn = KNNLambdaPredictor.fit(t["X_db"], t["lam_db"], k=5, device="cpu")
    assert ops.kernel_launch_count(None, 64) == 1
    assert ops.kernel_launch_count(knn, 64) == 2
    assert ops.kernel_launch_count(None, 128) == 1
    assert ops.kernel_launch_count(None, 129) == 0
    assert ops.kernel_launch_count(knn, 129) == 0
    assert ops.kernel_launch_count(knn, 64, device="cpu") == 0


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
