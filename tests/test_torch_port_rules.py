"""Rules of the PyTorch port: it never imports JAX or the JAX package,
its entry points default to the card and refuse to fall back to the
CPU, and kernel_launch_count reports each route's launches."""

import ast
import importlib.util
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.predictors import MLPLambdaPredictor as JaxMLP
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core import ranking
from repro_torch.core.constraints import (
    exposure_quota_constraints,
    make_constraints,
    movielens_style_constraints,
)
from repro_torch.data.synthetic import (
    build_experiment,
    make_interactions,
    make_movielens_corpus,
    make_yow_corpus,
    movielens_constraints,
)
from repro_torch.models.recommender import PaperRecommender, RecommenderConfig
from repro_torch.optim import adam_init
from repro_torch.core.predictors import (
    KNNLambdaPredictor,
    LinearLambdaPredictor,
    MeanLambdaPredictor,
    MLPLambdaPredictor,
    from_numpy,
    knn_quant_scan,
    pack_knn_db,
)
from repro_torch.kernels import ops
from repro_torch.kernels.ops import predict_rank_audited_stateful
from repro_torch.kernels.embedding_bag import embedding_bag_cuda
from repro_torch.kernels.fused_rank import MAX_KERNEL_M2
from repro_torch.kernels.fused_rank import (
    fused_rank_cuda,
    linear_rank_audited_cuda,
    rank_audited_cuda,
)
from repro_torch.kernels.knn_topk import (
    knn_lambda_cuda,
    knn_rank_audited_cuda,
    knn_topk_cuda,
)
from repro_torch.core.bvn import bvn_decompose, sinkhorn_project
from repro_torch.core.serving_dist import rank_distributed
from repro_torch.launch.mesh import make_smoke_mesh, virtual_mesh
from repro_torch.serving.engine import ServingEngine
from repro_torch.serving.refresh import RefreshLane, knn_ring_update

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py", REPO / "bench_rank.py",
    REPO / "probe_admission.py"] + [
    REPO / "examples" / f"{name}_torch.py"
    for name in ("quickstart", "constrained_feed", "serve_recsys",
                 "train_lm")]


def test_port_files_cover_the_refresh_slice():
    for rel in ("src/repro_torch/serving/refresh.py",
                "src/repro_torch/checkpoint/store.py",
                "src/repro_torch/checkpoint/__init__.py"):
        assert REPO / rel in PORT_FILES


def test_port_files_cover_the_lattice_and_fleet_slice():
    for name in ("lattice", "health", "faults", "fleet"):
        assert REPO / "src" / "repro_torch" / "serving" / f"{name}.py" in \
            PORT_FILES


def test_port_files_cover_the_serving_driver_slice():
    port = REPO / "src" / "repro_torch"
    for rel in ("models/recsys.py", "models/layers.py", "data/batches.py",
                "optim/clip.py", "configs/registry.py",
                "configs/recsys_family.py", "configs/deepfm.py",
                "configs/sasrec.py", "configs/bert4rec.py", "configs/mind.py",
                "configs/__init__.py", "launch/serve.py",
                "launch/__init__.py"):
        assert port / rel in PORT_FILES
    for name in ("quickstart", "constrained_feed", "serve_recsys"):
        assert REPO / "examples" / f"{name}_torch.py" in PORT_FILES


def test_port_files_cover_the_distribution_slice():
    port = REPO / "src" / "repro_torch"
    for rel in ("launch/mesh.py", "distributed/__init__.py",
                "distributed/sharding.py", "distributed/topk.py",
                "core/serving_dist.py", "configs/paper.py",
                "core/assignment.py", "core/monge.py", "core/bvn.py"):
        assert port / rel in PORT_FILES


def test_port_files_cover_the_lm_slice():
    port = REPO / "src" / "repro_torch"
    for rel in ("models/layers.py", "models/transformer.py",
                "optim/schedules.py", "optim/adafactor.py",
                "optim/__init__.py", "data/batches.py",
                "configs/lm_family.py", "configs/llama3_2_1b.py",
                "configs/mistral_nemo_12b.py", "configs/phi3_medium_14b.py",
                "configs/llama4_scout_17b_16e.py",
                "configs/kimi_k2_1t_a32b.py", "serving/engine.py",
                "launch/serve.py"):
        assert port / rel in PORT_FILES


def test_port_files_cover_the_gnn_and_training_slice():
    port = REPO / "src" / "repro_torch"
    for rel in ("models/gnn.py", "configs/gnn_family.py",
                "configs/meshgraphnet.py", "configs/__init__.py",
                "data/batches.py", "distributed/runner.py",
                "distributed/__init__.py", "launch/train.py",
                "checkpoint/store.py"):
        assert port / rel in PORT_FILES
    assert REPO / "examples" / "train_lm_torch.py" in PORT_FILES


def test_port_files_cover_the_cell_programs_slice():
    port = REPO / "src" / "repro_torch"
    for rel in ("distributed/sharding.py", "optim/compression.py",
                "optim/__init__.py", "configs/registry.py",
                "configs/lm_family.py", "configs/recsys_family.py",
                "configs/gnn_family.py", "launch/mesh.py",
                "models/layers.py", "checkpoint/store.py"):
        assert port / rel in PORT_FILES


def test_port_files_cover_the_dry_run_slice():
    port = REPO / "src" / "repro_torch" / "launch"
    for name in ("roofline", "graph_cost", "graph_analysis", "dryrun"):
        assert port / f"{name}.py" in PORT_FILES


def test_port_files_cover_the_lm_partition_slice():
    port = REPO / "src" / "repro_torch"
    for rel in ("models/transformer.py", "models/layers.py",
                "distributed/topk.py", "configs/lm_family.py",
                "launch/graph_cost.py", "launch/graph_analysis.py",
                "launch/dryrun.py", "launch/mesh.py"):
        assert port / rel in PORT_FILES
    from repro_torch.distributed import topk
    from repro_torch.models import transformer
    for name in ("all_gather_dim", "reduce_scatter_dim",
                 "reduce_from_shards", "copy_to_shards", "max_over_shards",
                 "one_body"):
        assert callable(getattr(topk, name))
    assert callable(transformer.lm_plan)
    assert (REPO / "tests" / "test_torch_lm_sharded.py").is_file()


def test_port_files_cover_the_paper_partition_slice():
    port = REPO / "src" / "repro_torch"
    for rel in ("configs/paper.py", "core/dual_solver.py",
                "core/serving_dist.py", "distributed/topk.py",
                "launch/graph_analysis.py", "launch/dryrun.py"):
        assert port / rel in PORT_FILES
    from repro_torch.core import dual_solver, serving_dist
    from repro_torch.distributed import topk
    from repro_torch.launch.graph_analysis import EXCHANGES
    for name in ("all_to_all_dim", "position_blocks", "assemble",
                 "merge_top_k"):
        assert callable(getattr(topk, name))
    assert callable(dual_solver.solve_dual_partitioned)
    assert callable(serving_dist.serve_partitioned)
    assert "all-to-all" in EXCHANGES
    assert (REPO / "tests" / "test_torch_paper_sharded.py").is_file()


# the port's files whose names differ from their JAX counterparts' (the
# port has no HLO: its cost walk runs the program itself), and the one
# JAX file with no counterpart (a JAX shim)
RENAMED = {"launch/hlo_cost.py": "launch/graph_cost.py",
           "launch/hlo_analysis.py": "launch/graph_analysis.py"}
NO_COUNTERPART = {"distributed/compat.py"}


def test_every_module_of_the_jax_package_has_its_counterpart():
    jax_pkg, port = REPO / "src" / "repro", REPO / "src" / "repro_torch"
    missing = []
    for path in sorted(jax_pkg.rglob("*.py")):
        rel = path.relative_to(jax_pkg).as_posix()
        if rel in NO_COUNTERPART:
            assert not (port / rel).exists()
            continue
        if not (port / RENAMED.get(rel, rel)).is_file():
            missing.append(rel)
    assert missing == []
    assert all((port / p).is_file() for p in RENAMED.values())


@pytest.mark.parametrize("package", ["distributed", "optim"])
def test_package_exports_every_name_of_jax(package):
    """repro_torch.distributed and repro_torch.optim export every public
    name their JAX counterparts import (the mesh-context half of
    sharding and the compressed psum included), each defined."""
    import importlib
    import inspect

    jpkg = importlib.import_module(f"repro.{package}")
    tpkg = importlib.import_module(f"repro_torch.{package}")
    names = {n for n, v in vars(jpkg).items()
             if not n.startswith("_") and not inspect.ismodule(v)}
    assert names <= set(tpkg.__all__), sorted(names - set(tpkg.__all__))
    assert all(hasattr(tpkg, name) for name in tpkg.__all__)


def test_distributed_exports_every_name_of_jax_sharding():
    """repro_torch.distributed exports every public name that
    repro.distributed.sharding defines (its functions, tables and
    classes), as the mesh-context half of sharding is now ported."""
    import inspect

    import repro.distributed.sharding as jsharding
    import repro_torch.distributed as tdist

    names = {n for n, v in vars(jsharding).items()
             if not n.startswith("_") and not inspect.ismodule(v)
             and getattr(v, "__module__", jsharding.__name__)
             in (jsharding.__name__, None)}
    names |= {n for n in ("LM_RULES", "RECSYS_RULES", "GNN_RULES",
                          "PAPER_RULES", "RULES_BY_FAMILY")}
    assert names <= set(tdist.__all__), sorted(names - set(tdist.__all__))


def test_core_has_every_name_of_jax_core():
    """Every public name repro.core imports is in repro_torch.core's
    exports, and nothing more."""
    import inspect

    import repro.core as jcore
    import repro_torch.core as tcore

    names = {n for n, v in vars(jcore).items()
             if not n.startswith("_") and not inspect.ismodule(v)}
    assert names == set(tcore.__all__)
    assert all(hasattr(tcore, name) for name in names)


def test_serving_exports_match_jax_but_the_autotune_table():
    """The port's serving exports are JAX's, the autotune table's
    resolve_autotune included (it was the one name missing before the
    table was ported)."""
    import repro.serving as jserving
    import repro_torch.serving as tserving

    missing = set(jserving.__all__) - set(tserving.__all__)
    assert missing == set()
    assert not set(tserving.__all__) - set(jserving.__all__)
    assert all(hasattr(tserving, name) for name in tserving.__all__)


def _in_a_store(call):
    """Run call(store) on a store in a throwaway directory."""
    with tempfile.TemporaryDirectory() as d:
        return call(CheckpointStore(d))


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


def _example_main(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.main


def _default_device_calls():
    from repro_torch.configs import get_arch
    from repro_torch.data.batches import (
        make_deepfm_batch,
        make_lm_batch,
        make_seqrec_batch,
    )
    from repro_torch.launch import serve as launch
    from repro_torch.models.recsys import RECSYS_REGISTRY
    from repro_torch.models.transformer import (
        TransformerLM,
        lm_from_numpy,
        lm_init,
        lm_state_numpy,
        make_decode_cache,
    )
    from repro_torch.optim import adafactor_init

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
    mlp = MLPLambdaPredictor.fit(t["X_db"], t["lam_db"], num_steps=1,
                                 device="cpu")
    bag = torch.tensor([[0, 3, -1], [19, 2, 2]], dtype=torch.int32)
    cpu_mesh = make_smoke_mesh(device="cpu")
    lm_cfg = get_arch("llama3.2-1b").make_config(full=False)
    return {
        "make_smoke_mesh": lambda: make_smoke_mesh(),
        "make_smoke_mesh(multi_pod)": lambda: make_smoke_mesh(
            multi_pod=True),
        "virtual_mesh": lambda: virtual_mesh((1, 4), ("data", "model")),
        "rank_distributed": lambda: rank_distributed(
            make_smoke_mesh(), t["u"], t["a"], t["b"], t["lam"], t["gamma"],
            m2=8),
        "ServingEngine(dist)": lambda: ServingEngine(executor="dist",
                                                     mesh=cpu_mesh),
        "bvn_decompose": lambda: bvn_decompose(np.eye(3)),
        "sinkhorn_project": lambda: sinkhorn_project(np.ones((3, 3))),
        "ServingEngine": lambda: ServingEngine(),
        "ServingEngine(xla)": lambda: ServingEngine(executor="xla"),
        "lm_init": lambda: lm_init(None, lm_cfg),
        "TransformerLM": lambda: TransformerLM(lm_cfg),
        "lm_from_numpy": lambda: lm_from_numpy(lm_state_numpy(
            lm_init(None, lm_cfg, device="cpu")), lm_cfg),
        "make_decode_cache": lambda: make_decode_cache(lm_cfg, 2, 8),
        "make_lm_batch": lambda: make_lm_batch(
            torch.Generator(), batch=2, seq=4, vocab=9),
        "adafactor_init": lambda: adafactor_init({"w": t["X"]}),
        "RefreshLane": lambda: RefreshLane(ServingEngine()),
        "knn_ring_update": lambda: knn_ring_update(
            np.ones((20, 4)), np.ones((20, 3)), np.ones((2, 4)),
            np.ones((2, 3)), 0),
        "CheckpointStore.restore": lambda: _in_a_store(
            lambda s: s.restore({"x": t["X"]})),
        "CheckpointStore.load_predictor_epoch": lambda: _in_a_store(
            lambda s: s.load_predictor_epoch("knn")),
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
        "ops.fused_rank": lambda: ops.fused_rank(t["u"], t["a"], t["lam"],
                                                 m2=8),
        "ops.fused_rank(m2>128)": lambda: ops.fused_rank(
            t["u"], t["a"], t["lam"], m2=129),
        "ops.rank_audited(m2>128)": lambda: ops.rank_audited(*rank, m2=129),
        "ops.knn_topk": lambda: ops.knn_topk(t["X"], t["X_db"], k=5),
        "ops.knn_predict_kernel": lambda: ops.knn_predict_kernel(
            t["X_db"], t["lam_db"], t["X"], k=5),
        "ops.embedding_bag": lambda: ops.embedding_bag(t["X_db"], bag),
        "fused_rank_cuda": lambda: fused_rank_cuda(t["u"], t["a"], t["lam"],
                                                   m2=8),
        "knn_topk_cuda": lambda: knn_topk_cuda(t["X"], t["X_db"], k=5),
        "embedding_bag_cuda": lambda: embedding_bag_cuda(t["X_db"], bag),
        "make_constraints": lambda: make_constraints(
            [np.ones(4)], [1.0], [1.0]),
        "offline_solve": lambda: ranking.offline_solve(
            *train[1:], m2=8, num_iters=2),
        "fit_pipeline": lambda: ranking.fit_pipeline(
            *train, m2=8, num_iters=2, knn_k=1),
        "serve": lambda: ranking.serve(pipe, *hold, predictor="linear"),
        "rank_with_strategy": lambda: ranking.rank_with_strategy(
            pipe, "none", *hold),
        "fit_pipeline(with_mlp)": lambda: ranking.fit_pipeline(
            *train, m2=8, num_iters=2, knn_k=1, with_mlp=True, mlp_steps=1),
        "MLPLambdaPredictor.fit": lambda: MLPLambdaPredictor.fit(
            t["X_db"], t["lam_db"], num_steps=1),
        "from_numpy(mlp)": lambda: from_numpy({"params": {
            "w1": np.ones((4, 2)), "b1": np.ones(2), "w2": np.ones((2, 3)),
            "b2": np.ones(3)}}),
        "MLPLambdaPredictor.to": lambda: mlp.to(None),
        "ops.predict_rank_audited(mlp)": lambda: ops.predict_rank_audited(
            t["X"], mlp, t["u"], t["a"], t["b"], t["gamma"], m2=8),
        "predict_rank_audited_stateful":
            lambda: predict_rank_audited_stateful(
                {"mean_lam": fam["mean"].mean_lam}, fam["mean"], t["X"],
                t["u"], t["a"], t["b"], t["gamma"], m2=8),
        "adam_init": lambda: adam_init({"w": t["X"]}),
        "PaperRecommender": lambda: PaperRecommender(
            RecommenderConfig(n_users=3, n_items=4)),
        "make_interactions": lambda: make_interactions(
            torch.Generator(), n_users=3, n_items=4, n_obs=5),
        "make_movielens_corpus": lambda: make_movielens_corpus(
            torch.Generator(), 10),
        "make_yow_corpus": lambda: make_yow_corpus(torch.Generator(), 10),
        "movielens_constraints": lambda: movielens_constraints(
            make_movielens_corpus(torch.Generator(), 10, device="cpu"),
            np.arange(4), t["gamma"][0], 8),
        "exposure_quota_constraints": lambda: exposure_quota_constraints(
            np.ones((2, 3)), [0.1, 0.1], [1, -1], t["gamma"][0]),
        "movielens_style_constraints": lambda: movielens_style_constraints(
            np.ones((4, 3)), np.zeros(3), 0.1, t["gamma"][0]),
        "build_experiment": lambda: build_experiment(
            torch.Generator(), dataset="yow", n_users=8, n_items=20, m1=10,
            m2=4, recommender_epochs=1),
        "RECSYS_REGISTRY(deepfm)": lambda: RECSYS_REGISTRY["deepfm"](
            get_arch("deepfm").make_config(full=False)),
        "RECSYS_REGISTRY(mind)": lambda: RECSYS_REGISTRY["mind"](
            get_arch("mind").make_config(full=False)),
        "make_deepfm_batch": lambda: make_deepfm_batch(
            torch.Generator(), batch=2, n_sparse=3, field_vocab=5),
        "make_seqrec_batch": lambda: make_seqrec_batch(
            torch.Generator(), batch=2, seq_len=4, n_items=9, n_neg=2),
        "launch.serve.main": lambda: launch.main(
            ["--arch", "sasrec", "--train-steps", "1", "--requests", "4",
             "--offline-users", "16"]),
        "quickstart_torch.main": lambda: _example_main("quickstart_torch")(
            []),
        "constrained_feed_torch.main": lambda: _example_main(
            "constrained_feed_torch")([]),
        "serve_recsys_torch.main": lambda: _example_main(
            "serve_recsys_torch")(["--requests", "4"]),
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
    rank_audited), over the f32 or the quantized db alike; for m2 > 128
    KNN 2 (knn_lambda's pair, fused or chain) and the others 0 (the sort
    route); 0 where the plain path runs."""
    fam = _families(_small())
    knn = fam["knn"]
    for quant in (fam["knn_int8"], knn.quantized("bf16", device="cpu")):
        assert ops.kernel_launch_count(quant, 64) == 2
        assert ops.kernel_launch_count(quant, 64, knn_chain=True) == 3
        assert ops.kernel_launch_count(quant, 64, device="cpu") == 0
        assert ops.kernel_launch_count(quant, 129) == 2
        assert ops.kernel_launch_count(quant, 500, knn_chain=True) == 2
        assert ops.kernel_launch_count(quant, 500, device="cpu") == 0
    assert ops.kernel_launch_count(None, 64) == 1
    assert ops.kernel_launch_count(fam["linear"], 64) == 1
    assert ops.kernel_launch_count(fam["mean"], 64) == 1
    assert ops.kernel_launch_count(knn, 64) == 2
    assert ops.kernel_launch_count(knn, 64, knn_chain=True) == 3
    assert ops.kernel_launch_count(None, 128) == 1
    assert ops.kernel_launch_count(None, 129) == 0
    assert ops.kernel_launch_count(knn, 129) == 2
    assert ops.kernel_launch_count(knn, 129, knn_chain=True) == 2
    assert ops.kernel_launch_count(fam["linear"], 129) == 0
    assert ops.kernel_launch_count(fam["mean"], 512) == 0
    assert ops.kernel_launch_count(knn, 64, device="cpu") == 0
    assert ops.kernel_launch_count(fam["mean"], 64, device="cpu") == 0


def test_mlp_predictor_raises_not_implemented():
    """The MLP family, once refused by name, now has its route: a JAX
    MLP's parameters carried across by from_numpy give the port's MLP,
    which counts one rank_audited launch at m2 <= 128 and none above,
    ranks on the CPU as the plain version does and registers with the
    engine."""
    t = _small()
    jmlp = JaxMLP.fit(jnp.asarray(t["X_db"].numpy()),
                      jnp.asarray(t["lam_db"].numpy()), num_steps=2)
    mlp = from_numpy({"params": {k: np.asarray(v) for k, v in
                                 jmlp.params.items()}}, device="cpu")
    assert isinstance(mlp, MLPLambdaPredictor) and ops.route_of(mlp) == "mlp"
    assert ops.kernel_launch_count(mlp, 64) == 1
    assert ops.kernel_launch_count(mlp, MAX_KERNEL_M2 + 1) == 0
    out = ops.predict_rank_audited(t["X"], mlp, t["u"], t["a"], t["b"],
                                   t["gamma"], m2=8, device="cpu")
    want = ranking.rank_given_lambda(t["u"], t["a"], t["b"],
                                     mlp.predict(t["X"]), t["gamma"], m2=8)
    assert torch.equal(out.perm, want.perm)
    ServingEngine(device="cpu").register_predictor("mlp", mlp, d_cov=4)


def test_unported_routes_raise_not_implemented():
    """An object that is no predictor (it has no predict) is refused on
    every route, at any m2, before anything runs."""
    t = _small()
    g = torch.ones((2, 64))
    for m2, gamma in ((8, t["gamma"]), (64 + MAX_KERNEL_M2, g)):
        with pytest.raises(TypeError, match="no predictor"):
            ops.kernel_launch_count(object(), m2)
        with pytest.raises(TypeError, match="no predictor"):
            ops.predict_rank_audited(t["X"], object(), t["u"], t["a"],
                                     t["b"], gamma, m2=m2, device="cpu")
    with pytest.raises(TypeError, match="no predictor"):
        ServingEngine(device="cpu").register_predictor("x", object(),
                                                       d_cov=4)


def test_large_m2_route_is_chosen_by_shape(monkeypatch):
    """m2 > MAX_KERNEL_M2 on the lambda-given routes sorts the einsum
    score before any wrapper is reached, as JAX's use_kernel = m2 <=
    MAX_KERNEL_M2 chooses; a kernel shape reaches the wrapper. No
    launch is counted there."""
    def refuse(*args, **kw):
        raise AssertionError("a kernel wrapper was reached")

    monkeypatch.setattr(ops, "rank_audited_cuda", refuse)
    monkeypatch.setattr(ops, "fused_rank_cuda", refuse)
    rng = np.random.default_rng(1)
    u, a = rng.normal(size=(2, 300)), rng.random((2, 3, 300))
    lam, b = rng.random((2, 3)), np.zeros((2, 3))
    g = np.ones(200)
    vals, idx = ops.fused_rank(u, a, lam, m2=200, device="cpu")
    assert idx.shape == (2, 200) and (vals[:, :-1] >= vals[:, 1:]).all()
    out = ops.rank_audited(u, a, b, lam, g, m2=200, device="cpu")
    assert torch.equal(out.perm, idx)
    out = ops.predict_rank_audited(torch.tensor(lam), None, u, a, b, g,
                                   m2=200, device="cpu")
    assert torch.equal(out.perm, idx)
    assert ops.kernel_launch_count(None, 200) == 0
    with pytest.raises(AssertionError, match="wrapper was reached"):
        ops.fused_rank(u, a, lam, m2=128, device="cpu")
    with pytest.raises(AssertionError, match="wrapper was reached"):
        ops.rank_audited(u, a, b, lam, g[:128], m2=128, device="cpu")
