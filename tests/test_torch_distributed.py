"""The port's distribution (launch.mesh, distributed.sharding and topk,
core.serving_dist, the engine's `dist` executor, configs.paper) against
JAX's distributed functions.

JAX's shard_map functions need a mesh of devices, so they run once, in
one module-scoped subprocess with 8 forced host devices (as
tests/test_multidevice.py runs them), on the (2, 4) ('data', 'model')
and (2, 2, 2) ('pod', 'data', 'model') smoke meshes; it reads its
inputs from an .npz written here from numpy seeds and writes its outputs
to another. The port runs the same inputs on virtual meshes of the same
shapes over the CPU, where every shard body runs the kernels' plain
versions.

Tolerances: idx, perm and compliant exact; utility rtol 1e-5; exposure
rtol 1e-5, atol 1e-6; lambda-hat rtol 1e-5, atol 1e-6 against JAX,
quantized too; d2 rtol 1e-5, atol 1e-5 (JAX's d2 is an XLA matmul, the
port's plain knn_topk the kernel's coordinate-by-coordinate dot).
Against the port's own dense counterparts on the same inputs the bound
is JAX's own pair's (tests/test_multidevice.py:120-121), rtol 5e-7,
atol 1e-7 (knn_predict_chunked: a matmul d2 and plain norms); the
dist λ̂ is bitwise the dense route the card takes (ops.knn_lambda: the
kernel's d2 and sq_norm_seq's norms, its plain version here;
knn_predict_quant: the same exact-on-x~ survivors, |q|^2 in
sq_norm_seq's order and y2_q), and the tests say so with torch.equal.
"""

import os
import subprocess
import sys
import tempfile
import textwrap
from dataclasses import fields
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import FrozenClock
from repro.configs.paper import PAPER_CELLS as JAX_CELLS
from repro.configs.paper import PAPER_SMOKE_CELLS as JAX_SMOKE_CELLS
from repro.configs.paper import PaperConfig as JaxPaperConfig
from repro.configs.registry import get_arch as jax_get_arch
from repro.distributed import sharding as jsharding
from repro.serving import RankRequest as JaxRequest
from repro.serving import Scenario, make_stream
from repro_torch.configs import get_arch
from repro_torch.configs.paper import (
    PAPER_CELLS,
    PAPER_SMOKE_CELLS,
    PaperConfig,
    build_paper,
)
from repro_torch.core.constraints import dcg_discount
from repro_torch.core.predictors import (
    KNNLambdaPredictor,
    knn_predict_chunked,
    knn_predict_quant,
)
from repro_torch.core.serving_dist import (
    dist_kernel_launches,
    knn_predict_distributed,
    knn_predict_quant_distributed,
    rank_distributed,
)
from repro_torch.distributed import sharding
from repro_torch.distributed.topk import (
    distributed_top_k,
    sharded_knn_topk,
    sharded_score_topk,
)
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (
    Mesh,
    Sharded,
    make_mesh,
    make_production_mesh,
    make_smoke_mesh,
    shard_rows,
    virtual_mesh,
)
from repro_torch.serving.engine import RankRequest, ServingEngine

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
MESHES = ("2x4", "2x2x2")
D2_TOL = dict(rtol=1e-5, atol=1e-5)
LAM_TOL = dict(rtol=1e-5, atol=1e-6)
SELF_TOL = dict(rtol=5e-7, atol=1e-7)
UTIL_TOL = dict(rtol=1e-5)
EXPO_TOL = dict(rtol=1e-5, atol=1e-6)
# the engine streams: JAX's mix (tests/test_multidevice.py:186-202) and
# a KNN surface over a 128-row db
MIX = (Scenario("feed", m1=200, m2=16, K=3, weight=2.0),
       Scenario("strip", m1=400, m2=8, K=5, weight=1.0))
KNN_MIX = (Scenario("knn_feed", m1=256, m2=16, K=5, tag="knn", d_cov=10),)
RANK_M2 = {"2x4": (8, 24), "2x2x2": (8, 40)}   # the second > m1 local

_PROG = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.configs.paper import PAPER_SMOKE_CELLS, PaperConfig, build_paper
    from repro.core.predictors import KNNLambdaPredictor, pack_knn_db
    from repro.core.serving_dist import (
        knn_predict_distributed, knn_predict_quant_distributed,
        rank_distributed)
    from repro.distributed.compat import shard_map
    from repro.distributed.sharding import use_mesh_rules
    from repro.distributed.topk import (
        distributed_top_k, sharded_knn_topk, sharded_score_topk)
    from repro.launch.mesh import make_smoke_mesh
    from repro.serving import Scenario, ServingEngine, make_stream

    src, dst = sys.argv[1], sys.argv[2]
    x = dict(np.load(src))
    out = {}
    meshes = {"2x4": make_smoke_mesh(), "2x2x2": make_smoke_mesh(multi_pod=True)}
    for name, mesh in meshes.items():
        def put(k, v):
            out[name + "/" + k] = np.asarray(v)
        d2, idx = jax.jit(lambda q, db: sharded_knn_topk(mesh, q, db, k=10))(
            x["xq"], x["xdb"])
        put("knn_topk/d2", d2); put("knn_topk/idx", idx)
        v, i = jax.jit(lambda s: sharded_score_topk(mesh, s, 5))(
            x["scores"])
        put("score_topk/v", v); put("score_topk/i", i)

        def body(s_l, p_l, q_l):
            return distributed_top_k(s_l, 6, "model",
                                     payload={"p": p_l, "q": q_l})
        v, i, sel = jax.jit(shard_map(
            body, mesh=mesh,
            in_specs=(P(None, "model"), P(None, "model"),
                      P(None, None, "model")),
            out_specs=(P(), P(), {"p": P(), "q": P()}), check_vma=False))(
                x["scores"], x["payload_p"], x["payload_q"])
        put("dtopk/v", v); put("dtopk/i", i)
        put("dtopk/p", sel["p"]); put("dtopk/q", sel["q"])

        for chunk in (8192, 13):
            put(f"knn_predict/{chunk}", jax.jit(
                lambda db, l, q: knn_predict_distributed(
                    mesh, db, l, q, k=5, chunk=chunk))(
                x["X_db"], x["lam_db"], x["X"]))
        put("knn_quant", jax.jit(
            lambda *a: knn_predict_quant_distributed(mesh, *a, k=5,
                                                     mode="int8"))(
            x["Xq_q"], x["Xq_scale"], x["Xq_y2"], x["lam_db"], x["X"]))
        try:
            knn_predict_quant_distributed(
                mesh, x["Xp_q"], x["Xp_scale"], x["Xp_y2"], x["lam_db"],
                x["X"], k=5, mode="int8")
            put("quant_pad_raises", 0)
        except ValueError as e:
            put("quant_pad_raises", int("no pad rows" in str(e)))

        for form in ("shared", "per_request"):
            for m2 in (8, int(x["big_m2_" + name])):
                a = x["a_rank"] if form == "shared" else x["a_rank_b"]
                b = x["b_rank"] if form == "shared" else x["b_rank_b"]
                g = x["g_rank"][:m2]
                if form == "per_request":
                    g = np.broadcast_to(g, (x["u_rank"].shape[0], m2)).copy()
                o = jax.jit(lambda *r: rank_distributed(mesh, *r, m2=m2))(
                    x["u_rank"], a, b, x["lam_rank"], g)
                for f in ("perm", "utility", "exposure", "compliant"):
                    put(f"rank/{form}/{m2}/{f}", getattr(o, f))

        for cell in PAPER_SMOKE_CELLS:
            for dist in (False, True):
                low = build_paper(PaperConfig(distributed=dist), cell, mesh)
                args = [x[f"paper/{cell.name}/{dist}/{j}"]
                        for j in range(len(low.args))]
                with use_mesh_rules(mesh, low.rules):
                    o = jax.jit(low.fn)(*args)
                for f in ("perm", "utility", "exposure", "compliant", "lam"):
                    if hasattr(o, f):
                        put(f"paper/{cell.name}/{dist}/{f}", getattr(o, f))

    class Clock:
        def __call__(self):
            return 0.0

    mesh = meshes["2x4"]
    knn = KNNLambdaPredictor.fit(jnp.asarray(x["X_db"]),
                                 jnp.asarray(x["lam_eng"]), k=10)
    for label, mix in (("mix", (Scenario("feed", m1=200, m2=16, K=3,
                                         weight=2.0),
                                Scenario("strip", m1=400, m2=8, K=5,
                                         weight=1.0))),
                       ("knn", (Scenario("knn_feed", m1=256, m2=16, K=5,
                                         tag="knn", d_cov=10),))):
        eng = ServingEngine(max_batch=8, max_wait_ms=1e9, executor="dist",
                            mesh=mesh, donate=False, pipeline_depth=0,
                            clock=Clock())
        eng.register_predictor("knn", knn, d_cov=10)
        res = eng.serve_stream(make_stream(mix, n_requests=32, seed=4))
        out[f"engine/{label}/cpw"] = np.asarray(
            eng.metrics.summary()["compiles_post_warmup"])
        for r in res:
            for f in ("perm", "utility", "exposure", "compliant"):
                out[f"engine/{label}/{r.rid}/{f}"] = np.asarray(getattr(r, f))
    np.savez(dst, **out)
    print("done")
""")


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _inputs():
    """Every input of the JAX subprocess, from numpy seeds."""
    from repro.core.predictors import pack_knn_db as jax_pack

    rng = np.random.default_rng(0)
    x = {"xq": _f32(rng, 8, 32), "xdb": _f32(rng, 512, 32),
         "scores": _f32(rng, 8, 256), "payload_p": _f32(rng, 8, 256),
         "payload_q": _f32(rng, 3, 8, 256),
         "X": _f32(rng, 16, 10), "X_db": _f32(rng, 128, 10),
         "lam_db": np.abs(_f32(rng, 128, 3)),
         "lam_eng": np.abs(_f32(rng, 128, 5))}
    for key, slab in (("Xq", 16), ("Xp", 48)):   # 48: a pack with pad rows
        q, s, y2 = (np.asarray(t) for t in jax_pack(x["X_db"], mode="int8",
                                                    slab=slab))
        x.update({f"{key}_q": q, f"{key}_scale": s, f"{key}_y2": y2})
    B, m1, K = 16, 64, 3
    x.update(u_rank=rng.uniform(size=(B, m1)).astype(np.float32),
             a_rank=(rng.uniform(size=(K, m1)) < 0.3).astype(np.float32),
             a_rank_b=(rng.uniform(size=(B, K, m1)) < 0.3).astype(np.float32),
             b_rank=np.full(K, 0.1, np.float32),
             b_rank_b=rng.uniform(0.0, 0.3, (B, K)).astype(np.float32),
             lam_rank=np.abs(_f32(rng, B, K)),
             g_rank=np.asarray(dcg_discount(64)))
    for name, (_, big) in RANK_M2.items():
        x[f"big_m2_{name}"] = np.asarray(big)
    for cell in PAPER_SMOKE_CELLS:
        for dist in (False, True):
            for j, a in enumerate(_paper_args(cell, dist)):
                x[f"paper/{cell.name}/{dist}/{j}"] = a
    return x


def _paper_args(cell, dist):
    """A cell's arguments from a seed: the dense and the dist-topk
    variants see the same arrays (a per-request a is the shared one
    broadcast)."""
    rng = np.random.default_rng(7)
    B, m1, K = cell["batch"], cell["m1"], cell["K"]
    u = rng.uniform(1.0, 5.0, (B, m1)).astype(np.float32)
    a = (rng.uniform(size=(K, m1)) < 0.15).astype(np.float32)
    b = np.full(K, 0.05, np.float32)
    a_b = np.broadcast_to(a, (B, K, m1)).copy()
    if cell.kind == "offline":
        return u, a_b, b
    d, n = cell["d_cov"], cell["n_db"]
    X, X_db = _f32(rng, B, d), _f32(rng, n, d)
    lam_db = np.abs(_f32(rng, n, K))
    return X, u, a if dist else a_b, b, X_db, lam_db


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's outputs on every case, from one subprocess with 8 host
    devices; plus the inputs it read."""
    x = _inputs()
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
        np.savez(src, **x)
        env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable, "-c", _PROG, src, dst],
                           capture_output=True, text=True, env=env,
                           cwd=REPO, timeout=300)
        assert r.returncode == 0, r.stdout + "\n" + r.stderr
        out = dict(np.load(dst))
    return x, out


def _mesh(name):
    return make_smoke_mesh(multi_pod=name == "2x2x2", device="cpu")


def _t(a):
    return torch.as_tensor(np.array(a))


# -- launch/mesh.py -----------------------------------------------------------

@pytest.mark.parametrize("multi_pod,shape,axes", [
    (False, (2, 4), ("data", "model")),
    (True, (2, 2, 2), ("pod", "data", "model"))])
def test_smoke_mesh_shapes_match_jax(multi_pod, shape, axes):
    mesh = make_smoke_mesh(multi_pod=multi_pod, device="cpu")
    assert mesh.axis_names == axes
    assert mesh.axis_sizes == shape and mesh.devices.size == 8
    assert mesh.shape == dict(zip(axes, shape))
    assert mesh.physical_devices == (CPU,)


def test_mesh_refuses_what_shard_map_refuses():
    mesh = _mesh("2x4")
    with pytest.raises(ValueError, match="not divisible"):
        shard_rows(mesh, torch.zeros(10, 3))           # 10 rows over 4
    with pytest.raises(ValueError, match="not divisible"):
        sharded_knn_topk(mesh, torch.zeros(3, 4), torch.zeros(8, 4), 2)
    with pytest.raises(ValueError, match="not divisible"):
        rank_distributed(mesh, torch.zeros(2, 10), torch.zeros(2, 10),
                         torch.zeros(2), torch.zeros(2, 2),
                         torch.ones(4), m2=4)
    with pytest.raises(ValueError, match="needs 8 devices"):
        make_mesh((2, 4), ("data", "model"), devices=[CPU] * 4)
    with pytest.raises(ValueError, match="axis names"):
        make_mesh((2, 4), ("data",), devices=[CPU] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="needs 256 cards"):
            make_production_mesh()
        with pytest.raises(RuntimeError, match="needs 2 cards"):
            make_mesh((2,), ("model",))


def test_shard_rows_places_once_as_views():
    """A placed db is reused as it is; on its own device each shard is
    a view of the rows, not a copy."""
    mesh = _mesh("2x4")
    x = torch.arange(24.0).reshape(8, 3)
    db = shard_rows(mesh, x)
    assert shard_rows(mesh, db) is db
    assert db.offsets == (0, 2, 4, 6) and db.shape == (8, 3)
    for i in range(4):
        piece = db.local(i, CPU)
        assert piece.data_ptr() == x[2 * i].data_ptr()
    with pytest.raises(ValueError, match="another mesh"):
        shard_rows(_mesh("2x4"), db)


# -- distributed/sharding.py ---------------------------------------------------

@pytest.mark.parametrize("family", ["lm", "recsys", "gnn", "paper"])
def test_rule_tables_match_jax(family):
    rules = sharding.RULES_BY_FAMILY[family]
    jrules = jsharding.RULES_BY_FAMILY[family]
    assert dict(rules.rules) == dict(jrules.rules)
    names = sorted(rules.rules) + ["unknown", None]
    assert rules.resolve(*names) == tuple(jrules.resolve(*names))
    over = rules.override(batch="data")
    assert dict(over.rules) == dict(jrules.override(batch="data").rules)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_filter_rules_matches_jax(multi_pod):
    mesh = make_smoke_mesh(multi_pod=multi_pod, device="cpu")

    class JaxLikeMesh:                  # filter_rules reads axis_names only
        axis_names = mesh.axis_names

    for fam, rules in sharding.RULES_BY_FAMILY.items():
        want = jsharding.filter_rules(jsharding.RULES_BY_FAMILY[fam],
                                      JaxLikeMesh())
        assert dict(sharding.filter_rules(rules, mesh).rules) == \
            dict(want.rules)
    for entry in (None, "model", ("pod", "data"), ("pod",)):
        assert sharding._filter_entry(entry, frozenset(mesh.axis_names)) == \
            jsharding._filter_entry(entry, frozenset(mesh.axis_names))


# -- distributed/topk.py -------------------------------------------------------

@pytest.mark.parametrize("name", MESHES)
def test_sharded_knn_topk_matches_jax(jax_ref, name):
    x, want = jax_ref
    d2, idx = sharded_knn_topk(_mesh(name), _t(x["xq"]), _t(x["xdb"]), 10)
    np.testing.assert_array_equal(idx.numpy(), want[f"{name}/knn_topk/idx"])
    np.testing.assert_allclose(d2.numpy(), want[f"{name}/knn_topk/d2"],
                               **D2_TOL)
    # and bitwise one knn_topk over the whole db (the same plain sweep)
    d2_one, idx_one = ops.knn_topk(_t(x["xq"]), _t(x["xdb"]), k=10,
                                   device="cpu")
    assert torch.equal(idx, idx_one) and torch.equal(d2, d2_one)


@pytest.mark.parametrize("name", MESHES)
def test_sharded_score_topk_matches_jax(jax_ref, name):
    x, want = jax_ref
    v, i = sharded_score_topk(_mesh(name), _t(x["scores"]), 5)
    np.testing.assert_array_equal(i.numpy(), want[f"{name}/score_topk/i"])
    np.testing.assert_array_equal(v.numpy(), want[f"{name}/score_topk/v"])


@pytest.mark.parametrize("name", MESHES)
def test_distributed_top_k_with_payload_matches_jax(jax_ref, name):
    """Four item shards of the whole batch (JAX's in_specs P(None,
    'model')); a (b, n) and a (3, b, n) payload ride the merge."""
    x, want = jax_ref
    S = _mesh(name).shape["model"]
    n = x["scores"].shape[1] // S
    cols = [slice(i * n, (i + 1) * n) for i in range(S)]
    v, i, sel = distributed_top_k(
        [_t(x["scores"][:, c]) for c in cols], 6,
        payload=[{"p": _t(x["payload_p"][:, c]),
                  "q": _t(x["payload_q"][..., c])} for c in cols])
    np.testing.assert_array_equal(i.numpy(), want[f"{name}/dtopk/i"])
    np.testing.assert_array_equal(v.numpy(), want[f"{name}/dtopk/v"])
    np.testing.assert_array_equal(sel["p"].numpy(), want[f"{name}/dtopk/p"])
    np.testing.assert_array_equal(sel["q"].numpy(), want[f"{name}/dtopk/q"])


# -- core/serving_dist.py ------------------------------------------------------

@pytest.mark.parametrize("chunk", [8192, 13])
@pytest.mark.parametrize("name", MESHES)
def test_knn_predict_distributed_matches_jax(jax_ref, name, chunk):
    x, want = jax_ref
    X, X_db, lam_db = _t(x["X"]), _t(x["X_db"]), _t(x["lam_db"])
    mesh = _mesh(name)
    lam = knn_predict_distributed(mesh, X_db, lam_db, X, k=5, chunk=chunk)
    np.testing.assert_allclose(lam.numpy(), want[f"{name}/knn_predict/"
                                                 f"{chunk}"], **LAM_TOL)
    # the port's dense twin with JAX's chunk, within JAX's own pair's bound
    dense = knn_predict_chunked(X_db, lam_db, X, k=5, chunk=chunk)
    np.testing.assert_allclose(lam.numpy(), dense.numpy(), **SELF_TOL)
    # the dense route the card takes: bitwise
    assert torch.equal(lam, ops.knn_lambda(X, X_db, lam_db, k=5,
                                           device="cpu"))
    # rows placed once give the same answer
    placed = shard_rows(mesh, X_db)
    assert torch.equal(knn_predict_distributed(mesh, placed, lam_db, X, k=5,
                                               chunk=chunk), lam)


@pytest.mark.parametrize("name", MESHES)
def test_knn_predict_quant_distributed_matches_jax(jax_ref, name):
    x, want = jax_ref
    pack = [_t(x[k]) for k in ("Xq_q", "Xq_scale", "Xq_y2")]
    X, lam_db = _t(x["X"]), _t(x["lam_db"])
    lam = knn_predict_quant_distributed(_mesh(name), *pack, lam_db, X, k=5,
                                        mode="int8")
    np.testing.assert_allclose(lam.numpy(), want[f"{name}/knn_quant"],
                               **LAM_TOL)
    dense = knn_predict_quant(*pack, lam_db, X, k=5, mode="int8")
    np.testing.assert_allclose(lam.numpy(), dense.numpy(), **SELF_TOL)
    assert torch.equal(lam, dense)


@pytest.mark.parametrize("name", MESHES)
def test_knn_predict_quant_distributed_refuses_pad_rows(jax_ref, name):
    x, want = jax_ref
    assert int(want[f"{name}/quant_pad_raises"]) == 1
    pack = [_t(x[k]) for k in ("Xp_q", "Xp_scale", "Xp_y2")]
    assert pack[0].shape[0] > x["lam_db"].shape[0]
    with pytest.raises(ValueError, match="no pad rows"):
        knn_predict_quant_distributed(_mesh(name), *pack, _t(x["lam_db"]),
                                      _t(x["X"]), k=5)


@pytest.mark.parametrize("m2_at", [0, 1], ids=["m2=8", "m2>m1_local"])
@pytest.mark.parametrize("form", ["shared", "per_request"])
@pytest.mark.parametrize("name", MESHES)
def test_rank_distributed_matches_jax(jax_ref, name, form, m2_at):
    x, want = jax_ref
    m2 = RANK_M2[name][m2_at]
    a = x["a_rank"] if form == "shared" else x["a_rank_b"]
    b = x["b_rank"] if form == "shared" else x["b_rank_b"]
    g = x["g_rank"][:m2]
    if form == "per_request":
        g = np.broadcast_to(g, (x["u_rank"].shape[0], m2)).copy()
    args = (_t(x["u_rank"]), _t(a), _t(b), _t(x["lam_rank"]), _t(g))
    out = rank_distributed(_mesh(name), *args, m2=m2)
    key = f"{name}/rank/{form}/{m2}"
    np.testing.assert_array_equal(out.perm.numpy(), want[f"{key}/perm"])
    np.testing.assert_array_equal(out.compliant.numpy(),
                                  want[f"{key}/compliant"])
    np.testing.assert_allclose(out.utility.numpy(), want[f"{key}/utility"],
                               **UTIL_TOL)
    np.testing.assert_allclose(out.exposure.numpy(), want[f"{key}/exposure"],
                               **EXPO_TOL)
    assert out.perm.dtype == torch.int32
    # the port's dense route on the same inputs: bitwise
    dense = ops.rank_audited(*args, m2=m2, device="cpu")
    for f in ("perm", "utility", "exposure", "compliant"):
        assert torch.equal(getattr(out, f), getattr(dense, f)), f


@pytest.mark.parametrize("name", MESHES)
def test_rank_distributed_above_the_kernel_m2_sorts(name, monkeypatch):
    """m2 = 200 > MAX_KERNEL_M2 over m1 = 512: every shard keeps its top
    min(200, m1 local) by the einsum score and a stable sort, never
    reaching the kernel wrapper, as the dense dispatcher's route is
    chosen by m2. The merge is bitwise that dense route's
    (rank_given_lambda) and its perm JAX's rank_given_lambda's."""
    import jax.numpy as jnp

    from repro.core.ranking import rank_given_lambda as jax_rank

    def refuse(*args, **kw):
        raise AssertionError("a kernel wrapper was reached")

    monkeypatch.setattr(ops, "fused_rank_cuda", refuse)
    rng = np.random.default_rng(5)
    B, m1, K, m2 = 8, 512, 4, 200
    u = rng.uniform(1.0, 5.0, (B, m1)).astype(np.float32)
    a = (rng.uniform(size=(B, K, m1)) < 0.15).astype(np.float32)
    b = rng.uniform(0.0, 1.0, (B, K)).astype(np.float32)
    lam = rng.exponential(0.5, (B, K)).astype(np.float32)
    g = np.asarray(dcg_discount(m2))
    args = [_t(v) for v in (u, a, b, lam, g)]
    out = rank_distributed(_mesh(name), *args, m2=m2)
    dense = ops.rank_audited(*args, m2=m2, device="cpu")
    for f in ("perm", "utility", "exposure", "compliant"):
        assert torch.equal(getattr(out, f), getattr(dense, f)), f
    want = jax_rank(*(jnp.asarray(v) for v in (u, a, b, lam, g)), m2=m2)
    np.testing.assert_array_equal(out.perm.numpy(), np.asarray(want.perm))
    np.testing.assert_allclose(out.utility.numpy(), np.asarray(want.utility),
                               **UTIL_TOL)


def test_dist_kernel_launches_by_route():
    """On an assumed card: KNN lambda-hat 2 (knn_lambda, or
    knn_lambda_quant over a pack), affine/MLP/given 0; fused_rank once a
    shard body for m2 <= 128 (8 on (2, 4), 8 on (2, 2, 2), 4 on (1,
    4)), none above; nothing on the CPU."""
    rng = np.random.default_rng(0)
    knn = KNNLambdaPredictor.fit(rng.normal(size=(64, 4)),
                                 np.abs(rng.normal(size=(64, 3))),
                                 device="cpu")
    q = knn.quantized("int8", slab=16, device="cpu")
    for mesh in (_mesh("2x4"), _mesh("2x2x2")):
        assert dist_kernel_launches(knn, 50, mesh=mesh) == {
            "knn_lambda": 2, "fused_rank": 8}
        assert dist_kernel_launches(q, 500, mesh=mesh) == {
            "knn_lambda_quant": 2}
        assert dist_kernel_launches(None, 128, mesh=mesh) == {
            "fused_rank": 8}
        assert dist_kernel_launches(None, 129, mesh=mesh) == {}
        assert dist_kernel_launches(knn, 50, mesh=mesh, device="cpu") == {}
    one = virtual_mesh((1, 4), ("data", "model"), "cpu")
    assert dist_kernel_launches(None, 50, mesh=one) == {"fused_rank": 4}
    with pytest.raises(TypeError, match="no predictor"):
        dist_kernel_launches(object(), 50, mesh=one)


# -- configs/paper.py ----------------------------------------------------------

def _cells(cells):
    return [(c.name, c.kind, dict(c.params)) for c in cells]


def test_paper_cells_config_and_registry_match_jax():
    assert _cells(PAPER_CELLS) == _cells(JAX_CELLS)
    assert _cells(PAPER_SMOKE_CELLS) == _cells(JAX_SMOKE_CELLS)
    for dist in (False, True):
        cfg, jcfg = PaperConfig(distributed=dist), JaxPaperConfig(
            distributed=dist)
        assert [(f.name, getattr(cfg, f.name)) for f in fields(cfg)] == \
            [(f.name, getattr(jcfg, f.name)) for f in fields(jcfg)]
    spec, jspec = get_arch("paper-ranking"), jax_get_arch("paper-ranking")
    assert spec.family == jspec.family == "paper"
    assert spec.build is build_paper and spec.notes == jspec.notes
    assert _cells(spec.cells) == _cells(jspec.cells)
    assert sorted(spec.variants) == sorted(jspec.variants) == ["dist-topk"]
    assert spec.variants["dist-topk"]() == PaperConfig(distributed=True)
    assert spec.make_config(True) == spec.make_config(False) == PaperConfig()


@pytest.mark.parametrize("dist", [False, True], ids=["dense", "dist-topk"])
@pytest.mark.parametrize("cell", [c.name for c in PAPER_SMOKE_CELLS])
@pytest.mark.parametrize("name", MESHES)
def test_build_paper_matches_jax(jax_ref, name, cell, dist):
    x, want = jax_ref
    cell = next(c for c in PAPER_SMOKE_CELLS if c.name == cell)
    prog = build_paper(PaperConfig(distributed=dist), cell, _mesh(name))
    args = [_t(x[f"paper/{cell.name}/{dist}/{j}"])
            for j in range(len(prog.args))]
    for arg, spec in zip(args, prog.args):
        assert tuple(arg.shape) == spec.shape and arg.dtype == spec.dtype
    out = _gathered(prog.fn(*args))
    key = f"{name}/paper/{cell.name}/{dist}"
    if cell.kind == "offline":
        np.testing.assert_allclose(out["lam"].numpy(), want[f"{key}/lam"],
                                   **LAM_TOL)
        np.testing.assert_allclose(out["exposure"].numpy(),
                                   want[f"{key}/exposure"], **EXPO_TOL)
        np.testing.assert_array_equal(out["compliant"].numpy(),
                                      want[f"{key}/compliant"])
        return
    np.testing.assert_array_equal(out["perm"].numpy(), want[f"{key}/perm"])
    np.testing.assert_array_equal(out["compliant"].numpy(),
                                  want[f"{key}/compliant"])
    np.testing.assert_allclose(out["utility"].numpy(),
                               want[f"{key}/utility"], **UTIL_TOL)
    np.testing.assert_allclose(out["exposure"].numpy(),
                               want[f"{key}/exposure"], **EXPO_TOL)
    np.testing.assert_allclose(out["lam"].numpy(), want[f"{key}/lam"],
                               **LAM_TOL)
    if dist:        # the two variants of the port agree on the same arrays
        dense = build_paper(PaperConfig(), cell, _mesh(name))
        dargs = list(args)
        dargs[2] = args[2].expand(cell["batch"], -1, -1).contiguous()
        want_d = _gathered(dense.fn(*dargs))
        assert torch.equal(out["perm"], want_d["perm"])
        assert torch.equal(out["compliant"], want_d["compliant"])


def _gathered(out):
    """A program's output fields as whole tensors: the partitioned
    default variant's are launch.mesh.Sharded, gathered here."""
    return {f.name: (v.gather() if isinstance(v, Sharded) else v)
            for f in fields(out)
            if isinstance(v := getattr(out, f.name), (torch.Tensor, Sharded))}


# -- the engine's dist executor ------------------------------------------------

def _port_request(r):
    return RankRequest(**{f.name: getattr(r, f.name)
                          for f in fields(JaxRequest)})


def _port_engines(x, executor, **kw):
    eng = ServingEngine(max_batch=8, max_wait_ms=1e9, pipeline_depth=0,
                        clock=FrozenClock(), executor=executor,
                        device="cpu", **kw)
    eng.register_predictor("knn", KNNLambdaPredictor.fit(
        x["X_db"], x["lam_eng"], k=10, device="cpu"), d_cov=10)
    return eng


@pytest.mark.parametrize("label", ["mix", "knn"])
def test_dist_engine_matches_jax_dist_engine(jax_ref, label):
    """JAX's mix of lambda-given surfaces, and a KNN surface, through
    the port's ServingEngine(executor='dist') on a virtual (2, 4) mesh
    and JAX's dist engine on its (2, 4) mesh, frozen clocks; the port's
    default engine on the same stream gives the same rows."""
    x, want = jax_ref
    mix = MIX if label == "mix" else KNN_MIX
    reqs = [_port_request(r) for r in make_stream(mix, n_requests=32,
                                                   seed=4)]
    eng = _port_engines(x, "dist", mesh=_mesh("2x4"))
    got = {r.rid: r for r in eng.serve_stream(reqs)}
    assert eng.metrics.summary()["compiles_post_warmup"] == 0
    assert int(want[f"engine/{label}/cpw"]) == 0
    fused = {r.rid: r for r in _port_engines(x, "fused").serve_stream(reqs)}
    assert sorted(got) == sorted(fused) == list(range(32))
    for rid, g in got.items():
        key = f"engine/{label}/{rid}"
        np.testing.assert_array_equal(g.perm, want[f"{key}/perm"])
        assert g.compliant == bool(want[f"{key}/compliant"])
        np.testing.assert_allclose(g.utility, want[f"{key}/utility"],
                                   **UTIL_TOL)
        np.testing.assert_allclose(g.exposure, want[f"{key}/exposure"],
                                   **EXPO_TOL)
        f = fused[rid]
        np.testing.assert_array_equal(g.perm, f.perm)
        assert g.compliant == f.compliant and g.utility == f.utility
        np.testing.assert_array_equal(g.exposure, f.exposure)


def test_engine_executor_errors_match_jax(monkeypatch):
    """dist without a mesh and an unknown executor are refused as JAX
    refuses them; the xla executor builds and counts 0 launches a bucket
    even where the route would launch kernels (the count made as on the
    card), where the fused executor counts the route's."""
    with pytest.raises(ValueError, match="needs a mesh"):
        ServingEngine(executor="dist", device="cpu")
    with pytest.raises(ValueError, match="unknown executor"):
        ServingEngine(executor="pallas", device="cpu")
    monkeypatch.setattr(ops, "kernel_launch_count",
                        lambda pred, m2, **kw: 2)
    reqs = [_port_request(r) for r in make_stream(MIX, n_requests=12,
                                                  seed=5)]
    for executor, want in (("xla", 0), ("fused", 2)):
        eng = ServingEngine(executor=executor, max_batch=4, device="cpu")
        eng.serve_stream(reqs)
        assert eng._launches and set(eng._launches.values()) == {want}
        assert eng.metrics.kernel_launches == want * eng.metrics.batches
        eng.close()
    elsewhere = np.empty((2, 4), dtype=object)
    elsewhere[...] = torch.device("cuda", 3)
    with pytest.raises(ValueError, match="do not hold"):
        ServingEngine(executor="dist", device="cpu",
                      mesh=Mesh(devices=elsewhere,
                                axis_names=("data", "model")))
