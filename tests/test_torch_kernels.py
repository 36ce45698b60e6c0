"""The port's kernel-library entry points (repro_torch.kernels: fused_rank,
knn_topk, knn_predict_kernel, embedding_bag and the large-m2 route)
held against the JAX XLA oracles on the CPU, the counterpart of
tests/test_kernels.py. The JAX side runs kernels.ref and the XLA routes
of kernels.ops, never the Pallas interpret path (embedding_bag_pallas
does not run on this jax).

Tolerances:
  * knn_topk: d2 rtol=1e-5, atol=1e-4 in f32 (the port sums the dot
    coordinate by coordinate, XLA in a matrix product), rtol=2e-2 on
    bf16 operands (as the JAX test states; both widen the same bf16
    values); idx exact in f32.
  * fused_rank: idx exact; vals rtol=atol=1e-5 (the port's axpy score
    against the oracle's einsum).
  * embedding_bag f32: rtol=atol=1e-5 (slot-by-slot sum against an
    einsum). A bf16 table: the port rounds its f32 sum once, the JAX
    oracle casts the weights to bf16 and sums in bf16, so the two
    differ by a few bf16 ulps: rtol=atol=5e-2.
  * knn_predict_kernel: rtol=atol=1e-4, as the JAX test holds its
    kernel path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.kernels as jax_kernels
import repro_torch.kernels as kernels
from repro.core.predictors import knn_predict as jax_knn_predict
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels.embedding_bag import (
    VECTOR_BYTES,
    BagGeometry,
    bag_geometry,
)
from repro_torch.kernels.fused_rank import fused_rank_cuda, rank_audited_cuda

CPU = "cpu"


def _t(x, dtype=torch.float32):
    return torch.tensor(np.ascontiguousarray(x)).to(dtype)


@pytest.mark.parametrize("B,N,D,k", [
    (8, 512, 128, 10),
    (3, 300, 64, 5),
    (16, 1024, 256, 16),
    (1, 512, 32, 1),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_knn_topk_matches_oracle(B, N, D, k, dtype):
    rng = np.random.default_rng(B * N + D)
    xq = rng.normal(size=(B, D)).astype(np.float32)
    xdb = rng.normal(size=(N, D)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    d2r, idxr = jax_ref.knn_topk_ref(jnp.asarray(xq, jdt),
                                     jnp.asarray(xdb, jdt), k)
    d2, idx = ops.knn_topk(_t(xq, tdt), _t(xdb, tdt), k=k, device=CPU)
    assert d2.dtype == torch.float32 and idx.dtype == torch.int32
    assert d2.shape == idx.shape == (B, k)
    bf16 = dtype == "bfloat16"
    np.testing.assert_allclose(d2.numpy(), np.asarray(d2r),
                               rtol=2e-2 if bf16 else 1e-5, atol=1e-4)
    if not bf16:
        np.testing.assert_array_equal(idx.numpy(), np.asarray(idxr))


@pytest.mark.parametrize("n,m1,K,m2", [
    (8, 512, 5, 10),
    (4, 1000, 8, 50),
    (8, 2048, 3, 128),     # MAX_KERNEL_M2: the last kernel shape
    (2, 600, 1, 1),
    (4, 512, 2, 256),      # > MAX_KERNEL_M2: the einsum + sort route
])
def test_fused_rank_matches_oracle(n, m1, K, m2):
    rng = np.random.default_rng(n * m1 + K)
    u = rng.normal(size=(n, m1)).astype(np.float32)
    a = rng.normal(size=(n, K, m1)).astype(np.float32)
    lam = np.abs(rng.normal(size=(n, K))).astype(np.float32)
    vr, ir = jax_ref.fused_rank_ref(jnp.asarray(u), jnp.asarray(a),
                                    jnp.asarray(lam), m2)
    vals, idx = ops.fused_rank(u, a, lam, m2=m2, device=CPU)
    assert idx.dtype == torch.int32 and vals.shape == (n, m2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ir))
    np.testing.assert_allclose(vals.numpy(), np.asarray(vr), rtol=1e-5,
                               atol=1e-5)
    if m2 > 128:
        _, jidx = jax_ops.fused_rank(jnp.asarray(u), jnp.asarray(a),
                                     jnp.asarray(lam), m2=m2)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))


def test_fused_rank_is_rank_audited_without_the_audit():
    """fused_rank's (vals, idx) are rank_audited's, bitwise: both kernels
    run one rank routine, and so do their plain versions."""
    rng = np.random.default_rng(5)
    u = _t(rng.uniform(1.0, 5.0, (6, 700)))
    a = _t(rng.random((6, 4, 700)) < 0.15)
    lam = _t(rng.exponential(0.5, (6, 4)))
    b = _t(rng.uniform(0.0, 1.0, (6, 4)))
    g = _t(np.broadcast_to(1.0 / np.log2(np.arange(2, 52)), (6, 50)))
    vals, idx = fused_rank_cuda(u, a, lam, m2=50, device=CPU)
    rv, ri = rank_audited_cuda(u, a, b, lam, g, m2=50, device=CPU)[:2]
    assert torch.equal(vals, rv) and torch.equal(idx, ri)


def test_rank_audited_large_m2_matches_the_xla_route():
    """m2 = 256 > MAX_KERNEL_M2: the dispatcher ranks the einsum score
    with a stable sort, as JAX's ops.rank_audited does there."""
    rng = np.random.default_rng(9)
    u = rng.uniform(1.0, 5.0, (3, 600)).astype(np.float32)
    a = (rng.random((3, 3, 600)) < 0.2).astype(np.float32)
    lam = rng.exponential(0.5, (3, 3)).astype(np.float32)
    b = rng.uniform(0.0, 2.0, (3, 3)).astype(np.float32)
    g = (1.0 / np.log2(np.arange(2, 258))).astype(np.float32)
    want = jax_ops.rank_audited(*(jnp.asarray(x) for x in (u, a, b, lam, g)),
                                m2=256)
    got = ops.rank_audited(u, a, b, lam, g, m2=256, device=CPU)
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    np.testing.assert_array_equal(got.compliant.numpy(),
                                  np.asarray(want.compliant))
    np.testing.assert_allclose(got.utility.numpy(), np.asarray(want.utility),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.exposure.numpy(),
                               np.asarray(want.exposure), rtol=1e-5,
                               atol=1e-5)


def _bag(V, D, nb, bag, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(V, D)).astype(np.float32)
    idx = rng.integers(-2, V, (nb, bag)).astype(np.int32)  # with padding
    w = rng.normal(size=(nb, bag)).astype(np.float32)
    return table, idx, w


@pytest.mark.parametrize("V,D,nb,bag", [
    (100, 32, 8, 4),
    (50, 16, 5, 10),
    (200, 128, 16, 1),
    (1000, 10, 64, 1),     # DeepFM's width, one field a bag
    (1000, 10, 16, 50),
    (500, 50, 32, 1),
    (500, 50, 8, 50),      # MIND's 50-item window
])
@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_matches_oracle(V, D, nb, bag, weighted):
    table, idx, w = _bag(V, D, nb, bag, V + D)
    w = w if weighted else None
    want = jax_ref.embedding_bag_ref(
        jnp.asarray(table), jnp.asarray(idx),
        None if w is None else jnp.asarray(w))
    got = ops.embedding_bag(table, idx, w, device=CPU)
    assert got.dtype == torch.float32 and got.shape == (nb, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_embedding_bag_bf16_table(weighted):
    """A bf16 table gives a bf16 bag: the entry point equals the plain
    version bitwise, which sums in f32 and rounds once, and lies within
    a few bf16 ulps of the JAX oracle (see the module's tolerances)."""
    table, idx, w = _bag(300, 64, 16, 10, 11)
    w = w if weighted else None
    tb = _t(table, torch.bfloat16)
    tw = None if w is None else _t(w)
    got = ops.embedding_bag(tb, idx, w, device=CPU)
    assert got.dtype == torch.bfloat16 and got.shape == (16, 64)
    assert torch.equal(got, ref.embedding_bag_ref(tb, _t(idx, torch.int32),
                                                  tw))
    want = jax_ref.embedding_bag_ref(
        jnp.asarray(table, jnp.bfloat16), jnp.asarray(idx),
        None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)


def test_a_padded_slot_adds_nothing():
    """The known hazard: where the JAX oracle adds 0 * table[0] for a
    padded slot, the port adds nothing. The two differ only when
    table[0] holds an inf or a NaN."""
    table, idx, _ = _bag(20, 8, 4, 5, 3)
    idx[:, 0] = -1
    idx[idx == 0] = 1
    got = ops.embedding_bag(table, idx, device=CPU)
    want = jax_ref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    table[0] = np.inf
    got = ops.embedding_bag(table, idx, device=CPU)
    want = jax_ref.embedding_bag_ref(jnp.asarray(table), jnp.asarray(idx))
    assert np.isfinite(got.numpy()).all()
    assert np.isnan(np.asarray(want)).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_an_index_past_the_table_clamps_as_the_oracle(dtype):
    """An index >= V reads row V - 1, as the JAX oracle's gather clamps
    it, beside valid and padded slots (tolerances as the module's other
    bag tests)."""
    V = 40
    table, idx, w = _bag(V, 24, 6, 8, 21)
    idx[:, :3] = [V, V + 5, 2**31 - 1]
    idx[0, 3] = -1
    idx[1] = [2**31 - 1] * 7 + [-3]
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_ref.embedding_bag_ref(jnp.asarray(table, jdt),
                                     jnp.asarray(idx), jnp.asarray(w))
    got = ops.embedding_bag(_t(table, tdt), idx, w, device=CPU)
    tol = 5e-2 if dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    clamped = np.minimum(idx, V - 1)
    assert torch.equal(got, ops.embedding_bag(_t(table, tdt), clamped, w,
                                              device=CPU))


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("D", [1, 10, 16, 50, 64, 100, 128, 256, 1000])
def test_bag_geometry_covers_every_column_once(D, itemsize):
    """The card's plan for every row width, item size and pointer
    alignment: the vector divides the row's bytes and the alignment and
    holds at least one item, a warp's lane groups fit its 32 lanes, and
    the passes' vectors cover each column exactly once."""
    row = D * itemsize
    for align in (4, 8, 16):
        for bag in (1, 32, 50):
            geo = bag_geometry(D, itemsize, align, bag)
            assert geo.vec in VECTOR_BYTES and geo.vec >= itemsize
            assert row % geo.vec == 0 and align % geo.vec == 0
            assert 1 <= geo.lanes <= 32 and geo.groups * geo.lanes <= 32
            assert geo.groups == 32 // geo.lanes and geo.rounds >= 1
            per = geo.vec // itemsize
            seen = np.zeros(D, int)
            for p in range(geo.passes):
                for lane in range(geo.lanes):
                    v = p * geo.lanes + lane
                    if v * geo.vec < row:
                        seen[v * per:(v + 1) * per] += 1
            assert (seen == 1).all()
            # the widest vector both divide: none wider would do
            wider = [v for v in VECTOR_BYTES if v > geo.vec
                     and row % v == 0 and align % v == 0]
            assert not wider


def test_bag_geometry_at_the_measured_shapes():
    """kernel_bench's and MIND's D = 64 and DeepFM's D = 10: 16-byte
    vectors, two f32 (four bf16) bags a warp at D = 64; 8 bytes, 5 lanes
    a row and 6 bags a warp at D = 10 in f32, each group taking five
    one-slot bags in turn; a row slice of the D = 10 table (pointer 40
    bytes past an aligned one) keeps its plan."""
    assert bag_geometry(64, 4, 16, 32) == BagGeometry(16, 16, 2, 1, 1)
    assert bag_geometry(64, 2, 16, 50) == BagGeometry(16, 8, 4, 1, 1)
    assert bag_geometry(10, 4, 16, 1) == BagGeometry(8, 5, 6, 5, 1)
    assert bag_geometry(10, 4, 8, 1) == BagGeometry(8, 5, 6, 5, 1)
    assert bag_geometry(10, 2, 4, 1) == BagGeometry(4, 5, 6, 5, 1)
    assert bag_geometry(1000, 4, 16, 2) == BagGeometry(16, 32, 1, 16, 8)
    assert bag_geometry(64, 4, 4, 32) == BagGeometry(4, 32, 1, 1, 2)


def test_embedding_bag_refuses_a_table_without_rows():
    idx = np.zeros((2, 3), np.int32)
    with pytest.raises(ValueError, match="no rows"):
        ops.embedding_bag(np.zeros((0, 4), np.float32), idx, device=CPU)
    out = ops.embedding_bag(np.zeros((0, 4), np.float32),
                            np.zeros((2, 0), np.int32), device=CPU)
    assert out.shape == (2, 4) and not out.any()


@pytest.mark.parametrize("one_row", [False, True])
def test_knn_predict_kernel_matches_reference_predictor(one_row):
    rng = np.random.default_rng(42)
    X_db = rng.normal(size=(256, 16)).astype(np.float32)
    lam_db = np.abs(rng.normal(size=(256, 4))).astype(np.float32)
    X = rng.normal(size=(8, 16)).astype(np.float32)
    X[2] = X_db[17]                          # an exact match
    X = X[2] if one_row else X
    want = np.asarray(jax_knn_predict(jnp.asarray(X_db), jnp.asarray(lam_db),
                                      jnp.asarray(X), k=10))
    got = ops.knn_predict_kernel(X_db, lam_db, X, k=10, device=CPU)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_exports_match_the_jax_kernel_package():
    """repro_torch.kernels exports the entry points repro.kernels does,
    and besides them the stateful seam, which the JAX package keeps in
    repro.kernels.ops."""
    jax_names = {n for n in dir(jax_kernels) if not n.startswith("_")
                 and callable(getattr(jax_kernels, n))}
    seam = "predict_rank_audited_stateful"
    assert seam not in jax_names and callable(getattr(jax_ops, seam))
    assert set(kernels.__all__) == jax_names | {"ref", seam}
    for name in jax_names | {seam}:
        assert getattr(kernels, name) is getattr(ops, name)
