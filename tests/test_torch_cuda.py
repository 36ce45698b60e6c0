"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked `cuda`: they skip without one. This file imports no JAX,
so it runs on a machine that has only PyTorch (`--noconftest` skips
tests/conftest.py, which imports JAX):

  PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The kernels and the plain versions round every operation in the same
order, so every output must match bitwise.
"""

import threading

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.store import flatten_with_paths
from repro_torch.core import ranking
from repro_torch.core.predictors import (
    KNNLambdaPredictor,
    MLPLambdaPredictor,
    pack_knn_db,
)
from repro_torch.data.synthetic import build_experiment
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.embedding_bag import embedding_bag_cuda
from repro_torch.kernels.fused_rank import (
    fused_rank_cuda,
    linear_rank_audited_cuda,
    rank_audited_cuda,
)
from repro_torch.kernels.knn_topk import (
    knn_lambda_cuda,
    knn_lambda_quant_cuda,
    knn_rank_audited_cuda,
    knn_rank_audited_quant_cuda,
    knn_topk_cuda,
)
from repro_torch.optim import adam_init, adam_update, clip_by_global_norm
from repro_torch.data.synthetic import DriftSpec
from repro_torch.serving import (
    RefreshLane,
    Scenario,
    ServingEngine,
    make_drift_stream,
    make_stream,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _rank(rng, n, m1, K, m2, dev):
    u = rng.uniform(1.0, 5.0, (n, m1))
    a = rng.random((n, K, m1)) < 0.15
    lam = rng.exponential(0.5, (n, K))
    b = rng.uniform(0.0, 2.0, (n, K))
    g = np.broadcast_to(1.0 / np.log2(np.arange(2, m2 + 2)), (n, m2))
    return [torch.tensor(np.ascontiguousarray(x), dtype=torch.float32,
                         device=dev) for x in (u, a, b, lam, g)]


@pytest.mark.parametrize("n,m1,K,m2", [(32, 1024, 8, 64), (5, 700, 5, 50),
                                       (16, 5000, 8, 128), (3, 64, 1, 1)])
def test_rank_audited_kernel_equals_plain(card, n, m1, K, m2):
    t = _rank(np.random.default_rng(m1), n, m1, K, m2, card)
    got = rank_audited_cuda(*t, m2=m2)
    for g, w in zip(got, ref.rank_audited_ref(*t, m2)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n_db,K_pred", [(5001, 5), (600, 8)])
def test_knn_rank_audited_kernel_equals_plain(card, n_db, K_pred):
    rng = np.random.default_rng(n_db)
    u, a, b, _, g = _rank(rng, 32, 1024, 8, 64, card)
    X_db = torch.tensor(rng.normal(size=(n_db, 20)), dtype=torch.float32,
                        device=card)
    lam_db = torch.tensor(np.abs(rng.normal(size=(n_db, K_pred))),
                          dtype=torch.float32, device=card)
    X = torch.tensor(rng.normal(size=(32, 20)), dtype=torch.float32,
                     device=card)
    X[3] = X_db[n_db - 1]                        # an exact match
    args = (X, X_db, lam_db, u, a, b, g)
    got = knn_rank_audited_cuda(*args, k=10, m2=64)
    for gt, w in zip(got, ref.knn_rank_audited_ref(*args, k=10, m2=64)):
        assert torch.equal(gt, w)
    assert torch.equal(got[5][3, :K_pred], lam_db[n_db - 1])


def _t(x, dev):
    return torch.tensor(np.ascontiguousarray(x), dtype=torch.float32,
                        device=dev)


@pytest.mark.parametrize("n,m1,K,m2,d,relu", [
    (32, 1024, 8, 64, 20, True), (32, 1024, 8, 64, 20, False),
    (5, 700, 5, 50, 1, True), (16, 5000, 8, 128, 10, False),
    (3, 64, 1, 1, 300, True)])
def test_linear_rank_audited_kernel_equals_plain(card, n, m1, K, m2, d,
                                                 relu):
    rng = np.random.default_rng(m1 + d)
    u, a, b, _, g = _rank(rng, n, m1, K, m2, card)
    X = _t(rng.normal(size=(n, d)), card)
    X[n - 1] = 0.0                               # a phantom row
    W = _t(rng.normal(size=(K, d)) * 0.3, card)
    c = _t(rng.normal(size=(K,)) * 0.5, card)
    args = (u, a, b, X, W, c, g)
    got = linear_rank_audited_cuda(*args, m2=m2, relu=relu)
    for gt, w in zip(got, ref.linear_rank_audited_ref(*args, m2,
                                                      relu=relu)):
        assert torch.equal(gt, w)
    assert (got[5] < 0).any() != relu


@pytest.mark.parametrize("n_db,K_pred,B", [(5001, 5, 32), (600, 8, 7),
                                           (70000, 5, 40)])
def test_knn_lambda_kernel_equals_plain_and_the_fused_kernel(card, n_db,
                                                             K_pred, B):
    rng = np.random.default_rng(n_db)
    X_db = _t(rng.normal(size=(n_db, 20)), card)
    lam_db = _t(np.abs(rng.normal(size=(n_db, K_pred))), card)
    X = _t(rng.normal(size=(B, 20)), card)
    X[3] = X_db[n_db - 1]                        # an exact match
    got = knn_lambda_cuda(X, X_db, lam_db, k=10)
    assert torch.equal(got, ref.knn_lambda_ref(X, X_db, lam_db, 10))
    assert torch.equal(got[3], lam_db[n_db - 1])
    u, a, b, _, g = _rank(rng, B, 1024, 8, 64, card)
    fused = knn_rank_audited_cuda(X, X_db, lam_db, u, a, b, g, k=10, m2=64)
    assert torch.equal(fused[5][:, :K_pred], got)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("n_db,d,k,slab", [(5001, 20, 10, 512),
                                           (600, 13, 5, 200),
                                           (3000, 20, 16, 128)])
def test_quant_kernels_equal_plain(card, mode, n_db, d, k, slab):
    """Both quantized kernels against their plain versions: a ragged
    pack (slab not dividing n_db), d = 13 (rows not whole words) and
    k = 16 (24 survivors, past 48 KB of shared memory)."""
    rng = np.random.default_rng(n_db + d)
    X_db = _t(rng.normal(size=(n_db, d)), card)
    lam_db = _t(np.abs(rng.normal(size=(n_db, 5))), card)
    X = _t(rng.normal(size=(32, d)), card)
    pack = pack_knn_db(X_db, mode=mode, slab=slab)
    u, a, b, _, g = _rank(rng, 32, 1024, 8, 64, card)
    got = knn_rank_audited_quant_cuda(X, *pack, lam_db, u, a, b, g, k=k,
                                      mode=mode, m2=64)
    want = ref.knn_rank_audited_quant_ref(X, *pack, lam_db, u, a, b, g,
                                          k=k, mode=mode, m2=64)
    for gt, w in zip(got, want):
        assert torch.equal(gt, w)
    lam, guard = knn_lambda_quant_cuda(X, *pack, lam_db, k=k, mode=mode)
    want_lam, want_guard = ref.knn_lambda_quant_ref(X, *pack, lam_db, k,
                                                    mode=mode)
    assert torch.equal(lam, want_lam) and torch.equal(guard, want_guard)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quant_chain_lambda_is_the_fused_kernels(card, mode):
    rng = np.random.default_rng(7)
    X_db = _t(rng.normal(size=(70000, 20)), card)
    lam_db = _t(np.abs(rng.normal(size=(70000, 5))), card)
    X = _t(rng.normal(size=(40, 20)), card)
    pack = pack_knn_db(X_db, mode=mode)
    u, a, b, _, g = _rank(rng, 40, 1024, 8, 64, card)
    fused = knn_rank_audited_quant_cuda(X, *pack, lam_db, u, a, b, g, k=10,
                                        mode=mode, m2=64)
    lam, guard = knn_lambda_quant_cuda(X, *pack, lam_db, k=10, mode=mode)
    assert torch.equal(fused[5][:, :5], lam)
    assert torch.equal(fused[6], guard)


def test_int8_lossless_pack_equals_the_f32_kernel(card):
    """On the 0.5 grid with 63.5 in every slab the int8 pack holds the db
    bitwise: knn_rank_audited_quant's outputs equal knn_rank_audited's."""
    rng = np.random.default_rng(3)
    X_db = np.round(rng.uniform(-63.0, 63.0, (5000, 20)) * 2.0) / 2.0
    X_db[::512] = 63.5
    X_db = _t(X_db, card)
    lam_db = _t(np.abs(rng.normal(size=(5000, 5))), card)
    X = _t(np.round(rng.uniform(-10, 10, (32, 20)) * 2.0) / 2.0, card)
    X[4] = X_db[4999]
    u, a, b, _, g = _rank(rng, 32, 1024, 8, 64, card)
    pack = pack_knn_db(X_db, mode="int8")
    got = knn_rank_audited_quant_cuda(X, *pack, lam_db, u, a, b, g, k=10,
                                      mode="int8", m2=64)
    want = knn_rank_audited_cuda(X, X_db, lam_db, u, a, b, g, k=10, m2=64)
    for gt, w in zip(got[:6], want):
        assert torch.equal(gt, w)
    assert torch.equal(got[5][4, :5], lam_db[4999])


@pytest.mark.parametrize("n,m1,K,m2", [(32, 1024, 8, 64), (5, 700, 5, 50),
                                       (16, 5000, 8, 128), (3, 64, 1, 1),
                                       (4, 100_000, 5, 50)])
def test_fused_rank_kernel_equals_plain_and_rank_audited(card, n, m1, K,
                                                          m2):
    u, a, b, lam, g = _rank(np.random.default_rng(m1 + 1), n, m1, K, m2,
                            card)
    vals, idx = fused_rank_cuda(u, a, lam, m2=m2)
    want = ref.fused_rank_ref(u, a, lam, m2)
    assert torch.equal(vals, want[0]) and torch.equal(idx, want[1])
    audited = rank_audited_cuda(u, a, b, lam, g, m2=m2)
    assert torch.equal(vals, audited[0]) and torch.equal(idx, audited[1])


@pytest.mark.parametrize("n_db,d,k,B", [(5001, 20, 10, 32), (600, 13, 5, 7),
                                        (70_000, 256, 16, 40),
                                        (4096, 128, 16, 33)])
def test_knn_topk_kernel_equals_plain(card, n_db, d, k, B):
    """d = 256 with k = 16 passes 48 KB of shared memory in the sweep;
    the selection is the one knn_lambda weights."""
    rng = np.random.default_rng(n_db + d)
    X_db = _t(rng.normal(size=(n_db, d)), card)
    X = _t(rng.normal(size=(B, d)), card)
    X[1] = X_db[n_db - 1]                        # an exact match
    d2, idx = knn_topk_cuda(X, X_db, k=k)
    want = ref.knn_topk_ref(X, X_db, k)
    assert torch.equal(d2, want[0]) and torch.equal(idx, want[1])
    assert int(idx[1, 0]) == n_db - 1
    lam_db = _t(np.abs(rng.normal(size=(n_db, 5))), card)
    lam = knn_lambda_cuda(X, X_db, lam_db, k=k)
    assert torch.equal(lam, ref.knn_lambda_ref(X, X_db, lam_db, k))


def test_knn_topk_widens_bf16_operands(card):
    rng = np.random.default_rng(2)
    X_db = _t(rng.normal(size=(3000, 20)), card).to(torch.bfloat16)
    X = _t(rng.normal(size=(32, 20)), card).to(torch.bfloat16)
    got = knn_topk_cuda(X, X_db, k=10)
    want = knn_topk_cuda(X.float(), X_db.float(), k=10)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("V,D,nb,bag,weighted,view", [
    (100_000, 64, 4096, 32, True, None), (50, 13, 5, 10, False, None),
    (200, 200, 16, 1, True, None), (1000, 64, 3, 0, True, None),
    (1000, 10, 257, 1, False, None), (1000, 10, 64, 50, True, "rows"),
    (1000, 50, 64, 50, True, None), (1000, 50, 19, 1, True, None),
    (1000, 64, 64, 50, False, "rows"), (1000, 64, 33, 7, True, "flat"),
    (300, 256, 40, 3, True, None), (300, 1000, 9, 5, True, None)])
def test_embedding_bag_kernel_equals_plain(card, dtype, V, D, nb, bag,
                                           weighted, view):
    """Bitwise at every plan of bag_geometry's: D = 10 (8-byte vectors
    in f32, 6 bags a warp), 50, 64 (16-byte), 256 and 1000 (column
    passes); empty, one-slot and 50-slot bags; an all-padded bag, a bag
    that names one row many times and indices >= V (the last row). A
    row slice big[1:] keeps its plan; a table one item past an aligned
    pointer ("flat") takes 4-byte (f32) or 2-byte (bf16) vectors."""
    rng = np.random.default_rng(V + D)
    big = _t(rng.normal(size=(V + 1, D)), card).to(dtype)
    if view == "rows":
        table = big[1:]
    elif view == "flat":
        table = big.view(-1)[1:1 + V * D].view(V, D)
    else:
        table = big[:V].contiguous()
    idx = rng.integers(-V // 10 - 1, V, (nb, bag))
    if bag:
        idx[0] = -1                              # all padded
        idx[1] = rng.integers(0, V)              # one row, many times
        idx[2, :3] = [V, V + 7, 2**31 - 1][:bag]  # past the table
    idx = torch.tensor(idx, dtype=torch.int32, device=card)
    w = _t(rng.normal(size=(nb, bag)), card) if weighted else None
    before = embedding_bag_cuda.launches
    got = embedding_bag_cuda(table, idx, w)
    want = ref.embedding_bag_ref(table, idx, w)
    assert got.dtype == dtype and torch.equal(got, want)
    assert embedding_bag_cuda.launches == before + 1


def test_large_m2_takes_the_sort_route_on_the_card(card):
    """m2 = 256 > MAX_KERNEL_M2: ops.fused_rank and ops.rank_audited
    answer on the card with torch ops (rank_given_lambda's body) and
    launch nothing."""
    u, a, b, lam, g = _rank(np.random.default_rng(8), 4, 600, 3, 256, card)
    before = (fused_rank_cuda.launches, rank_audited_cuda.launches)
    vals, idx = ops.fused_rank(u, a, lam, m2=256)
    out = ops.rank_audited(u, a, b, lam, g, m2=256)
    want = ranking.rank_given_lambda(u, a, b, lam, g, m2=256)
    assert (fused_rank_cuda.launches, rank_audited_cuda.launches) == before
    assert idx.device == card and torch.equal(idx, want.perm)
    assert torch.equal(out.perm, want.perm)
    assert torch.equal(out.compliant, want.compliant)
    assert ops.kernel_launch_count(None, 256) == 0


def test_knn_predict_kernel_agrees_with_the_knn_lambda_kernel(card):
    rng = np.random.default_rng(4)
    X_db = _t(rng.normal(size=(20_000, 20)), card)
    lam_db = _t(np.abs(rng.normal(size=(20_000, 5))), card)
    X = _t(rng.normal(size=(32, 20)), card)
    got = ops.knn_predict_kernel(X_db, lam_db, X, k=10)
    want = knn_lambda_cuda(X, X_db, lam_db, k=10)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)
    one = ops.knn_predict_kernel(X_db, lam_db, X[0], k=10)
    assert one.shape == (5,) and torch.allclose(one, want[0], rtol=1e-5,
                                                atol=1e-6)


def _rank_all(t, m2, dev, X_db=None, lam_db=None):
    """Every rank kernel on the rank inputs t = (u, a, b, lam, g), each
    with its plain version: fused_rank, rank_audited, linear_rank_audited
    and, over a 5-wide KNN predictor, knn_rank_audited and the int8
    knn_rank_audited_quant."""
    u, a, b, lam, g = t
    n, K = lam.shape
    rng = np.random.default_rng(K)
    vals, idx = fused_rank_cuda(u, a, lam, m2=m2)
    want = ref.fused_rank_ref(u, a, lam, m2)
    assert torch.equal(vals, want[0]) and torch.equal(idx, want[1])
    got = rank_audited_cuda(*t, m2=m2)
    for gt, w in zip(got, ref.rank_audited_ref(*t, m2)):
        assert torch.equal(gt, w)
    X = _t(rng.normal(size=(n, 20)), dev)
    W = _t(rng.normal(size=(K, 20)) * 0.3, dev)
    c = _t(rng.normal(size=(K,)) * 0.5, dev)
    args = (u, a, b, X, W, c, g)
    for gt, w in zip(linear_rank_audited_cuda(*args, m2=m2),
                     ref.linear_rank_audited_ref(*args, m2)):
        assert torch.equal(gt, w)
    if X_db is None:
        X_db = _t(rng.normal(size=(3000, 20)), dev)
        lam_db = _t(np.abs(rng.normal(size=(3000, 5))), dev)
    knn = (X, X_db, lam_db, u, a, b, g)
    for gt, w in zip(knn_rank_audited_cuda(*knn, k=10, m2=m2),
                     ref.knn_rank_audited_ref(*knn, k=10, m2=m2)):
        assert torch.equal(gt, w)
    pack = pack_knn_db(X_db, mode="int8")
    qargs = (X, *pack, lam_db, u, a, b, g)
    for gt, w in zip(
            knn_rank_audited_quant_cuda(*qargs, k=10, mode="int8", m2=m2),
            ref.knn_rank_audited_quant_ref(*qargs, k=10, mode="int8", m2=m2)):
        assert torch.equal(gt, w)


@pytest.mark.parametrize("K", [33, 64, 100])
def test_rank_kernels_take_wide_K(card, K):
    """K past the old 32 (64 is the engine's next tier): coef lives in
    dynamic shared memory and the prologue and audit stride over K."""
    t = _rank(np.random.default_rng(K), 6, 3000, K, 50, card)
    t[3] *= 0.1
    _rank_all(t, 50, card)


@pytest.mark.parametrize("n,m1,m2", [(4, 100_000, 50), (2, 1_048_576, 64),
                                     (3, 5000, 128)])
def test_split_rows_equal_plain(card, n, m1, m2):
    """A small batch splits each row over a cluster of blocks (8 at
    4 x 100,000): the merged top-m2 and the audit stay bitwise."""
    from repro_torch.kernels.fused_rank import rank_split
    assert rank_split(n, m1, card) > 1
    _rank_all(_rank(np.random.default_rng(m1), n, m1, 5, m2, card), m2,
              card)


@pytest.mark.parametrize("rows", ["rising", "ties", "falling"])
def test_filter_worst_cases_equal_plain(card, rows):
    """Scores rising with the index (every candidate passes the filter),
    a row of exact ties (ties to the lowest index) and falling scores,
    on one block (n = 300) and on a split row (n = 2)."""
    for n in (300, 2):
        m1, K, m2 = 20_000, 3, 64
        base = torch.arange(m1, dtype=torch.float32, device=card) / m1
        u = {"rising": base, "ties": torch.ones_like(base),
             "falling": 1.0 - base}[rows].expand(n, m1).contiguous()
        a = torch.zeros((n, K, m1), device=card)
        lam = torch.ones((n, K), device=card)
        b = torch.zeros((n, K), device=card)
        g = torch.ones((n, m2), device=card)
        t = [u, a, b, lam, g]
        for gt, w in zip(rank_audited_cuda(*t, m2=m2),
                         ref.rank_audited_ref(*t, m2)):
            assert torch.equal(gt, w)
        want = {"rising": torch.arange(m1 - 1, m1 - 1 - m2, -1),
                "ties": torch.arange(m2),
                "falling": torch.arange(m2)}[rows]
        assert torch.equal(fused_rank_cuda(u, a, lam, m2=m2)[1][0].cpu(),
                           want.to(torch.int32))


@pytest.mark.parametrize("route", ["knn", "knn_int8", "linear", "mean"])
def test_large_m2_routes_on_the_card(card, route):
    """m2 = 500: lambda-hat from knn_lambda or knn_lambda_quant (two
    launches) or as torch ops, then the sort route; the launches match
    kernel_launch_count, lambda-hat is bitwise its plain version and the
    ranking is rank_given_lambda's on it."""
    from repro_torch.core.predictors import (
        KNNLambdaPredictor,
        LinearLambdaPredictor,
        MeanLambdaPredictor,
    )
    rng = np.random.default_rng(500)
    n, m1, K, m2 = 8, 1024, 8, 500
    u, a, b, _, g = _rank(rng, n, m1, K, m2, card)
    X_db = _t(rng.normal(size=(5000, 20)), card)
    lam_db = _t(np.abs(rng.normal(size=(5000, 5))), card)
    X = _t(rng.normal(size=(n, 20)), card)
    knn = KNNLambdaPredictor(X_db=X_db, lam_db=lam_db, k=10)
    if route == "knn":
        p, lam = knn, ref.knn_lambda_ref(X, X_db, lam_db, 10)
    elif route == "knn_int8":
        p = knn.quantized("int8", device=card)
        lam = ref.knn_lambda_quant_ref(X, p.X_q, p.q_scale, p.y2_q, lam_db,
                                       10)[0]
    else:
        cls = LinearLambdaPredictor if route == "linear" else \
            MeanLambdaPredictor
        p = cls.fit(X_db, lam_db, device=card)
        W, c, relu = ref.affine_params(p, 20, K)
        lam = ref.affine_lambda_ref(X, W, c, relu)
    lam = torch.nn.functional.pad(lam, (0, K - lam.shape[1]))
    counters = (knn_lambda_cuda, knn_lambda_quant_cuda, rank_audited_cuda,
                linear_rank_audited_cuda, knn_rank_audited_cuda,
                knn_rank_audited_quant_cuda)
    before = sum(w.launches for w in counters)
    got = ops.predict_rank_audited(X, p, u, a, b, g, m2=m2)
    torch.cuda.synchronize()
    launched = sum(w.launches for w in counters) - before
    assert launched == ops.kernel_launch_count(p, m2) == (
        2 if route.startswith("knn") else 0)
    want = ranking.rank_given_lambda(u, a, b, lam, g, m2=m2)
    for f in ("perm", "utility", "exposure", "compliant", "lam"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_knn_shape_limits_raise_on_the_card(card):
    """Just past the sweeps' limits: k = 257 or d = 1630 (at k = 10) over
    the f32 db, k + k_extra = 257 or a d whose tiles leave no 32 rows
    over a pack (int8 d = 2256, bf16 d = 848). Each names the ROADMAP
    item that would lift it; one step inside, each is served."""
    rng = np.random.default_rng(9)
    for k, d, inside in ((257, 20, (256, 20)), (10, 1630, (10, 1629))):
        X_db = _t(rng.normal(size=(600, d)), card)
        X = _t(rng.normal(size=(4, d)), card)
        with pytest.raises(ValueError, match="Queue 2 item 7"):
            knn_topk_cuda(X, X_db, k=k)
        X_db = X_db[:, :inside[1]].contiguous()
        X = X[:, :inside[1]].contiguous()
        got = knn_topk_cuda(X, X_db, k=inside[0])
        want = ref.knn_topk_ref(X, X_db, inside[0])
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for mode, d, k, k_extra in (("int8", 20, 10, 247), ("int8", 2256, 10, 8),
                                ("bf16", 848, 10, 8)):
        X_db = _t(rng.normal(size=(600, d)), card)
        pack = pack_knn_db(X_db, mode=mode)
        lam_db = _t(np.abs(rng.normal(size=(600, 5))), card)
        X = _t(rng.normal(size=(4, d)), card)
        with pytest.raises(ValueError, match="Queue 2 item 7"):
            knn_lambda_quant_cuda(X, *pack, lam_db, k=k, k_extra=k_extra,
                                  mode=mode)
        inside = (k, k_extra - 1) if k_extra > 8 else (k, k_extra)
        if d != 20:
            X_db, X = X_db[:, :d - 4].contiguous(), X[:, :d - 4].contiguous()
            pack = pack_knn_db(X_db, mode=mode)
        got = knn_lambda_quant_cuda(X, *pack, lam_db, k=inside[0],
                                    k_extra=inside[1], mode=mode)
        want = ref.knn_lambda_quant_ref(X, *pack, lam_db, inside[0],
                                        k_extra=inside[1], mode=mode)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _quant_both(X, pack, lam_db, card, k, mode, k_extra=8):
    """Both quantized kernels against their plain versions, bitwise, and
    the chain kernel's lambda-hat and guard the fused kernel's."""
    n = X.shape[0]
    u, a, b, _, g = _rank(np.random.default_rng(n), n, 1024, 8, 64, card)
    got = knn_rank_audited_quant_cuda(X, *pack, lam_db, u, a, b, g, k=k,
                                      k_extra=k_extra, mode=mode, m2=64)
    want = ref.knn_rank_audited_quant_ref(X, *pack, lam_db, u, a, b, g, k=k,
                                          k_extra=k_extra, mode=mode, m2=64)
    for gt, w in zip(got, want):
        assert torch.equal(gt, w)
    lam, guard = knn_lambda_quant_cuda(X, *pack, lam_db, k=k,
                                       k_extra=k_extra, mode=mode)
    want_lam, want_guard = ref.knn_lambda_quant_ref(X, *pack, lam_db, k,
                                                    k_extra=k_extra,
                                                    mode=mode)
    assert torch.equal(lam, want_lam) and torch.equal(guard, want_guard)
    assert torch.equal(got[5][:, :lam.shape[1]], lam)
    assert torch.equal(got[6], guard)
    return got


def _ordered_db(ordering, n_db, d, rng, X):
    """db rows ordered against the queries X (all near the origin)."""
    ray = rng.normal(size=d)
    ray /= np.linalg.norm(ray)
    t = np.linspace(0.5, 8.0, n_db)
    if ordering == "rising":
        return t[:, None] * ray
    if ordering == "falling":
        return t[::-1, None] * ray
    if ordering == "identical":
        return np.broadcast_to(ray, (n_db, d))
    # "planted": copies of query 0 every 2999 rows (many chunks and many
    # stage folds apart) amid random rows, exact ties at the top
    db = rng.normal(size=(n_db, d)) * 3.0
    db[::2999] = X[0]
    return db


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("ordering", ["rising", "falling", "identical",
                                      "planted"])
def test_quant_kernels_on_hard_orderings(card, mode, ordering):
    """Orderings that stress a filtered selection: every row passing the
    filter (rising distance), none after the first (falling), all rows
    tied (the lowest indices win) and exact ties planted across chunks
    and stage folds; n_db = 70,000 spans 35 chunks."""
    rng = np.random.default_rng(17)
    d, n_db = 20, 70_000
    X = rng.normal(size=(40, d)) * 1e-3
    X_db = _t(_ordered_db(ordering, n_db, d, rng, X), card)
    lam_db = _t(np.abs(rng.normal(size=(n_db, 5))), card)
    _quant_both(_t(X, card), pack_knn_db(X_db, mode=mode), lam_db, card,
                10, mode)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("n_db,slab,k,k_extra", [(300, 128, 10, 8),
                                                  (60, 64, 56, 8)])
def test_quant_kernels_on_small_packs(card, mode, n_db, slab, k, k_extra):
    """A pack smaller than one chunk, and k + k_extra = n_pad (every row
    of the pack, padding included, survives)."""
    rng = np.random.default_rng(n_db)
    X_db = _t(rng.normal(size=(n_db, 20)), card)
    lam_db = _t(np.abs(rng.normal(size=(n_db, 5))), card)
    pack = pack_knn_db(X_db, mode=mode, slab=slab)
    assert pack[0].shape[0] in (384, k + k_extra)
    _quant_both(_t(rng.normal(size=(33, 20)), card), pack, lam_db, card, k,
                mode, k_extra)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
@pytest.mark.parametrize("k,d,slab", [(20, 20, 512), (33, 20, 512),
                                      (64, 20, 512), (10, 300, 512),
                                      (10, 512, 512), (20, 13, 200)])
def test_quant_kernels_at_the_new_limits(card, mode, k, d, slab):
    """k = 20, 33 and 64 (28, 41 and 72 survivors: lists of 32, 64 and
    128), d = 300 and 512 (past the old 128), d = 13 (rows not whole
    words) with a ragged slab of 200."""
    rng = np.random.default_rng(k * 1000 + d)
    n_db = 9001
    X_db = _t(rng.normal(size=(n_db, d)), card)
    lam_db = _t(np.abs(rng.normal(size=(n_db, 5))), card)
    X = _t(rng.normal(size=(37, d)), card)
    X[2] = X_db[n_db - 1]                        # an exact match
    _quant_both(X, pack_knn_db(X_db, mode=mode, slab=slab), lam_db, card, k,
                mode)


def _f32_all(X, X_db, lam_db, card, k):
    """The three f32 KNN kernels against their plain versions, bitwise,
    and knn_lambda's lambda-hat knn_rank_audited's."""
    got = knn_topk_cuda(X, X_db, k=k)
    want = ref.knn_topk_ref(X, X_db, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    lam = knn_lambda_cuda(X, X_db, lam_db, k=k)
    assert torch.equal(lam, ref.knn_lambda_ref(X, X_db, lam_db, k))
    u, a, b, _, g = _rank(np.random.default_rng(k), X.shape[0], 1024, 8, 64,
                          card)
    args = (X, X_db, lam_db, u, a, b, g)
    fused = knn_rank_audited_cuda(*args, k=k, m2=64)
    for gt, w in zip(fused, ref.knn_rank_audited_ref(*args, k=k, m2=64)):
        assert torch.equal(gt, w)
    assert torch.equal(fused[5][:, :lam.shape[1]], lam)
    return got


@pytest.mark.parametrize("k,d", [(20, 20), (33, 20), (64, 20), (10, 300),
                                 (10, 512), (64, 512), (100, 20), (256, 20),
                                 (10, 1407), (10, 1629), (64, 735),
                                 (256, 300)])
def test_f32_knn_kernels_take_larger_k_and_d(card, k, d):
    """The three f32 KNN kernels at k = 20 to 256 (lists of 32 to 256)
    and d = 300 to 1629 (d = 512 and wider scored in pieces of d beside
    the resident queries), bitwise."""
    rng = np.random.default_rng(k + d)
    n_db = 9001
    X_db = _t(rng.normal(size=(n_db, d)), card)
    lam_db = _t(np.abs(rng.normal(size=(n_db, 5))), card)
    X = _t(rng.normal(size=(37, d)), card)
    X[2] = X_db[n_db - 1]
    got = _f32_all(X, X_db, lam_db, card, k)
    assert int(got[1][2, 0]) == n_db - 1


@pytest.mark.parametrize("ordering", ["rising", "falling", "identical",
                                      "planted"])
@pytest.mark.parametrize("k", [10, 100])
def test_f32_knn_kernels_on_hard_orderings(card, ordering, k):
    """The f32 twin of test_quant_kernels_on_hard_orderings: every row
    passing the filter (rising distance), none after the first
    (falling), all rows tied (the lowest indices win) and exact ties
    planted across chunks and stage folds; 40 queries (not a multiple of
    the 32-query tile) over 70,000 rows."""
    rng = np.random.default_rng(23)
    d, n_db = 20, 70_000
    X = rng.normal(size=(40, d)) * 1e-3
    X_db = _t(_ordered_db(ordering, n_db, d, rng, X), card)
    lam_db = _t(np.abs(rng.normal(size=(n_db, 5))), card)
    got = _f32_all(_t(X, card), X_db, lam_db, card, k)
    if ordering == "planted":          # query 0's copies, lowest index first
        assert got[1][0, :5].tolist() == [0, 2999, 5998, 8997, 11996]


@pytest.mark.parametrize("n_db,B,k", [(20, 5, 10), (31, 37, 31),
                                      (100, 33, 64), (257, 1, 256)])
def test_f32_knn_kernels_on_small_dbs(card, n_db, B, k):
    """A db smaller than one tile (down to k = n_db: every row is a
    neighbour) and batches that are not a multiple of the query tile."""
    rng = np.random.default_rng(n_db * B)
    X_db = _t(rng.normal(size=(n_db, 20)), card)
    lam_db = _t(np.abs(rng.normal(size=(n_db, 5))), card)
    _f32_all(_t(rng.normal(size=(B, 20)), card), X_db, lam_db, card, k)


@pytest.mark.parametrize("m2", [50, 500])
def test_mlp_route_on_the_card_equals_plain(card, m2):
    """The MLP route (lambda-hat = predict(X) as torch ops, zero-padded
    to K, then the rank_audited kernel at m2 <= 128 and the sort route
    above it) against its plain version on the same card (the plain
    rank_audited for m2 <= 128, rank_given_lambda above, as the route
    itself sorts there): perm, compliant and lambda-hat exact, one
    launch or none."""
    rng = np.random.default_rng(m2)
    n, m1, K = 32, 1024, 8
    u, a, b, _, g = _rank(rng, n, m1, K, m2, card)
    X_db = _t(rng.normal(size=(400, 20)), card)
    lam_db = _t(np.abs(rng.normal(size=(400, 5))), card)
    mlp = MLPLambdaPredictor.fit(X_db, lam_db, d_hidden=16, num_steps=20,
                                 device=card)
    X = _t(rng.normal(size=(n, 20)), card)
    before = rank_audited_cuda.launches
    got = ops.predict_rank_audited(X, mlp, u, a, b, g, m2=m2, device=card)
    torch.cuda.synchronize()
    assert rank_audited_cuda.launches - before == \
        ops.kernel_launch_count(mlp, m2) == (1 if m2 <= 128 else 0)
    if m2 <= 128:
        want = ref.predict_rank_audited_ref(X, mlp, u, a, b, g, m2)
    else:
        lam = ref.predicted_lambda(mlp, X, K)
        out = ranking.rank_given_lambda(u, a, b, lam, g, m2=m2)
        want = (None, out.perm, out.utility, out.exposure, out.compliant,
                out.lam)
    assert torch.equal(got.perm, want[1])
    assert torch.equal(got.compliant, want[4])
    assert torch.equal(got.lam, want[5])
    assert not got.lam[:, 5:].any()


def test_build_experiment_on_the_card(card):
    """The data stage at the system test's size on the card: finite u,
    X and a of the experiment's shapes, slates in descending order."""
    gen = torch.Generator(device=card)
    gen.manual_seed(11)
    for dataset, K in (("movielens", 5), ("yow", 8)):
        exp = build_experiment(gen, dataset=dataset, n_users=80,
                               n_items=500, m1=200, m2=50,
                               recommender_epochs=2, device=card)
        assert exp.u.shape == (80, 200) and exp.X.shape == (80, 20)
        assert exp.a.shape == (80, K, 200) and exp.b.shape == (K,)
        for x in (exp.u, exp.X, exp.a):
            assert x.device == card and bool(torch.isfinite(x).all())
        assert bool((exp.u[:, :-1] >= exp.u[:, 1:]).all())
        assert exp.train_idx.numel() == 60 and exp.test_idx.numel() == 20


def test_adam_update_on_the_card_matches_the_cpu(card):
    """50 Adam steps on the card and on the CPU from the same numpy
    parameters and gradients: rtol=1e-6, atol=1e-7 (the same operations
    in the same order; the two devices' sqrt and pow may part by an
    ulp)."""
    rng = np.random.default_rng(50)
    p0 = {"w": rng.normal(size=(200, 20)), "b": rng.normal(size=(20,))}
    sides = {}
    for dev in (torch.device("cpu"), card):
        p = {k: torch.tensor(v, dtype=torch.float32, device=dev)
             for k, v in p0.items()}
        state = adam_init(p, device=dev)
        for i in range(50):
            g = {k: torch.tensor(np.random.default_rng(i).normal(
                size=v.shape), dtype=torch.float32, device=dev)
                for k, v in p0.items()}
            p, state = adam_update(g, state, p, lr=0.01, weight_decay=0.01)
        sides[dev.type] = {k: v.cpu().numpy() for k, v in p.items()}
    for k in p0:
        np.testing.assert_allclose(sides["cuda"][k], sides["cpu"][k],
                                   rtol=1e-6, atol=1e-7)


def _serving_stream(card, n=192, seed=30):
    """A lambda-given and a KNN surface at serve_online widths, with a
    5001-row db on the card."""
    rng = np.random.default_rng(seed)
    knn = KNNLambdaPredictor.fit(_t(rng.normal(size=(5001, 20)), card),
                                 _t(np.abs(rng.normal(size=(5001, 5))),
                                    card), k=10, device=card)
    mix = (Scenario("feed", m1=1024, m2=50, K=5, weight=2.0),
           Scenario("knn", m1=1024, m2=50, K=5, tag="knn", d_cov=20))
    return knn, make_stream(mix, n_requests=n, seed=seed)


def _serve(card, depth, knn, reqs):
    eng = ServingEngine(max_batch=32, max_wait_ms=2.0, pipeline_depth=depth,
                        device=card)
    eng.register_predictor("knn", knn, d_cov=20)
    eng.warmup(reqs)
    return eng, {r.rid: r for r in eng.serve_stream(reqs)}


def test_engine_buffers_are_pinned_and_depths_agree(card):
    """Every slot's host inputs and outputs are page-locked, its inputs
    lie on the card, and depth 0 and depth 1 give the same perm,
    compliant, utility and exposure for every request."""
    knn, reqs = _serving_stream(card)
    served = {}
    for depth in (0, 1):
        eng, served[depth] = _serve(card, depth, knn, reqs)
        assert eng.metrics.kernel_launches > 0   # the kernels, not the CPU
        for ring in eng._rings.values():
            assert ring.allocated == depth + 2
            for slot in ring._slots.values():
                assert all(t.is_pinned() for t in slot.host.values())
                assert all(t.is_pinned() for t in slot.output_views.values())
                assert all(t.device == card for t in slot.inputs.values())
                assert slot.event is not None
        eng.close()
    assert sorted(served[0]) == sorted(served[1]) == list(range(len(reqs)))
    for rid, r in served[0].items():
        g = served[1][rid]
        np.testing.assert_array_equal(g.perm, r.perm)
        np.testing.assert_array_equal(g.exposure, r.exposure)
        assert (g.utility, g.compliant) == (r.utility, r.compliant)


def test_pipeline_overlaps_and_the_worker_never_launches(card, monkeypatch):
    """At depth 1 a back-to-back stream overlaps host and card
    (overlap_ratio > 0), and every kernel launch comes from the
    submitting thread, none from the pipeline worker."""
    knn, reqs = _serving_stream(card, n=512, seed=31)
    threads = []
    launch = build.launch

    def spy(name, *args):
        threads.append(threading.current_thread().name)
        return launch(name, *args)

    monkeypatch.setattr(build, "launch", spy)
    eng, served = _serve(card, 1, knn, reqs)
    s = eng.metrics.summary()
    eng.close()
    assert len(served) == len(reqs)
    assert s["pipeline"]["overlap_ratio"] > 0.0
    assert s["dispatches_per_batch"] == 1.0
    assert threads and set(threads) == {threading.main_thread().name}


def _same(got, want):
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.exposure, want.exposure)
    assert (got.utility, got.compliant) == (want.utility, want.compliant)


def _cold(card, knn, state, reqs):
    """rid -> result of a depth-0 engine serving `state` from the start."""
    eng = ServingEngine(max_batch=32, max_wait_ms=1e9, pipeline_depth=0,
                        device=card)
    eng.register_predictor("knn", knn, d_cov=20)
    eng.swap_predictor("knn", state)
    out = {r.rid: r for r in eng.serve_stream(reqs)}
    eng.close()
    return out


def test_mid_stream_refresh_at_depth_1_equals_cold_engines(card):
    """The lane refreshes the KNN db (ring write on its own stream) while
    batches are in flight at depth 1: every result is bitwise what a cold
    engine serving its epoch's state gives."""
    rng = np.random.default_rng(40)
    knn = KNNLambdaPredictor.fit(_t(rng.normal(size=(5001, 20)), card),
                                 _t(0.05 * np.abs(rng.normal(size=(5001, 5))),
                                    card), k=10, device=card)
    reqs = make_drift_stream(
        DriftSpec(kind="tighten", magnitude=8.0, start=0.25, end=0.75),
        tag="knn", n_requests=256, m1=1024, m2=50, K=5, d_cov=20, seed=41)
    eng = ServingEngine(max_batch=32, max_wait_ms=1e9, pipeline_depth=1,
                        device=card)
    eng.register_predictor("knn", knn, d_cov=20)
    lane = RefreshLane(eng, eta=1.0, min_samples=8)
    eng.warmup(reqs)
    states, results = {0: eng.predictor_state_of("knn")}, []
    for i, r in enumerate(reqs):
        results += eng.submit(r)
        if i % 64 == 63:                    # batches still in flight
            rep = lane.refresh("knn")["knn"]
            if rep["swapped"]:
                states[rep["epoch"]] = eng.predictor_state_of("knn")
    results += eng.drain()
    eng.close()
    assert len(states) >= 3 and len(results) == len(reqs)
    assert eng.metrics.kernel_launches > 0
    by_epoch = {}
    for r in results:
        by_epoch.setdefault(r.epoch, []).append(r)
    assert len(by_epoch) >= 2
    for epoch, rs in by_epoch.items():
        want = _cold(card, knn, states[epoch],
                     [q for q in reqs if q.rid in {r.rid for r in rs}])
        for r in rs:
            _same(r, want[r.rid])


def test_a_superseded_generation_is_not_reused_while_pinned(card):
    """Generation 1 (written on a side stream) serves a batch held in
    flight; generation 2 supersedes it. While the batch pins it, the
    engine keeps generation 1 and allocations of its size on the stream
    that wrote it never get its memory; once the batch retires it is let
    go, and the batch's rows are bitwise generation 1's."""
    knn, reqs = _serving_stream(card, n=192, seed=42)
    reqs = [r for r in reqs if r.tag == "knn"][:32]
    assert len(reqs) == 32
    side = torch.cuda.Stream(card)
    gens = {}
    with torch.cuda.stream(side):
        for e in (1, 2):
            g = torch.Generator(device=card).manual_seed(e)
            gens[e] = {"X_db": torch.randn(knn.X_db.shape, generator=g,
                                           device=card),
                       "lam_db": torch.rand(knn.lam_db.shape, generator=g,
                                            device=card)}
    gate = threading.Event()

    class Gated(ServingEngine):
        def _materialize_batch(self, pending):
            assert gate.wait(timeout=60.0)
            super()._materialize_batch(pending)

    eng = Gated(max_batch=32, max_wait_ms=1e9, pipeline_depth=1,
                device=card)
    eng.register_predictor("knn", knn, d_cov=20)
    gate.set()
    eng.warmup(reqs)
    gate.clear()
    assert eng.swap_predictor("knn", gens[1]) == 1
    retired = eng.metrics.states_retired      # generation 0, unpinned
    ptrs = {k: v.data_ptr() for k, v in gens[1].items()}
    nbytes = {k: v.numel() * v.element_size() for k, v in gens[1].items()}
    del gens[1]
    for r in reqs:                           # one capacity flush, held
        eng.submit(r)
    assert eng._inflight_gens == {("knn", 1): 1}
    assert eng.swap_predictor("knn", gens[2]) == 2
    assert set(eng._old_states["knn"]) == {1}
    assert eng.metrics.states_retired == retired
    with torch.cuda.stream(side):
        fresh = [torch.empty(nbytes[k] // 4, device=card) for k in ptrs
                 for _ in range(4)]
    assert not {t.data_ptr() for t in fresh} & set(ptrs.values())
    held = eng._old_states["knn"][1]
    want = _cold(card, knn, {k: v.clone() for k, v in held.items()}, reqs)
    del held
    gate.set()
    out = eng.drain()
    assert eng._old_states["knn"] == {}
    assert eng.metrics.states_retired == retired + 1
    assert {r.epoch for r in out} == {1}
    for r in out:
        _same(r, want[r.rid])
    eng.close()


# ---------------------------------------------------------------------------
# The adaptive lattice and the fleet on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m1", [576, 1216])
@pytest.mark.parametrize("m2", [16, 56])
@pytest.mark.parametrize("K", [4, 12])
def test_rank_kernels_at_learned_corners_equal_plain(card, m1, m2, K):
    """The corners a learned lattice routes (m1 a multiple of 64, m2 of
    8, K of 4 outside the static tiers): the three rank kernels of the
    serving path, bitwise their plain versions, with an affine and a KNN
    predictor of 5 (or K) shadow prices padded to K."""
    rng = np.random.default_rng(m1 + m2 + K)
    u, a, b, lam, g = _rank(rng, 8, m1, K, m2, card)
    got = rank_audited_cuda(u, a, b, lam, g, m2=m2)
    for gt, w in zip(got, ref.rank_audited_ref(u, a, b, lam, g, m2)):
        assert torch.equal(gt, w)
    K_pred = min(5, K)
    X = _t(rng.normal(size=(8, 20)), card)
    W = torch.zeros((K, 20), device=card)
    c = torch.zeros((K,), device=card)
    W[:K_pred] = _t(rng.normal(size=(K_pred, 20)) * 0.3, card)
    c[:K_pred] = _t(rng.normal(size=(K_pred,)) * 0.5, card)
    args = (u, a, b, X, W, c, g)
    got = linear_rank_audited_cuda(*args, m2=m2, relu=True)
    for gt, w in zip(got, ref.linear_rank_audited_ref(*args, m2, relu=True)):
        assert torch.equal(gt, w)
    X_db = _t(rng.normal(size=(5001, 20)), card)
    lam_db = _t(np.abs(rng.normal(size=(5001, K_pred))), card)
    args = (X, X_db, lam_db, u, a, b, g)
    got = knn_rank_audited_cuda(*args, k=10, m2=m2)
    for gt, w in zip(got, ref.knn_rank_audited_ref(*args, k=10, m2=m2)):
        assert torch.equal(gt, w)


def _no_device_wide_sync(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a device-wide torch.cuda.synchronize")
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)


def _lattice_stream(n, seed):
    mix = (Scenario("feed", m1=540, m2=10, K=3, weight=2.0, m1_jitter=0.05),
           Scenario("strip", m1=300, m2=8, K=5, weight=1.0, m1_jitter=0.1),
           Scenario("knn", m1=768, m2=50, K=5, tag="knn", d_cov=20,
                    m1_jitter=1.0 / 3.0, weight=1.0))
    return make_stream(mix, n_requests=n, seed=seed)


def test_shadow_warm_on_a_second_thread_while_the_first_serves(
        card, monkeypatch):
    """A lane's thread warms a learned lattice while the submitting
    thread serves on the same engine (depth 1), with no device-wide wait
    anywhere; after the flip, every row of both epochs is bitwise what a
    cold engine built on that epoch's lattice serves."""
    from repro_torch.serving import optimize_lattice

    knn, _ = _serving_stream(card)
    first, second = _lattice_stream(256, 50), _lattice_stream(128, 51)
    for i, r in enumerate(second):
        r.rid = 1000 + i
    eng = ServingEngine(max_batch=8, max_wait_ms=1e9, pipeline_depth=1,
                        device=card)
    eng.register_predictor("knn", knn, d_cov=20)
    eng.warmup(first + second)
    _no_device_wide_sync(monkeypatch)
    eng.serve_stream(first[:64], warmup=False)
    new = optimize_lattice(eng.shape_histogram, max_executables=8, batch=8)
    report = {}
    lane = threading.Thread(target=lambda: report.update(
        eng.shadow_warm_lattice(new)))
    lane.start()
    got0 = eng.serve_stream(first[64:], warmup=False)
    lane.join()
    assert report["compiled"] and eng.lattice_epoch() == 0
    eng.swap_lattice(new)
    got1 = eng.serve_stream(second, warmup=False)
    assert eng.metrics.compiles_post_warmup == 0
    assert {r.lattice_epoch for r in got0} == {0}
    assert {r.lattice_epoch for r in got1} == {1}
    eng.close()
    monkeypatch.undo()
    for lattice, reqs, got in ((None, first[64:], got0),
                               (new, second, got1)):
        cold = ServingEngine(max_batch=8, max_wait_ms=1e9, pipeline_depth=0,
                             lattice=lattice, device=card)
        cold.register_predictor("knn", knn, d_cov=20)
        want = {r.rid: r for r in cold.serve_stream(reqs)}
        cold.close()
        for r in got:
            _same(r, want[r.rid])


def test_three_engines_share_the_card_each_on_its_own_stream(
        card, monkeypatch):
    """Three engines (a fleet's replicas) on one card, served from three
    threads at once: three streams, no device-wide wait in their warmups,
    and each engine's rows bitwise a lone engine's."""
    knn, reqs = _serving_stream(card, n=128, seed=52)
    eng0, want = _serve(card, 0, knn, reqs)
    eng0.close()
    _no_device_wide_sync(monkeypatch)
    engines = []
    for _ in range(3):
        eng = ServingEngine(max_batch=32, max_wait_ms=2.0, pipeline_depth=1,
                            device=card)
        eng.register_predictor("knn", knn, d_cov=20)
        eng.warmup(reqs)
        engines.append(eng)
    assert len({id(e._stream) for e in engines}) == 3
    assert all(e._stream != torch.cuda.default_stream(card) for e in engines)
    out = [None] * 3

    def serve(i):
        out[i] = engines[i].serve_stream(reqs, warmup=False)

    threads = [threading.Thread(target=serve, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for eng, got in zip(engines, out):
        eng.close()
        assert sorted(r.rid for r in got) == sorted(want)
        for r in got:
            _same(r, want[r.rid])


def test_a_restarted_replica_serves_its_reloaded_epoch_bitwise(
        card, monkeypatch, tmp_path):
    """A fleet replica refreshes and checkpoints epoch 1, dies and is
    restarted (factory, reload onto the card, re-warm; no device-wide
    wait): it resumes at epoch 1 and serves it bitwise as a cold engine
    given the pre-crash generation does."""
    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.serving import FleetRouter

    rng = np.random.default_rng(53)
    knn = KNNLambdaPredictor.fit(
        _t(rng.normal(size=(5001, 20)), card),
        _t(0.05 * np.abs(rng.normal(size=(5001, 5))), card), k=10,
        device=card)
    reqs = make_drift_stream(
        DriftSpec(kind="tighten", magnitude=8.0, start=0.0, end=0.5),
        tag="knn", n_requests=96, m1=1024, m2=50, K=5, d_cov=20, seed=54)

    def factory(name):
        eng = ServingEngine(max_batch=8, max_wait_ms=1e9, pipeline_depth=1,
                            device=card)
        eng.register_predictor("knn", knn, d_cov=20)
        store = CheckpointStore(str(tmp_path / name), keep_last=2)
        return eng, RefreshLane(eng, eta=1.0, min_samples=8,
                                checkpoint=store)

    router = FleetRouter(factory, 3, auto_restart=False,
                         heartbeat_interval_s=float("inf"))
    router.serve_stream(reqs[:64])
    primary = router.replicas[router._owners(
        router._bucket_key(reqs[0]))[0]]
    rep = router.refresh()[primary.name]["knn"]
    assert rep["swapped"] and rep["checkpointed"] and rep["epoch"] == 1
    live = {k: v.clone() for k, v in
            primary.engine.predictor_state_of("knn").items()}
    primary.health.on_failure(0.0, fatal=True)
    _no_device_wide_sync(monkeypatch)
    assert router.restart(primary.name) == {"knn": 1}
    monkeypatch.undo()
    eng = primary.engine
    assert eng.predictor_epoch("knn") == 1
    assert all(torch.equal(eng.predictor_state_of("knn")[k], v)
               for k, v in live.items())
    got = eng.serve_stream(reqs[64:], warmup=False)
    assert {r.epoch for r in got} == {1}
    want = _cold(card, knn, live, reqs[64:])
    for r in got:
        _same(r, want[r.rid])
    assert set(primary.restart_ms[0]) == {"factory", "reload", "rewarm"}
    router.close()


def test_deepfm_context_sum_through_the_kernel_equals_plain(card):
    """DeepFM's retrieval context (38 context fields of width 10; the
    table cut to 39 fields x 20,000 rows): the embedding_bag kernel's
    sum, bitwise its plain version, one launch a call."""
    from repro_torch.configs import get_arch
    from repro_torch.data.batches import make_deepfm_batch
    from repro_torch.models.recsys import RECSYS_REGISTRY
    import dataclasses

    cfg = dataclasses.replace(get_arch("deepfm").make_config(full=True),
                              field_vocab=20_000)
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    model = RECSYS_REGISTRY["deepfm"](cfg, gen=gen, device=card)
    ids = make_deepfm_batch(gen, batch=64, n_sparse=cfg.n_sparse,
                            field_vocab=cfg.field_vocab, device=card)["ids"]
    before = embedding_bag_cuda.launches
    ctx = model.context_sum(ids[:, 1:])
    torch.cuda.synchronize()
    assert embedding_bag_cuda.launches == before + 1
    want = ref.embedding_bag_ref(model.table.detach(),
                                 ids[:, 1:].contiguous(), None)
    assert torch.equal(ctx, want)
    scores = model.retrieval_scores(ids[:, 1:], torch.arange(512,
                                                             device=card))
    assert scores.shape == (64, 512) and bool(torch.isfinite(scores).all())


def test_sharded_knn_topk_on_a_virtual_mesh_equals_one_launch(card):
    """A virtual (1, 4) mesh over the card: four knn_topk launches, one a
    shard, merged to (d2, idx) bitwise one knn_topk launch over the
    whole db and its plain version (each pair's d2 is rounded the same
    way in any sweep geometry)."""
    from repro_torch.distributed.topk import sharded_knn_topk
    from repro_torch.launch.mesh import shard_rows, virtual_mesh

    rng = np.random.default_rng(41)
    xq = _t(rng.normal(size=(64, 20)), card)
    xdb = _t(rng.normal(size=(40_000, 20)), card)
    mesh = virtual_mesh((1, 4), ("data", "model"), card)
    db = shard_rows(mesh, xdb)
    before = knn_topk_cuda.launches
    d2, idx = sharded_knn_topk(mesh, xq, db, 10)
    torch.cuda.synchronize()
    assert knn_topk_cuda.launches == before + 8
    for want in (knn_topk_cuda(xq, xdb, k=10), ref.knn_topk_ref(xq, xdb, 10)):
        assert torch.equal(idx, want[1]) and torch.equal(d2, want[0])


@pytest.mark.parametrize("m1,m2", [(1024, 50), (1024, 128), (512, 500)],
                         ids=["m2=50", "kk=128", "m2=500,kk=128"])
def test_rank_distributed_equals_rank_audited(card, m1, m2):
    """rank_distributed on a virtual (2, 4) mesh against the dense
    rank_audited on the same rows: perm and compliant exact, the audit's
    floats bitwise (the same score and audit arithmetic). m2 <= 128
    launches fused_rank once a shard; m2 = 500 over 128 items a shard
    ranks by the sort route, as the dense dispatcher does."""
    from repro_torch.core.serving_dist import (
        dist_kernel_launches,
        rank_distributed,
    )
    from repro_torch.launch.mesh import make_smoke_mesh

    u, a, b, lam, g = _rank(np.random.default_rng(m2), 32, m1, 8, m2, card)
    mesh = make_smoke_mesh(device=card)
    before = fused_rank_cuda.launches
    out = rank_distributed(mesh, u, a, b, lam, g, m2=m2)
    torch.cuda.synchronize()
    assert fused_rank_cuda.launches - before == dist_kernel_launches(
        None, m2, mesh=mesh).get("fused_rank", 0)
    want = ops.rank_audited(u, a, b, lam, g, m2=m2)
    for f in ("perm", "compliant", "utility", "exposure"):
        assert torch.equal(getattr(out, f), getattr(want, f)), f


def test_dist_engine_rows_equal_the_default_engines(card):
    """The lambda-given and KNN surfaces (m2 = 50) through
    ServingEngine(executor='dist') on a virtual (2, 4) mesh and the
    default engine: every row's perm and compliant equal, its floats
    bitwise; the launch counters move by the dist route's counts."""
    from repro_torch.core.serving_dist import dist_kernel_launches
    from repro_torch.launch.mesh import make_smoke_mesh

    knn, reqs = _serving_stream(card, n=128)
    mesh = make_smoke_mesh(device=card)
    dist = ServingEngine(max_batch=32, max_wait_ms=2.0, executor="dist",
                         mesh=mesh, device=card)
    dist.register_predictor("knn", knn, d_cov=20)
    dist.warmup(reqs)
    before = (fused_rank_cuda.launches, knn_lambda_cuda.launches)
    got = {r.rid: r for r in dist.serve_stream(reqs)}
    s = dist.metrics.summary()
    assert s["compiles_post_warmup"] == 0
    launched = (fused_rank_cuda.launches - before[0],
                knn_lambda_cuda.launches - before[1])
    assert sum(launched) == dist.metrics.kernel_launches
    assert launched[0] == s["batches"] * dist_kernel_launches(
        None, 50, mesh=mesh)["fused_rank"]
    _, want = _serve(card, 1, knn, reqs)
    dist.close()
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g.perm, w.perm)
        assert g.compliant == w.compliant and g.utility == w.utility
        np.testing.assert_array_equal(g.exposure, w.exposure)


def test_a_mesh_across_cards_equals_a_virtual_one(card):
    """With two or more cards, a (1, n) mesh over every card (each
    shard body on its own card, on a stream of that card ordered after
    the caller's, the shards' rows copied there once) gives what the
    virtual (1, n) mesh over one card gives, bitwise: the sharded
    knn_topk, rank_distributed, and on four cards a (2, 2) dist
    engine's rows."""
    from repro_torch.core.serving_dist import rank_distributed
    from repro_torch.distributed.topk import sharded_knn_topk
    from repro_torch.launch.mesh import make_mesh, shard_rows, virtual_mesh

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    axes = ("data", "model")
    mesh, virt = make_mesh((1, n), axes), virtual_mesh((1, n), axes, card)
    rng = np.random.default_rng(43)
    xq = _t(rng.normal(size=(64, 20)), card)
    xdb = _t(rng.normal(size=(40_000, 20)), card)
    db = shard_rows(mesh, xdb)
    assert {d for c in db.copies for d in c} == set(mesh.physical_devices)
    got = sharded_knn_topk(mesh, xq, db, 10)
    want = sharded_knn_topk(virt, xq, xdb, 10)
    assert got[0].device == card
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    u, a, b, lam, g = _rank(rng, 32, 1024, 8, 50, card)
    got = rank_distributed(mesh, u, a, b, lam, g, m2=50)
    want = rank_distributed(virt, u, a, b, lam, g, m2=50)
    for f in ("perm", "compliant", "utility", "exposure"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    if n < 4:
        return
    knn, reqs = _serving_stream(card, n=128)
    rows = {}
    for label, m in (("cards", make_mesh((2, 2), axes)),
                     ("virtual", virtual_mesh((2, 2), axes, card))):
        eng = ServingEngine(max_batch=32, max_wait_ms=2.0, executor="dist",
                            mesh=m, device=card)
        eng.register_predictor("knn", knn, d_cov=20)
        eng.warmup(reqs)
        rows[label] = {r.rid: r for r in eng.serve_stream(reqs)}
        assert eng.metrics.summary()["compiles_post_warmup"] == 0
        eng.close()
    assert sorted(rows["cards"]) == sorted(rows["virtual"])
    for rid, w in rows["virtual"].items():
        g = rows["cards"][rid]
        np.testing.assert_array_equal(g.perm, w.perm)
        assert g.compliant == w.compliant and g.utility == w.utility
        np.testing.assert_array_equal(g.exposure, w.exposure)


def test_xla_engine_on_the_card_launches_no_kernel(card):
    """ServingEngine(executor='xla') on the card: no wrapper's counter
    moves and the metrics count 0 launches; every row equals the same
    executor's on the CPU (perm and compliant exact, floats within
    rtol 1e-5, atol 1e-5) and the fused engine's perm where the row's
    scores part at the cut."""
    knn, reqs = _serving_stream(card, n=128)
    wrappers = (rank_audited_cuda, knn_rank_audited_cuda, knn_lambda_cuda,
                fused_rank_cuda, linear_rank_audited_cuda)
    before = [w.launches for w in wrappers]
    served = {}
    for dev in (card, torch.device("cpu")):
        eng = ServingEngine(max_batch=32, max_wait_ms=2.0, executor="xla",
                            device=dev)
        eng.register_predictor("knn", knn.to(dev), d_cov=20)
        eng.warmup(reqs)
        served[dev.type] = {r.rid: r for r in eng.serve_stream(reqs)}
        assert eng.metrics.kernel_launches == 0
        assert set(eng._launches.values()) == {0}
        eng.close()
    assert [w.launches for w in wrappers] == before
    assert sorted(served["cuda"]) == list(range(len(reqs)))
    for rid, w in served["cpu"].items():
        g = served["cuda"][rid]
        np.testing.assert_array_equal(g.perm, w.perm)
        assert g.compliant == w.compliant
        np.testing.assert_allclose(g.utility, w.utility, rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(g.exposure, w.exposure, rtol=1e-5,
                                   atol=1e-5)


LM_ARCHS = ("llama3.2-1b", "mistral-nemo-12b", "phi3-medium-14b",
            "llama4-scout-17b-a16e", "kimi-k2-1t-a32b")


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_smoke_arch_on_the_card_equals_the_cpu(card, arch):
    """Each LM arch's SMOKE config (f32) on the card against the CPU on
    the same parameters and tokens: forward logits and aux, prefill's
    last logits and caches, 4 decode steps (rtol 1e-4, atol 1e-5: the
    card's f32 matmuls sum in another order), the loss and grad_norm
    (rtol 1e-5) and every gradient (rtol 1e-4, atol 1e-5: kimi's
    embedding gradient, each row summed over the tokens in another
    order, measured 1.8e-6 apart at worst). The card's train step is
    held to the CPU's clip and Adam applied to the card's own
    gradients, every leaf within lr * 1e-4: a gradient that differs in
    its rounding moves Adam's first step by up to the share of a step
    that the difference is of Adam's eps, so the step is checked on the
    gradients it used."""
    from repro_torch.configs import get_arch
    from repro_torch.data.batches import make_lm_batch
    from repro_torch.models import transformer as tt

    cfg = get_arch(arch).make_config(full=False)
    params = tt.lm_init(torch.Generator().manual_seed(0), cfg, device="cpu")
    batch = make_lm_batch(torch.Generator().manual_seed(1), batch=2, seq=16,
                          vocab=cfg.vocab, device="cpu")
    lr = 1e-2
    tol = dict(rtol=1e-4, atol=1e-5)
    out = {}
    for dev in (torch.device("cpu"), card):
        p = tt.lm_from_numpy(tt.lm_state_numpy(params), cfg, device=dev)
        b = {k: v.to(dev) for k, v in batch.items()}
        logits, aux = tt.lm_forward(p, b["tokens"], cfg)
        cache, last = tt.lm_prefill(p, b["tokens"][:, :12], cfg)
        full = tt.make_decode_cache(cfg, 2, 16, device=dev)
        for n in ("k", "v"):
            full[n][:, :, :12] = cache[n]
        steps = []
        for pos in range(12, 16):
            log, full = tt.lm_decode_step(p, full, b["tokens"][:, pos], pos,
                                          cfg)
            steps.append(log)
        grads = flatten_with_paths(tt.lm_grads(p, b, cfg)[2])
        new, _, m = tt.lm_train_step(p, tt.lm_adam_init(p, cfg), b, cfg,
                                     lr=lr)
        out[dev.type] = dict(
            logits=logits, aux=aux, last=last, k=cache["k"], v=cache["v"],
            decode=torch.stack(steps), loss=m["loss"],
            grad_norm=m["grad_norm"],
            **{f"grad/{k}": g for k, g in grads.items()})
        new = {k: v.cpu() for k, v in flatten_with_paths(new).items()}
    for k, want in out["cpu"].items():
        got = out["cuda"][k].cpu()
        if k in ("loss", "grad_norm"):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5)
        elif k.startswith("grad/"):
            np.testing.assert_allclose(got.numpy(), want.numpy(), **tol,
                                       err_msg=k)
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), **tol,
                                       err_msg=k)
    # the CPU's clip and Adam on the card's gradients
    p = {k: v.detach() for k, v in flatten_with_paths(params).items()}
    g = {k: out["cuda"][f"grad/{k}"].cpu() for k in p}
    g, _ = clip_by_global_norm(g, 1.0)
    want, _ = adam_update(g, tt.lm_adam_init(params, cfg), p, lr=lr)
    for k, w in want.items():
        assert float((new[k] - w).abs().max()) <= lr * 1e-4, k


def test_lm_bf16_decode_matches_forward_on_the_card(card):
    """llama3.2-1b's layout at a narrow width in bf16 on the card (the
    FULL dtypes): prefill's last logits and 4 decode steps against
    lm_forward on the whole sequence, within chip_smoke.py's
    LM_BF16_TOL (max abs 0.25, relative L2 4e-2)."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as tt

    base = get_arch("llama3.2-1b").make_config(full=False)
    cfg = tt.LMConfig(**{**base.__dict__, "dtype": torch.bfloat16,
                         "param_dtype": torch.bfloat16, "n_layers": 4})
    p = tt.lm_init(torch.Generator(card).manual_seed(0), cfg, device=card)
    tokens = torch.randint(0, cfg.vocab, (4, 36), device=card,
                           generator=torch.Generator(card).manual_seed(1))
    fwd = tt.lm_forward(p, tokens, cfg)[0].float()
    cache, last = tt.lm_prefill(p, tokens[:, :32], cfg)
    full = tt.make_decode_cache(cfg, 4, 128, device=card)
    for n in ("k", "v"):
        full[n][:, :, :32] = cache[n]
    got = [last]
    for pos in range(32, 36):
        log, full = tt.lm_decode_step(p, full, tokens[:, pos], pos, cfg)
        got.append(log)
    got = torch.stack(got, 1)
    want = fwd[:, 31:36]
    assert float((got - want).abs().max()) <= 0.25
    assert float((got - want).norm() / want.norm()) <= 4e-2


def test_gnn_aggregate_is_bitwise_run_to_run_on_the_card(card):
    """models.gnn.aggregate on the card: sum and mean through
    index_put(accumulate=True), which sorts the receivers and adds each
    segment in a fixed order, and max through scatter_reduce: two calls
    give the same bits, and the card's sum and mean are within rtol
    1e-5, atol 1e-5 of the CPU's (another order of adding). Empty
    segments under max stay -inf."""
    from repro_torch.models.gnn import aggregate

    rng = np.random.default_rng(0)
    n_nodes, n_edges = 5000, 200_000
    msgs = torch.from_numpy(rng.normal(size=(n_edges, 128)).astype(
        np.float32))
    recv = torch.from_numpy(rng.integers(0, n_nodes - 10, n_edges))
    for mode in ("sum", "mean", "max"):
        a = aggregate(msgs.to(card), recv.to(card), n_nodes, mode)
        b = aggregate(msgs.to(card), recv.to(card), n_nodes, mode)
        assert torch.equal(a, b), mode
        want = aggregate(msgs, recv, n_nodes, mode)
        if mode == "max":
            assert torch.equal(a.cpu(), want)
            assert bool(torch.all(a[-10:] == float("-inf")))
        else:
            np.testing.assert_allclose(a.cpu().numpy(), want.numpy(),
                                       rtol=1e-5, atol=1e-5, err_msg=mode)


def test_gnn_train_step_on_the_card_equals_the_cpu(card):
    """meshgraphnet's SMOKE config (remat on) on the card against the
    CPU on the same parameters and graph: the loss and grad_norm (rtol
    1e-5), every gradient (rtol 1e-4, atol 1e-6); the CPU's clip and
    Adam on the card's gradients within lr * 1e-4 of the card's step;
    two card steps bitwise equal."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.data.batches import make_random_graph
    from repro_torch.models import gnn

    cfg = dataclasses.replace(
        get_arch("meshgraphnet").make_config(full=False), remat=True)
    params = gnn.gnn_init(torch.Generator().manual_seed(0), cfg,
                          device="cpu")
    graph = make_random_graph(torch.Generator().manual_seed(1), n_nodes=64,
                              n_edges=160, d_node=cfg.d_node_in,
                              d_edge=cfg.d_edge_in, d_out=cfg.d_out,
                              device="cpu")
    lr = 1e-3
    out = {}
    for dev in (torch.device("cpu"), card):
        p = gnn.gnn_from_numpy(gnn.gnn_state_numpy(params), cfg, device=dev)
        g = {k: v.to(dev) for k, v in graph.items()}
        grads = flatten_with_paths(gnn.gnn_grads(p, g, cfg)[2])
        steps = [gnn.gnn_train_step(p, gnn.gnn_adam_init(p), g, cfg, lr=lr)
                 for _ in range(2)]
        out[dev.type] = dict(grads=grads, steps=steps)
    (new, opt, m), (new2, opt2, m2) = out["cuda"]["steps"]
    for a, b in ((new, new2), (opt, opt2)):
        fa, fb = flatten_with_paths(a), flatten_with_paths(b)
        assert all(torch.equal(fa[k], fb[k]) for k in fa)
    m_cpu = out["cpu"]["steps"][0][2]
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(m[k].cpu().numpy(), m_cpu[k].numpy(),
                                   rtol=1e-5)
    for k, want in out["cpu"]["grads"].items():
        np.testing.assert_allclose(out["cuda"]["grads"][k].cpu().numpy(),
                                   want.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    p = {k: v.detach() for k, v in flatten_with_paths(params).items()}
    g = {k: v.cpu() for k, v in out["cuda"]["grads"].items()}
    g, _ = clip_by_global_norm(g, 1.0)
    want, _ = adam_update(g, gnn.gnn_adam_init(params), p, lr=lr)
    got = flatten_with_paths(new)
    for k, w in want.items():
        assert float((got[k].cpu() - w).abs().max()) <= lr * 1e-4, k


def test_retrieval_program_through_the_kernels_equals_plain(card,
                                                            monkeypatch):
    """retrieval_cand's program (build_recsys) at DeepFM's and MIND's
    SMOKE widths over 16,384 candidates and the 65,536-row KNN database,
    on a virtual (2, 4) mesh on the card: through the knn_lambda,
    fused_rank and embedding_bag kernels (their launches counted), then
    with ops' three wrappers swapped for their plain versions: perm
    exactly, the adjusted scores and lambda-hat bitwise."""
    from repro_torch.configs import get_arch
    from repro_torch.configs.recsys_family import build_recsys
    from repro_torch.configs.registry import Cell
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models.recsys import RECSYS_REGISTRY

    mesh = make_smoke_mesh(device=card)
    cell = Cell("retrieval_cand", "retrieval",
                {"batch": 1, "n_candidates": 16384})
    gen = torch.Generator(device=card)
    gen.manual_seed(5)
    for arch in ("deepfm", "mind"):
        cfg = get_arch(arch).make_config(False)
        prog = build_recsys(cfg, cell, mesh)
        model = RECSYS_REGISTRY[cfg.kind](cfg, gen=gen, device=card)
        (B, w), n = prog.args[1].shape, prog.args[2].shape[0]
        hi = cfg.field_vocab if arch == "deepfm" else cfg.n_items
        user = torch.randint(0, hi, (B, w), generator=gen, device=card)
        if arch == "deepfm":
            user = user + torch.arange(1, cfg.n_sparse, device=card) * hi
        args = (model.params(), user.to(torch.int32),
                torch.randint(0, hi, (n,), generator=gen,
                              device=card).to(torch.int32),
                (torch.rand(prog.args[3].shape, generator=gen,
                            device=card) < 0.15).float(),
                torch.randn(prog.args[4].shape, generator=gen, device=card),
                torch.rand(prog.args[5].shape, generator=gen, device=card))
        before = (knn_lambda_cuda.launches, fused_rank_cuda.launches,
                  embedding_bag_cuda.launches)
        got = prog.fn(*args)
        torch.cuda.synchronize()
        assert (knn_lambda_cuda.launches - before[0],
                fused_rank_cuda.launches - before[1],
                embedding_bag_cuda.launches - before[2]) == (
            2, 1, 1 if arch == "deepfm" else 0)
        with monkeypatch.context() as m:
            m.setattr(ops, "knn_lambda_cuda", lambda xq, xdb, lam, *, k=10,
                      device=None: ref.knn_lambda_ref(xq, xdb, lam, k))
            m.setattr(ops, "fused_rank_cuda", lambda u, a, lam, *, m2,
                      eps=1e-4, device=None: ref.fused_rank_ref(
                          u, a, lam, m2, eps))
            m.setattr(ops, "embedding_bag_cuda", lambda t, i, w=None, *,
                      device=None: ref.embedding_bag_ref(t, i, w))
            want = prog.fn(*args)
        for g, w in zip(got, want):
            assert torch.equal(g, w), arch


def test_moe_apply_shmap_on_the_card_matches_the_global_dispatch(card):
    """llama4-scout's layout at SMOKE widths in bf16 (its FULL dtypes)
    with 8 experts: moe_apply_shmap on a virtual (2, 4) mesh on the card
    against the global moe_apply on tokens where neither drops an
    assignment, within chip_smoke.py's LM_BF16_TOL (max abs 0.25,
    relative L2 4e-2)."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_smoke_mesh
    from repro_torch.models import layers

    cfg = replace(get_arch("llama4-scout-17b-a16e").make_config(False),
                  n_experts=8, dtype=torch.bfloat16,
                  param_dtype=torch.bfloat16, moe_dispatch="shmap")
    gen = torch.Generator(device=card)
    gen.manual_seed(6)
    params = layers.moe_init(gen, cfg, device=card)
    x = torch.randn((2, 4, cfg.d_model), generator=gen,
                    device=card).to(torch.bfloat16)
    y, aux, drops = layers.moe_apply_shmap_with_drops(
        params, x, cfg, make_smoke_mesh(device=card))
    yg, auxg, dg = layers.moe_apply_with_drops(params, x, cfg)
    assert int(drops) == int(dg) == 0
    diff = (y.float() - yg.float())
    assert float(diff.abs().max()) <= 0.25
    assert float(diff.norm() / yg.float().norm()) <= 4e-2
    torch.testing.assert_close(aux, auxg, rtol=1e-5, atol=0)


def test_a_mesh_across_cards_equals_a_virtual_one_for_moe_and_psum(card):
    """A (1, n) mesh over n cards gives moe_apply_shmap's outputs, aux
    and drops bitwise a virtual (1, n) mesh's on one card; an (n, 1)
    mesh gives compressed_psum and psum_with_error_feedback over 'data'
    bitwise a virtual one's. Skips on one card."""
    from dataclasses import replace

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_mesh, virtual_mesh
    from repro_torch.models import layers
    from repro_torch.optim import compression

    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two or more cards")
    axes = ("data", "model")
    cfg = replace(get_arch("kimi-k2-1t-a32b").make_config(False),
                  n_experts=4 * n, moe_dispatch="shmap")
    gen = torch.Generator(device=card)
    gen.manual_seed(7)
    params = layers.moe_init(gen, cfg, device=card)
    x = torch.randn((2, 16, cfg.d_model), generator=gen, device=card)
    got = layers.moe_apply_shmap_with_drops(params, x, cfg,
                                            make_mesh((1, n), axes))
    want = layers.moe_apply_shmap_with_drops(
        params, x, cfg, virtual_mesh((1, n), axes, card))
    for g, w in zip(got, want):
        assert g.device == card and torch.equal(g, w)
    xs = [torch.randn((64, 33), generator=gen, device=card) * (i + 1)
          for i in range(n)]
    rs = [torch.randn((64, 33), generator=gen, device=card) * 1e-3
          for _ in range(n)]
    cards = make_mesh((n, 1), axes)
    virt = virtual_mesh((n, 1), axes, card)
    placed = [x.to(torch.device("cuda", i)) for i, x in enumerate(xs)]
    placed_r = [r.to(torch.device("cuda", i)) for i, r in enumerate(rs)]
    got = compression.compressed_psum(placed, "data", cards)
    want = compression.compressed_psum(xs, "data", virt)
    assert [g.device.index for g in got] == list(range(n))
    assert all(torch.equal(g.to(card), w) for g, w in zip(got, want))
    got = compression.psum_with_error_feedback(placed, placed_r, "data",
                                               cards)
    want = compression.psum_with_error_feedback(xs, rs, "data", virt)
    for gs, ws in zip(got, want):
        assert all(torch.equal(g.to(card), w) for g, w in zip(gs, ws))
