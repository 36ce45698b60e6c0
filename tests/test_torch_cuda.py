"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked `cuda`: they skip without one. This file imports no JAX,
so it runs on a machine that has only PyTorch (`--noconftest` skips
tests/conftest.py, which imports JAX):

  PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

The kernels and the plain versions round every operation in the same
order, so every output must match bitwise.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import ranking
from repro_torch.core.predictors import pack_knn_db
from repro_torch.kernels import ops, ref
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
@pytest.mark.parametrize("V,D,nb,bag,weighted", [
    (100_000, 64, 4096, 32, True), (50, 13, 5, 10, False),
    (200, 200, 16, 1, True), (1000, 64, 3, 0, True)])
def test_embedding_bag_kernel_equals_plain(card, dtype, V, D, nb, bag,
                                           weighted):
    rng = np.random.default_rng(V + D)
    table = _t(rng.normal(size=(V, D)), card).to(dtype)
    idx = torch.tensor(rng.integers(-V // 10 - 1, V, (nb, bag)),
                       dtype=torch.int32, device=card)
    w = _t(rng.normal(size=(nb, bag)), card) if weighted else None
    got = embedding_bag_cuda(table, idx, w)
    want = ref.embedding_bag_ref(table, idx, w)
    assert got.dtype == dtype and torch.equal(got, want)


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
