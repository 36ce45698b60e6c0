"""The port's KNN predictor and KNN online stage held against the JAX
XLA oracles (core.predictors.knn_predict / knn_predict_chunked,
kernels.ref.predict_rank_audited_ref), never the Pallas interpret path.

Tolerances:
  * lambda-hat: rtol=1e-5, atol=1e-6. The port sums the distance dot
    and the weights in another order than XLA's matrix product.
  * perm and compliant match exactly; utility and exposure:
    rtol=1e-5, atol=1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictors as jax_pred
from repro.kernels import ref as jax_ref
from repro_torch.core import predictors as pred
from repro_torch.kernels import ops, ref
from repro_torch.kernels.knn_topk import knn_rank_audited_cuda

LAM_RTOL, LAM_ATOL = 1e-5, 1e-6
RTOL, ATOL = 1e-5, 1e-5
CPU = "cpu"


def _db(seed, n_db, d, K):
    rng = np.random.default_rng(seed)
    X_db = rng.normal(size=(n_db, d)).astype(np.float32)
    lam_db = np.abs(rng.normal(size=(n_db, K))).astype(np.float32)
    return X_db, lam_db, rng


def _jax_knn(X_db, lam_db, k):
    return jax_pred.KNNLambdaPredictor.fit(jnp.asarray(X_db),
                                           jnp.asarray(lam_db), k=k)


def _ported(jknn):
    state = {f: np.asarray(v)
             for f, v in jax_pred.predictor_state(jknn).items()}
    return pred.from_numpy(state, k=jknn.k, device=CPU)


@pytest.mark.parametrize("n_db,d,K,k", [(64, 4, 1, 1), (300, 10, 2, 5),
                                        (600, 20, 5, 10)])
def test_knn_predict_matches_jax(n_db, d, K, k):
    X_db, lam_db, rng = _db(n_db + d, n_db, d, K)
    X = rng.normal(size=(16, d)).astype(np.float32)
    want = np.asarray(jax_pred.knn_predict(
        jnp.asarray(X_db), jnp.asarray(lam_db), jnp.asarray(X), k=k))
    t = [torch.tensor(x) for x in (X_db, lam_db, X)]
    for got in (pred.knn_predict(*t, k=k),
                ref.knn_lambda_ref(t[2], t[0], t[1], k),
                _ported(_jax_knn(X_db, lam_db, k)).predict(X)):
        np.testing.assert_allclose(got.numpy(), want, rtol=LAM_RTOL,
                                   atol=LAM_ATOL)


@pytest.mark.parametrize("chunk", [64, 100, 1024])
def test_chunked_predict_with_a_ragged_last_chunk(chunk):
    """n_db = 517 divides none of the chunks; the chunked estimator and
    the plain kernel version stream it and agree with the oracle."""
    X_db, lam_db, rng = _db(5, 517, 12, 3)
    X = rng.normal(size=(9, 12)).astype(np.float32)
    want = np.asarray(jax_pred.knn_predict_chunked(
        jnp.asarray(X_db), jnp.asarray(lam_db), jnp.asarray(X), k=10,
        chunk=chunk))
    t = [torch.tensor(x) for x in (X_db, lam_db, X)]
    got = pred.knn_predict_chunked(*t, k=10, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, rtol=LAM_RTOL,
                               atol=LAM_ATOL)
    _, idx_jax = jax_pred.knn_topk_scan(jnp.asarray(X_db), jnp.asarray(X),
                                        k=10, chunk=chunk)
    _, idx = pred.knn_topk_scan(t[0], t[2], k=10, chunk=chunk,
                                d2_fn=ref.d2_sequential,
                                x2=ref.sq_norm_seq(t[2])[:, None])
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_jax))


def test_duplicate_rows_tie_to_the_lowest_index():
    X_db, lam_db, rng = _db(9, 200, 6, 2)
    X_db[150:] = X_db[:50]                       # exact duplicates
    X = X_db[[3, 40]] + 0.01 * rng.normal(size=(2, 6)).astype(np.float32)
    # k=5 splits a tied pair at the boundary: its lower index stays
    _, want = jax_ref.knn_topk_ref(jnp.asarray(X), jnp.asarray(X_db), 5)
    want = np.asarray(want)
    t = torch.tensor(X)
    for chunk in (32, 200):
        _, got = pred.knn_topk_scan(torch.tensor(X_db), t, k=5,
                                    chunk=chunk, d2_fn=ref.d2_sequential,
                                    x2=ref.sq_norm_seq(t)[:, None])
        np.testing.assert_array_equal(got.numpy(), want)
    for row in want:
        for j, i in enumerate(row):
            if i >= 150:                         # a twin follows its original
                assert row[j - 1] == i - 150
    assert (want[:, -1] < 150).all()


def test_query_equal_to_a_db_row_returns_its_lambda():
    X_db, lam_db, rng = _db(11, 600, 20, 5)
    X = rng.normal(size=(4, 20)).astype(np.float32)
    X[1], X[3] = X_db[17], X_db[599]
    t = [torch.tensor(x) for x in (X_db, lam_db, X)]
    for got in (pred.knn_predict(*t, k=10),
                ref.knn_lambda_ref(t[2], t[0], t[1], 10)):
        np.testing.assert_array_equal(got[1].numpy(), lam_db[17])
        np.testing.assert_array_equal(got[3].numpy(), lam_db[599])


def test_from_numpy_carries_the_jax_predictor_across():
    X_db, lam_db, rng = _db(13, 400, 20, 5)
    jknn = _jax_knn(X_db, lam_db, 10)
    knn = _ported(jknn)
    np.testing.assert_array_equal(knn.X_db.numpy(), X_db)
    np.testing.assert_array_equal(knn.lam_db.numpy(), lam_db)
    assert knn.k == 10 and knn.device == torch.device("cpu")
    assert set(pred.predictor_state(knn)) == set(
        jax_pred.predictor_state(jknn))
    X = rng.normal(size=(8, 20)).astype(np.float32)
    np.testing.assert_allclose(knn.predict(X).numpy(),
                               np.asarray(jknn.predict(jnp.asarray(X))),
                               rtol=LAM_RTOL, atol=LAM_ATOL)
    jquant = jknn.quantized("int8")
    quant = {f: np.asarray(v) for f, v in jax_pred.predictor_state(
        jquant).items()}
    qknn = pred.from_numpy(quant, k=10, device=CPU)
    assert qknn.quant == "int8" and qknn.X_q.dtype == torch.int8
    np.testing.assert_array_equal(qknn.X_q.numpy(), quant["X_q"])
    np.testing.assert_array_equal(qknn.q_scale.numpy(), quant["q_scale"])
    np.testing.assert_allclose(qknn.predict(X).numpy(),
                               np.asarray(jquant.predict(jnp.asarray(X))),
                               rtol=LAM_RTOL, atol=LAM_ATOL)


def _stage(seed, *, n, m1, K, K_pred, m2, n_db=600, d=20):
    X_db, lam_db, rng = _db(seed, n_db, d, K_pred)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[0] = X_db[5]                               # one exact match
    u = rng.uniform(1.0, 5.0, (n, m1)).astype(np.float32)
    a = (rng.random((n, K, m1)) < 0.15).astype(np.float32)
    gamma = np.broadcast_to(
        1.0 / np.log2(np.arange(2, m2 + 2)), (n, m2)).astype(np.float32)
    gamma = np.ascontiguousarray(gamma)
    return X_db, lam_db, X, u, a, gamma, rng


def _jax_stage(jknn, X, u, a, b, gamma, m2):
    out = jax_ref.predict_rank_audited_ref(
        jnp.asarray(X), jknn, *(jnp.asarray(x) for x in (u, a, b, gamma)),
        m2)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("n,m1,K,K_pred,m2", [
    (4, 64, 1, 1, 8), (16, 700, 5, 5, 50), (8, 1024, 8, 5, 128),
    (5, 1024, 2, 2, 1)])
def test_predict_rank_audited_matches_xla_oracle(n, m1, K, K_pred, m2):
    X_db, lam_db, X, u, a, gamma, rng = _stage(
        n + m1, n=n, m1=m1, K=K, K_pred=K_pred, m2=m2)
    jknn = _jax_knn(X_db, lam_db, 10)
    probe = _jax_stage(jknn, X, u, a, np.zeros((n, K), np.float32), gamma,
                       m2)
    side = np.where(rng.random((n, K)) < 0.5, -1.0, 1.0)
    side[::2] = -1.0
    b = (probe[3] + 1e-6 + side * rng.uniform(1e-3, 0.3, (n, K))
         ).astype(np.float32)
    _, idx, util, expo, comp, lam = _jax_stage(jknn, X, u, a, b, gamma, m2)
    got = ops.predict_rank_audited(X, _ported(jknn), u, a, b, gamma, m2=m2,
                                   device=CPU)
    np.testing.assert_array_equal(got.perm.numpy(), idx)
    np.testing.assert_array_equal(got.compliant.numpy(), comp)
    np.testing.assert_allclose(got.utility.numpy(), util, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.exposure.numpy(), expo, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.lam.numpy(), lam, rtol=LAM_RTOL,
                               atol=LAM_ATOL)
    assert not got.lam[:, K_pred:].any()         # bucket-padded K priced 0


def test_bucket_padded_batch_keeps_the_answer():
    """Phantom rows (zero covariates, NEG_FILL utilities), padded m1, m2
    and K, the engine's way: the real rows match the unpadded oracle."""
    n, m1, K, m2 = 5, 300, 3, 20
    X_db, lam_db, X, u, a, gamma, rng = _stage(31, n=n, m1=m1, K=K,
                                               K_pred=K, m2=m2)
    b = rng.uniform(0.0, 1.0, (n, K)).astype(np.float32)
    jknn = _jax_knn(X_db, lam_db, 10)
    _, idx, util, expo, comp, lam = _jax_stage(jknn, X, u, a, b, gamma, m2)
    N, M1, KP, M2 = 8, 512, 4, 32
    Xp = np.zeros((N, 20), np.float32)
    Xp[:n] = X
    up = np.full((N, M1), -1e30, np.float32)
    up[:n, :m1] = u
    ap = np.zeros((N, KP, M1), np.float32)
    ap[:n, :K, :m1] = a
    bp = np.zeros((N, KP), np.float32)
    bp[:n, :K] = b
    gp = np.zeros((N, M2), np.float32)
    gp[:n, :m2] = gamma
    got = ops.knn_rank_audited(Xp, torch.tensor(X_db), torch.tensor(lam_db),
                               up, ap, bp, gp, k=10, m2=M2, device=CPU)
    np.testing.assert_array_equal(got.perm[:n, :m2].numpy(), idx)
    np.testing.assert_array_equal(got.compliant[:n].numpy(), comp)
    np.testing.assert_allclose(got.utility[:n].numpy(), util, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.exposure[:n, :K].numpy(), expo,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.lam[:n, :K].numpy(), lam,
                               rtol=LAM_RTOL, atol=LAM_ATOL)


def test_wrong_covariate_row_count_is_loud():
    X_db, lam_db, X, u, a, gamma, _ = _stage(37, n=4, m1=64, K=2, K_pred=2,
                                             m2=8)
    knn = pred.KNNLambdaPredictor.fit(X_db, lam_db, k=10, device=CPU)
    b = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError, match="covariate rows"):
        ops.predict_rank_audited(X[:3], knn, u, a, b, gamma, m2=8,
                                 device=CPU)
    with pytest.raises(ValueError, match="covariate rows"):
        ops.knn_rank_audited(X[:3], knn.X_db, knn.lam_db, u, a, b, gamma,
                             k=10, m2=8, device=CPU)
    with pytest.raises(ValueError, match="shadow prices"):
        ops.knn_rank_audited(X, knn.X_db, knn.lam_db, u, a[:, :1], b[:, :1],
                             gamma, k=10, m2=8, device=CPU)


def test_wrapper_cpu_path_is_the_plain_version():
    X_db, lam_db, X, u, a, gamma, rng = _stage(41, n=6, m1=256, K=4,
                                               K_pred=3, m2=16)
    b = rng.uniform(0.0, 1.0, (6, 4)).astype(np.float32)
    t = [torch.tensor(x) for x in (X, X_db, lam_db, u, a, b, gamma)]
    got = knn_rank_audited_cuda(*t, k=10, m2=16, device=CPU)
    want = ref.knn_rank_audited_ref(*t, k=10, m2=16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
