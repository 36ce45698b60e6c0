"""The port's entry points on the CPU past the card kernels' shape
limits (K > 32 constraint rows, k > 16 neighbours, d > 256 covariates),
held against the JAX package's XLA routes (`use_kernel=False`,
kernels.ref.knn_topk_ref, core.predictors.knn_predict and its quantized
twin), never the Pallas interpret path. The limits are the kernels'
own: the plain versions the CPU runs take any shape.

Tolerances:
  * perm, idx and compliant match exactly; thresholds b lie at least
    1e-3 away from exposure - tol, and the scores have no near-ties;
  * scores, utility and exposure: rtol=1e-5, atol=1e-5 (the port's
    axpy score and slot-by-slot audit against XLA's einsum and sums);
  * lambda-hat: rtol=1e-5, atol=1e-6 (the distance dot and the weights
    summed in another order than XLA's); squared distances: rtol=1e-5,
    atol=1e-4 (an exact match's d2 is 0 up to the rounding of
    |q|^2 + |x|^2, about 600 at d = 300).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictors as jax_pred
from repro.core.ranking import AUDIT_TOL
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch.core import predictors as pred
from repro_torch.kernels import ops, ref

RTOL, ATOL = 1e-5, 1e-5
LAM_RTOL, LAM_ATOL = 1e-5, 1e-6
CPU = "cpu"


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _problem(seed, n, m1, K, m2):
    rng = np.random.default_rng(seed)
    u = rng.uniform(1.0, 5.0, (n, m1)).astype(np.float32)
    a = (rng.random((n, K, m1)) < 0.15).astype(np.float32)
    gamma = np.ascontiguousarray(np.broadcast_to(
        1.0 / np.log2(np.arange(2, m2 + 2)), (n, m2)).astype(np.float32))
    return rng, u, a, gamma


def _thresholds(rng, exposure):
    side = np.where(rng.random(exposure.shape) < 0.5, -1.0, 1.0)
    side[::2] = -1.0
    return (exposure + AUDIT_TOL +
            side * rng.uniform(1e-3, 0.3, exposure.shape)).astype(np.float32)


def _assert_output(got, want, lam=True):
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    np.testing.assert_array_equal(got.compliant.numpy(),
                                  np.asarray(want.compliant))
    for f in ("utility", "exposure"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=RTOL, atol=ATOL)
    if lam:
        np.testing.assert_allclose(got.lam.numpy(), np.asarray(want.lam),
                                   rtol=LAM_RTOL, atol=LAM_ATOL)


def _ported(jp, **kw):
    state = {f: np.asarray(v) for f, v in jax_pred.predictor_state(jp).items()}
    return pred.from_numpy(state, device=CPU, **kw)


@pytest.mark.parametrize("K", [40, 64])
def test_lambda_given_entry_points_take_any_K(K):
    n, m1, m2 = 3, 200, 10
    rng, u, a, gamma = _problem(K, n, m1, K, m2)
    lam = rng.exponential(0.2, (n, K)).astype(np.float32)
    vals, idx = ops.fused_rank(u, a, lam, m2=m2, device=CPU)
    w_vals, w_idx = jax_ops.fused_rank(*_j(u, a, lam), m2=m2,
                                       use_kernel=False)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))
    np.testing.assert_allclose(vals.numpy(), np.asarray(w_vals), rtol=RTOL,
                               atol=ATOL)
    probe = jax_ops.rank_audited(*_j(u, a, np.zeros((n, K), np.float32),
                                     lam, gamma), m2=m2, use_kernel=False)
    b = _thresholds(rng, np.asarray(probe.exposure))
    want = jax_ops.rank_audited(*_j(u, a, b, lam, gamma), m2=m2,
                                use_kernel=False)
    _assert_output(ops.rank_audited(u, a, b, lam, gamma, m2=m2, device=CPU),
                   want)
    _assert_output(ops.predict_rank_audited(lam, None, u, a, b, gamma, m2=m2,
                                            device=CPU), want)


@pytest.mark.parametrize("family", ["mean", "linear"])
@pytest.mark.parametrize("K", [40, 64])
def test_affine_entry_points_take_any_K(family, K):
    n, m1, m2, d = 4, 200, 10, 12
    rng, u, a, gamma = _problem(K + 7, n, m1, K, m2)
    X_tr = rng.normal(size=(64, d)).astype(np.float32)
    lam_tr = (0.3 * X_tr @ rng.normal(size=(d, K)) + 0.2).astype(np.float32)
    cls = (jax_pred.LinearLambdaPredictor if family == "linear"
           else jax_pred.MeanLambdaPredictor)
    jp = cls.fit(*_j(X_tr, lam_tr))
    X = rng.normal(size=(n, d)).astype(np.float32)
    probe = jax_ops.predict_rank_audited(
        *_j(X), jp, *_j(u, a, np.zeros((n, K), np.float32), gamma), m2=m2,
        use_kernel=False)
    b = _thresholds(rng, np.asarray(probe.exposure))
    want = jax_ops.predict_rank_audited(*_j(X), jp, *_j(u, a, b, gamma),
                                        m2=m2, use_kernel=False)
    p = _ported(jp)
    _assert_output(ops.predict_rank_audited(X, p, u, a, b, gamma, m2=m2,
                                            device=CPU), want)
    W, c, relu = ref.affine_params(p, d, K)
    _assert_output(ops.linear_rank_audited(X, W, c, u, a, b, gamma,
                                           relu=relu, m2=m2, device=CPU),
                   want)
    assert torch.equal(W, p.W) if family == "linear" else not W.any()


@pytest.mark.parametrize("k,d", [(20, 8), (5, 300), (20, 300)])
def test_knn_entry_points_take_any_k_and_d(k, d):
    n, n_db, m1, K, m2 = 6, 400, 256, 5, 20
    rng, u, a, gamma = _problem(k * 1000 + d, n, m1, K, m2)
    X_db = rng.normal(size=(n_db, d)).astype(np.float32)
    lam_db = np.abs(rng.normal(size=(n_db, K))).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[1] = X_db[n_db - 1]                        # an exact match
    d2, idx = ops.knn_topk(X, X_db, k=k, device=CPU)
    w_d2, w_idx = jax_ref.knn_topk_ref(*_j(X, X_db), k)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(w_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(w_d2), rtol=LAM_RTOL,
                               atol=1e-4)
    want_lam = np.asarray(jax_pred.knn_predict(*_j(X_db, lam_db, X), k=k))
    for got in (ops.knn_lambda(X, X_db, lam_db, k=k, device=CPU),
                ops.knn_predict_kernel(X_db, lam_db, X, k=k, device=CPU)):
        np.testing.assert_allclose(got.numpy(), want_lam, rtol=LAM_RTOL,
                                   atol=LAM_ATOL)
    np.testing.assert_array_equal(want_lam[1], lam_db[n_db - 1])
    jknn = jax_pred.KNNLambdaPredictor.fit(*_j(X_db, lam_db), k=k)
    probe = jax_ops.predict_rank_audited(
        *_j(X), jknn, *_j(u, a, np.zeros((n, K), np.float32), gamma), m2=m2,
        use_kernel=False)
    b = _thresholds(rng, np.asarray(probe.exposure))
    want = jax_ops.predict_rank_audited(*_j(X), jknn, *_j(u, a, b, gamma),
                                        m2=m2, use_kernel=False)
    _assert_output(ops.knn_rank_audited(X, X_db, lam_db, u, a, b, gamma, k=k,
                                        m2=m2, device=CPU), want)
    p = _ported(jknn, k=k)
    for chain in (False, True):
        _assert_output(ops.predict_rank_audited(
            X, p, u, a, b, gamma, m2=m2, knn_chain=chain, device=CPU), want)


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_quantized_knn_takes_any_k_and_d(mode):
    """k = 20 keeps 28 survivors and d = 300 is wider than the quantized
    kernel's rows: both past its limits, both served on the CPU."""
    k, d, n, n_db = 20, 300, 5, 700
    rng = np.random.default_rng(11)
    X_db = rng.normal(size=(n_db, d)).astype(np.float32)
    lam_db = np.abs(rng.normal(size=(n_db, 3))).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    jq = jax_pred.KNNLambdaPredictor.fit(*_j(X_db, lam_db), k=k).quantized(
        mode)
    want = np.asarray(jq.predict(jnp.asarray(X)))
    p = _ported(jq, k=k, quant=mode)
    got = ops.knn_lambda(X, X_db, lam_db, k=k, quant=mode, X_q=p.X_q,
                         q_scale=p.q_scale, y2_q=p.y2_q, device=CPU)
    np.testing.assert_allclose(got.numpy(), want, rtol=LAM_RTOL,
                               atol=LAM_ATOL)
    np.testing.assert_allclose(p.predict(X).numpy(), want, rtol=LAM_RTOL,
                               atol=LAM_ATOL)
