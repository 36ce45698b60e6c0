"""The port's mean and linear families and its knn_lambda held against
the JAX XLA oracles: core.ranking.rank_given_lambda on the predictor's
own predict(X), kernels.ref.predict_rank_audited_ref, ref.knn_lambda_ref
and core.predictors.knn_predict, never the Pallas interpret path. The
JAX predictors are carried across with from_numpy.

Tolerances:
  * perm and compliant match exactly; thresholds b are drawn at least
    1e-3 away from exposure - tol;
  * utility and exposure: rtol=1e-5, atol=1e-5;
  * lambda-hat: rtol=1e-5, atol=1e-6 (the port's prologue sums the dot
    over d coordinate by coordinate, XLA in its own order);
  * fitted W, c and mean_lam: rtol=1e-4, atol=1e-5 (a closed-form solve
    and means over the train rows, each reduced in its own order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictors as jax_pred
from repro.core.ranking import AUDIT_TOL
from repro.core.ranking import rank_given_lambda as jax_rank
from repro.kernels import ref as jax_ref
from repro_torch.core import predictors as pred
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_rank import linear_rank_audited_cuda
from repro_torch.kernels.knn_topk import knn_lambda_cuda

RTOL, ATOL = 1e-5, 1e-5
LAM_RTOL, LAM_ATOL = 1e-5, 1e-6
FIT_RTOL, FIT_ATOL = 1e-4, 1e-5
CPU = "cpu"


def _train(seed, n_train, d, K, shift=0.0):
    """Covariates and shadow prices that depend on them, so the ridge
    fit has signal; `shift` moves the prices (a negative shift gives a
    negative mean and clamped linear predictions)."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_train, d)).astype(np.float32)
    M = rng.normal(size=(d, K)).astype(np.float32)
    lam = (0.3 * X @ M + 0.5 + shift +
           0.05 * rng.normal(size=(n_train, K))).astype(np.float32)
    return X, lam, rng


def _fit(family, X_tr, lam_tr):
    cls = (jax_pred.LinearLambdaPredictor if family == "linear" else
           jax_pred.MeanLambdaPredictor)
    return cls.fit(jnp.asarray(X_tr), jnp.asarray(lam_tr))


def _ported(jp):
    state = {f: np.asarray(v) for f, v in jax_pred.predictor_state(jp).items()}
    return pred.from_numpy(state, device=CPU)


def _rank_problem(rng, n, m1, K, m2):
    u = rng.uniform(1.0, 5.0, (n, m1)).astype(np.float32)
    a = (rng.random((n, K, m1)) < 0.15).astype(np.float32)
    gamma = np.ascontiguousarray(np.broadcast_to(
        1.0 / np.log2(np.arange(2, m2 + 2)), (n, m2)).astype(np.float32))
    return u, a, gamma


def _oracle(jp, X, u, a, b, gamma, m2, K):
    """JAX rank_given_lambda on the predictor's own predict(X), lambda
    zero-padded to a's K rows."""
    lam = jp.predict(jnp.asarray(X))
    lam = jnp.pad(lam, ((0, 0), (0, K - lam.shape[-1])))
    out = jax_rank(*(jnp.asarray(x) for x in (u, a, b)), lam,
                   jnp.asarray(gamma), m2=m2)
    return {f: np.asarray(getattr(out, f))
            for f in ("perm", "utility", "exposure", "compliant", "lam")}


def _thresholds(rng, exposure):
    side = np.where(rng.random(exposure.shape) < 0.5, -1.0, 1.0)
    side[::2] = -1.0
    return (exposure + AUDIT_TOL +
            side * rng.uniform(1e-3, 0.3, exposure.shape)).astype(np.float32)


def _assert_matches(got, want, n=None, K=None):
    n = got.perm.shape[0] if n is None else n
    K = got.exposure.shape[1] if K is None else K
    np.testing.assert_array_equal(np.asarray(got.perm[:n]), want["perm"])
    np.testing.assert_array_equal(np.asarray(got.compliant[:n]),
                                  want["compliant"])
    np.testing.assert_allclose(np.asarray(got.utility[:n]), want["utility"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.asarray(got.exposure[:n, :K]),
                               want["exposure"], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.asarray(got.lam[:n, :K]), want["lam"],
                               rtol=LAM_RTOL, atol=LAM_ATOL)


@pytest.mark.parametrize("family", ["mean", "linear"])
@pytest.mark.parametrize("m2,d", [(1, 10), (8, 1), (50, 20), (128, 10),
                                  (8, 20), (50, 1)])
def test_affine_route_matches_xla_oracle(family, m2, d):
    n, m1, K = 12, 256, 5
    X_tr, lam_tr, rng = _train(m2 * 100 + d, 64, d, K)
    jp = _fit(family, X_tr, lam_tr)
    X = rng.normal(size=(n, d)).astype(np.float32)
    u, a, gamma = _rank_problem(rng, n, m1, K, m2)
    probe = _oracle(jp, X, u, a, np.zeros((n, K), np.float32), gamma, m2, K)
    b = _thresholds(rng, probe["exposure"])
    want = _oracle(jp, X, u, a, b, gamma, m2, K)
    assert 0 < want["compliant"].sum() < n
    p = _ported(jp)
    _assert_matches(ops.predict_rank_audited(X, p, u, a, b, gamma, m2=m2,
                                             device=CPU), want)
    jref = [np.asarray(x) for x in jax_ref.predict_rank_audited_ref(
        *(jnp.asarray(x) for x in (X,)), jp,
        *(jnp.asarray(x) for x in (u, a, b, gamma)), m2)]
    t = [torch.tensor(x) for x in (X, u, a, b, gamma)]
    got = ref.predict_rank_audited_ref(t[0], p, *t[1:], m2)
    np.testing.assert_array_equal(got[1].numpy(), jref[1])
    np.testing.assert_array_equal(got[4].numpy(), jref[4])
    for i, (rt, at) in ((2, (RTOL, ATOL)), (3, (RTOL, ATOL)),
                        (5, (LAM_RTOL, LAM_ATOL))):
        np.testing.assert_allclose(got[i].numpy(), jref[i], rtol=rt, atol=at)


def test_negative_mean_is_not_clamped():
    """The mean family broadcasts mean_lam as it is: the relu stays off,
    so a negative mean reaches the ranking negative (the case of
    test_predict_rank.py's mean-family test, held against the XLA
    oracle)."""
    n, m1, K, m2, d = 8, 512, 3, 8, 10
    X_tr, lam_tr, rng = _train(5, 48, d, K, shift=-1.0)
    jp = _fit("mean", X_tr, lam_tr)
    assert bool(jnp.any(jp.mean_lam < 0))
    X = rng.normal(size=(n, d)).astype(np.float32)
    u, a, gamma = _rank_problem(rng, n, m1, K, m2)
    b = rng.uniform(0.0, 1.0, (n, K)).astype(np.float32)
    want = _oracle(jp, X, u, a, b, gamma, m2, K)
    got = ops.predict_rank_audited(X, _ported(jp), u, a, b, gamma, m2=m2,
                                   device=CPU)
    _assert_matches(got, want)
    assert (got.lam < 0).any()
    np.testing.assert_array_equal(
        got.lam.numpy(), np.broadcast_to(np.asarray(jp.mean_lam), (n, K)))


def test_linear_clamp_cuts_negative_predictions():
    n, m1, K, m2, d = 16, 300, 4, 20, 10
    X_tr, lam_tr, rng = _train(7, 80, d, K, shift=-0.5)
    jp = _fit("linear", X_tr, lam_tr)
    X = rng.normal(size=(n, d)).astype(np.float32)
    raw = X @ np.asarray(jp.W).T + np.asarray(jp.c)
    assert (raw < 0).any() and (raw > 0).any()
    u, a, gamma = _rank_problem(rng, n, m1, K, m2)
    b = rng.uniform(0.0, 1.0, (n, K)).astype(np.float32)
    want = _oracle(jp, X, u, a, b, gamma, m2, K)
    got = ops.predict_rank_audited(X, _ported(jp), u, a, b, gamma, m2=m2,
                                   device=CPU)
    _assert_matches(got, want)
    assert (got.lam.numpy()[raw < 0] == 0).all()


@pytest.mark.parametrize("family", ["mean", "linear"])
def test_bucket_padded_batch_keeps_the_answer(family):
    """The engine's padding: phantom rows with X = 0 (their lambda-hat is
    relu(c) or c), NEG_FILL candidates, zero gamma slots, and a K tier
    wider than the predictor (padded rows priced 0): the real rows match
    the unpadded oracle (the case of test_predict_rank.py's padded-batch
    test, held against the XLA oracle)."""
    n, m1, K, m2, d = 5, 300, 3, 20, 10
    X_tr, lam_tr, rng = _train(11, 32, d, K, shift=-0.3)
    jp = _fit(family, X_tr, lam_tr)
    X = rng.normal(size=(n, d)).astype(np.float32)
    u, a, gamma = _rank_problem(rng, n, m1, K, m2)
    b = rng.uniform(0.0, 1.0, (n, K)).astype(np.float32)
    want = _oracle(jp, X, u, a, b, gamma, m2, K)
    N, M1, KP, M2 = 8, 512, 8, 32
    Xp = np.zeros((N, d), np.float32)
    Xp[:n] = X
    up = np.full((N, M1), -1e30, np.float32)
    up[:n, :m1] = u
    ap = np.zeros((N, KP, M1), np.float32)
    ap[:n, :K, :m1] = a
    bp = np.zeros((N, KP), np.float32)
    bp[:n, :K] = b
    gp = np.zeros((N, M2), np.float32)
    gp[:n, :m2] = gamma
    got = ops.predict_rank_audited(Xp, _ported(jp), up, ap, bp, gp, m2=M2,
                                   device=CPU)
    np.testing.assert_array_equal(got.perm[:n, :m2].numpy(), want["perm"])
    _assert_matches(
        type(got)(perm=got.perm[:, :m2], utility=got.utility,
                  exposure=got.exposure, compliant=got.compliant,
                  lam=got.lam), want, n=n, K=K)
    assert not got.lam[:, K:].any()              # padded K priced 0
    c = np.asarray(jp.c if family == "linear" else jp.mean_lam)
    phantom = np.maximum(c, 0) if family == "linear" else c
    np.testing.assert_array_equal(got.lam[n:, :K].numpy(),
                                  np.broadcast_to(phantom, (N - n, K)))


@pytest.mark.parametrize("n_train,d,K", [(64, 1, 1), (200, 20, 5),
                                         (33, 10, 8)])
def test_fits_match_jax(n_train, d, K):
    X_tr, lam_tr, _ = _train(n_train + d, n_train, d, K)
    jl, jm = _fit("linear", X_tr, lam_tr), _fit("mean", X_tr, lam_tr)
    lin = pred.LinearLambdaPredictor.fit(X_tr, lam_tr, device=CPU)
    mean = pred.MeanLambdaPredictor.fit(X_tr, lam_tr, device=CPU)
    for got, want in ((lin.W, jl.W), (lin.c, jl.c),
                      (mean.mean_lam, jm.mean_lam)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=FIT_RTOL, atol=FIT_ATOL)
    X = np.random.default_rng(1).normal(size=(7, d)).astype(np.float32)
    np.testing.assert_allclose(_ported(jl).predict(X).numpy(),
                               np.asarray(jl.predict(jnp.asarray(X))),
                               rtol=LAM_RTOL, atol=LAM_ATOL)
    assert lin.num_constraints == mean.num_constraints == K


def test_state_seam_and_from_numpy_by_family():
    X_tr, lam_tr, _ = _train(3, 40, 6, 4)
    for family in ("mean", "linear"):
        jp = _fit(family, X_tr, lam_tr)
        p = _ported(jp)
        assert isinstance(p, pred.LinearLambdaPredictor if family ==
                          "linear" else pred.MeanLambdaPredictor)
        assert set(pred.predictor_state(p)) == set(
            jax_pred.predictor_state(jp))
        for f, v in pred.predictor_state(p).items():
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(jax_pred.predictor_state(jp)[f]))
        doubled = pred.with_state(
            p, {f: 2 * v for f, v in pred.predictor_state(p).items()})
        assert type(doubled) is type(p)
        with pytest.raises(ValueError, match="state keys"):
            pred.with_state(p, {"nope": 1})
    knn = pred.from_numpy({"X_db": X_tr, "lam_db": lam_tr}, k=5, device=CPU)
    assert pred.with_state(knn, pred.predictor_state(knn)).k == 5
    with pytest.raises(ValueError, match="needs k"):
        pred.from_numpy({"X_db": X_tr, "lam_db": lam_tr}, device=CPU)
    mlp = jax_pred.MLPLambdaPredictor.fit(jnp.asarray(X_tr),
                                          jnp.asarray(lam_tr), num_steps=2)
    p = pred.from_numpy({"params": {k: np.asarray(v) for k, v in
                                    mlp.params.items()}}, device=CPU)
    assert isinstance(p, pred.MLPLambdaPredictor)
    for f, v in p.params.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(mlp.params[f]))
    assert set(pred.predictor_state(p)) == set(
        jax_pred.predictor_state(mlp)) == {"params"}
    with pytest.raises(ValueError, match="name no predictor family"):
        pred.from_numpy({"weights": np.ones(3)}, device=CPU)


@pytest.mark.parametrize("n_db,d,K,k", [(64, 4, 1, 1), (300, 10, 2, 5),
                                        (2100, 20, 5, 10)])
def test_knn_lambda_matches_jax(n_db, d, K, k):
    rng = np.random.default_rng(n_db + d)
    X_db = rng.normal(size=(n_db, d)).astype(np.float32)
    lam_db = np.abs(rng.normal(size=(n_db, K))).astype(np.float32)
    X = rng.normal(size=(16, d)).astype(np.float32)
    X[2] = X_db[n_db - 1]                        # an exact match
    j = [jnp.asarray(x) for x in (X, X_db, lam_db)]
    want_ref = np.asarray(jax_ref.knn_lambda_ref(j[0], j[1], j[2], k))
    want_pred = np.asarray(jax_pred.knn_predict(j[1], j[2], j[0], k=k))
    t = [torch.tensor(x) for x in (X, X_db, lam_db)]
    for got in (ref.knn_lambda_ref(*t, k), ops.knn_lambda(
            X, X_db, lam_db, k=k, device=CPU),
            knn_lambda_cuda(*t, k=k, device=CPU)):
        for want in (want_ref, want_pred):
            np.testing.assert_allclose(got.numpy(), want, rtol=LAM_RTOL,
                                       atol=LAM_ATOL)
        np.testing.assert_array_equal(got[2].numpy(), lam_db[n_db - 1])


@pytest.mark.parametrize("K,K_pred,m2", [(5, 5, 50), (8, 5, 64), (2, 1, 1)])
def test_knn_chain_equals_the_fused_route(K, K_pred, m2):
    rng = np.random.default_rng(K * 10 + m2)
    n, m1 = 9, 400
    X_db = rng.normal(size=(700, 20)).astype(np.float32)
    lam_db = np.abs(rng.normal(size=(700, K_pred))).astype(np.float32)
    knn = pred.KNNLambdaPredictor.fit(X_db, lam_db, k=10, device=CPU)
    X = rng.normal(size=(n, 20)).astype(np.float32)
    u, a, gamma = _rank_problem(rng, n, m1, K, m2)
    b = rng.uniform(0.0, 1.0, (n, K)).astype(np.float32)
    fused = ops.predict_rank_audited(X, knn, u, a, b, gamma, m2=m2,
                                     device=CPU)
    chain = ops.predict_rank_audited(X, knn, u, a, b, gamma, m2=m2,
                                     knn_chain=True, device=CPU)
    for f in ("perm", "utility", "exposure", "compliant", "lam"):
        assert torch.equal(getattr(chain, f), getattr(fused, f)), f
    jknn = jax_pred.KNNLambdaPredictor.fit(jnp.asarray(X_db),
                                           jnp.asarray(lam_db), k=10)
    want = _oracle(jknn, X, u, a, b, gamma, m2, K)
    _assert_matches(chain, want)


def test_linear_wrapper_cpu_path_is_the_plain_version():
    rng = np.random.default_rng(17)
    n, m1, K, m2, d = 6, 256, 4, 16, 7
    u, a, gamma = _rank_problem(rng, n, m1, K, m2)
    b = rng.uniform(0.0, 1.0, (n, K)).astype(np.float32)
    X = rng.normal(size=(n, d)).astype(np.float32)
    W = rng.normal(size=(K, d)).astype(np.float32)
    c = rng.normal(size=(K,)).astype(np.float32)
    t = [torch.tensor(x) for x in (u, a, b, X, W, c, gamma)]
    for relu in (True, False):
        got = linear_rank_audited_cuda(*t, m2=m2, relu=relu, device=CPU)
        want = ref.linear_rank_audited_ref(*t, m2, relu=relu)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert (got[5] < 0).any() != relu


@pytest.mark.parametrize("bad", ["X", "W", "c", "d0"])
def test_linear_wrapper_rejects_what_the_kernel_does_not_take(bad):
    rng = np.random.default_rng(19)
    n, m1, K, m2, d = 2, 64, 2, 8, 3
    u, a, gamma = _rank_problem(rng, n, m1, K, m2)
    t = dict(u=u, a=a, b=np.zeros((n, K), np.float32), gamma=gamma,
             X=np.zeros((n, d), np.float32), W=np.zeros((K, d), np.float32),
             c=np.zeros((K,), np.float32))
    t = {k: torch.tensor(v) for k, v in t.items()}
    if bad == "X":
        t["X"] = t["X"].double()
    elif bad == "W":
        t["W"] = t["W"][:1]
    elif bad == "c":
        t["c"] = t["c"][None]
    else:
        t["X"], t["W"] = t["X"][:, :0], t["W"][:, :0]
    with pytest.raises(ValueError):
        linear_rank_audited_cuda(t["u"], t["a"], t["b"], t["X"], t["W"],
                                 t["c"], t["gamma"], m2=m2, device=CPU)
