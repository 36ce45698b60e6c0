"""The MLP shadow-price predictor of the port (core.predictors.
MLPLambdaPredictor), its route through the dispatcher and the engine,
fit_pipeline(with_mlp=True) and the stateful seam, held against the
JAX package on the same numpy inputs and carried parameters.

Tolerances:
  * apply on carried parameters: rtol=1e-6, atol=1e-6 (softplus as
    jax.nn.softplus computes it, the matmuls summed in their own order);
  * fit from JAX's initial parameters, 300 full-batch Adam steps: the
    loss trace rtol=1e-4, atol=1e-6; lambda-hat atol=2e-3 on values up
    to ~5 (Adam divides each gradient by its running rms, so the ulps
    that XLA's fused multiply-adds leave in a gradient near 0 grow over
    the steps: 7.4e-4 measured here);
  * the route (lambda-hat = predict(X), zero-padded to K, then rank +
    audit) against JAX's XLA route: perm and compliant exact on data
    with no near-ties (utilities on a grid, at most one attribute an
    item, every two scores more than 1e-5 apart: 20x the lambda-hat
    drift) and thresholds at least 1e-3 from the exposure; utility and
    exposure rtol=1e-5, atol=1e-5; lambda-hat rtol=1e-5, atol=1e-6;
  * the stateful seam and the two predictor-state round trips: bitwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictors as jax_pred
from repro.kernels import ops as jax_ops
from repro_torch.core import predictors as pred
from repro_torch.core import ranking
from repro_torch.kernels import ops, ref
from test_torch_engine import _assert_streams_match, _serve_both
from test_torch_shape_limits import _assert_output, _j, _problem, _thresholds

CPU = "cpu"
D, K_PRED, HIDDEN = 20, 5, 16


def _jax_mlp(seed=0, n=200, steps=40):
    """A JAX MLP fitted briefly on covariates X (n, D) with prices that
    depend on X, and the data."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, D)).astype(np.float32)
    W = rng.normal(size=(D, K_PRED)).astype(np.float32)
    lam = np.maximum(X @ W * 0.3 + 0.2, 0.0).astype(np.float32)
    jm = jax_pred.MLPLambdaPredictor.fit(*_j(X, lam), d_hidden=HIDDEN,
                                         num_steps=steps)
    return jm, X, lam


def _carried(params):
    return {k: np.array(v) for k, v in params.items()}


def test_apply_and_from_numpy_match_jax():
    jm, X, _ = _jax_mlp()
    p = pred.from_numpy({"params": _carried(jm.params)}, device=CPU)
    assert isinstance(p, pred.MLPLambdaPredictor)
    assert p.num_constraints == K_PRED and p.device == torch.device(CPU)
    want = np.asarray(jm.predict(jnp.asarray(X)))
    got = p.predict(torch.tensor(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    big = np.float32([[-40.0, -1.0, 0.0, 1.0, 40.0]])   # softplus's range
    np.testing.assert_allclose(pred._softplus(torch.tensor(big)).numpy(),
                               np.asarray(jax.nn.softplus(big)), rtol=1e-6,
                               atol=1e-30)
    assert pred.PREDICTOR_REGISTRY["mlp"] is pred.MLPLambdaPredictor
    assert pred.state_fields(p) == ("params",)
    with pytest.raises(ValueError, match="MLP params"):
        pred.from_numpy({"params": {**_carried(jm.params),
                                    "b2": np.zeros(3)}}, device=CPU)


def test_fit_from_jax_init_follows_jax():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(200, D)).astype(np.float32)
    W = rng.normal(size=(D, K_PRED)).astype(np.float32)
    lam = np.maximum(X @ W * 0.3 + 0.2, 0.0).astype(np.float32)
    p0 = jax_pred.MLPLambdaPredictor.init_params(jax.random.key(0), D, 64,
                                                 K_PRED)
    jm, j_loss = jax_pred.MLPLambdaPredictor.fit(
        *_j(X, lam), num_steps=300, init_params=p0, return_trace=True)
    tm, t_loss = pred.MLPLambdaPredictor.fit(
        X, lam, num_steps=300, init_params=_carried(p0), return_trace=True,
        device=CPU)
    assert t_loss.shape == (300,)
    np.testing.assert_allclose(t_loss.numpy(), np.asarray(j_loss),
                               rtol=1e-4, atol=1e-6)
    assert float(t_loss[-1]) < 0.05 * float(t_loss[0])
    assert np.all(np.diff(t_loss.numpy()[::25]) < 0)
    np.testing.assert_allclose(tm.predict(torch.tensor(X)).numpy(),
                               np.asarray(jm.predict(jnp.asarray(X))),
                               rtol=0.0, atol=2e-3)
    # a fit from the seed: the JAX initialiser's law, its own draws
    a = pred.MLPLambdaPredictor.fit(X, lam, d_hidden=8, num_steps=3,
                                    seed=1, device=CPU)
    b = pred.MLPLambdaPredictor.fit(X, lam, d_hidden=8, num_steps=3,
                                    seed=1, device=CPU)
    assert a.params["w1"].shape == (D, 8)
    assert all(torch.equal(a.params[k], b.params[k]) for k in a.params)


def _grid_problem(rng, n, m1, K):
    """Utilities 1 + 4 i / m1 (each i once a user, in random order) and
    at most one attribute an item, on the first K_PRED rows: two scores
    then part by a grid step or by a difference of two prices."""
    u = np.stack([1.0 + 4.0 * rng.permutation(m1) / m1 for _ in range(n)])
    k = rng.integers(0, 2 * K_PRED, (n, m1))
    a = (k[:, None, :] == np.arange(K)[None, :, None])
    return u.astype(np.float32), a.astype(np.float32)


def _min_gap(u, a, lam):
    """The least distance between two scores u + (1 + eps) lam . a of
    one user."""
    s = u + (1.0 + 1e-4) * np.einsum("nk,nkm->nm", lam, a)
    return np.diff(np.sort(s, axis=1), axis=1).min()


@pytest.mark.parametrize("m2", [50, 500])
def test_route_matches_jax_xla_route(m2, monkeypatch):
    """The MLP route of predict_rank_audited on the CPU (the plain
    version of rank_audited for m2 <= 128, the sort route above it)
    against the JAX dispatcher's XLA route, at a K tier wider than the
    predictor; one rank_audited launch on the card at m2 <= 128, none
    above."""
    n, m1, K = 6, 700, 8
    jm, _, _ = _jax_mlp(seed=m2)
    rng, _, _, gamma = _problem(m2 + 1, n, m1, K, m2)
    u, a = _grid_problem(rng, n, m1, K)
    X = rng.normal(size=(n, D)).astype(np.float32)
    lam = np.pad(np.asarray(jm.predict(jnp.asarray(X))), ((0, 0), (0, 3)))
    assert _min_gap(u, a, lam) > 1e-5
    probe = jax_ops.predict_rank_audited(
        *_j(X), jm, *_j(u, a, np.zeros((n, K), np.float32), gamma), m2=m2,
        use_kernel=False)
    b = _thresholds(rng, np.asarray(probe.exposure))
    want = jax_ops.predict_rank_audited(*_j(X), jm, *_j(u, a, b, gamma),
                                        m2=m2, use_kernel=False)
    p = pred.from_numpy({"params": _carried(jm.params)}, device=CPU)
    assert ops.route_of(p) == "mlp"
    got = ops.predict_rank_audited(X, p, u, a, b, gamma, m2=m2, device=CPU)
    _assert_output(got, want)
    assert not got.lam[:, K_PRED:].any()        # bucket-padded K priced 0
    plain = ref.predict_rank_audited_ref(*[torch.tensor(x) for x in (X,)],
                                         p, *[torch.tensor(x) for x in
                                              (u, a, b, gamma)], m2)
    assert torch.equal(plain[1], got.perm) and torch.equal(plain[5], got.lam)
    assert ops.kernel_launch_count(p, m2) == (1 if m2 <= 128 else 0)
    assert ops.kernel_launch_count(p, m2, device=CPU) == 0


def test_fit_pipeline_with_mlp():
    rng = np.random.default_rng(11)
    n, m1, K, m2 = 40, 120, 3, 10
    X = rng.normal(size=(n, 6)).astype(np.float32)
    u = (3.0 + X @ rng.normal(size=(6, m1)) * 0.5).astype(np.float32)
    a = (rng.random((n, K, m1)) < 0.1).astype(np.float32)
    gamma = 1.0 / np.log2(np.arange(2, m2 + 2))
    b = np.full(K, 0.1 * gamma.sum(), np.float32)
    gamma = gamma.astype(np.float32)
    pipe = ranking.fit_pipeline(X, u, a, b, gamma, m2=m2, num_iters=50,
                                knn_k=5, with_mlp=True, mlp_steps=40,
                                device=CPU)
    assert set(pipe.predictors) == {"mean", "knn", "linear", "mlp"}
    alone = pred.MLPLambdaPredictor.fit(torch.tensor(X), pipe.lam_train,
                                        num_steps=40, device=CPU)
    for k, v in alone.params.items():
        assert torch.equal(pipe.predictors["mlp"].params[k], v)
    kern = ranking.rank_with_strategy(pipe, "mlp", X, u, a, b,
                                      backend="kernel", device=CPU)
    plain = ranking.rank_with_strategy(pipe, "mlp", X, u, a, b,
                                       backend="torch", device=CPU)
    assert torch.equal(kern.perm, plain.perm)
    assert torch.equal(kern.compliant, plain.compliant)
    np.testing.assert_allclose(kern.lam.numpy(), plain.lam.numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("max_batch,n_requests", [(4, 14)])
def test_engines_agree_on_mlp_requests(max_batch, n_requests):
    """MLP requests at m2 = 50 and 500 beside lambda-given ones, through
    the JAX engine (executor='xla') and the port's."""
    jm, _, _ = _jax_mlp(seed=3)
    rng = np.random.default_rng(17)
    stream = []
    for rid in range(n_requests):
        m2 = 500 if rid % 3 == 0 else 50
        m1 = int(rng.integers(max(m2, 300), 700))
        gamma = (1.0 / np.log2(np.arange(2, m2 + 2))).astype(np.float32)
        u, a = _grid_problem(rng, 1, m1, K_PRED)
        kw = dict(rid=rid, m2=m2, gamma=gamma, u=u[0], a=a[0],
                  b=np.full(K_PRED, 0.06 * gamma.sum(), np.float32))
        if rid % 4 == 1:
            kw["lam"] = rng.exponential(0.5, K_PRED).astype(np.float32)
        else:
            kw.update(X=rng.normal(size=D).astype(np.float32), tag="mlp")
        stream.append(kw)
    eng, got, want = _serve_both(stream, max_batch, jpreds={"mlp": jm})
    _assert_streams_match(got, want, n_requests)
    assert isinstance(eng._predictors["mlp"], pred.MLPLambdaPredictor)
    assert {b.m2 for b in eng._rings if b.tag == "mlp"} == {64, 512}
    assert eng.metrics.kernel_launches == 0     # the CPU runs the plain path
    with pytest.raises(ValueError, match="covariates"):
        eng.register_predictor("mlp2", eng._predictors["mlp"], d_cov=D + 1)


def _families():
    rng = np.random.default_rng(5)
    X_db = rng.normal(size=(300, D)).astype(np.float32)
    lam_db = np.abs(rng.normal(size=(300, K_PRED))).astype(np.float32)
    knn = pred.KNNLambdaPredictor.fit(X_db, lam_db, k=5, device=CPU)
    return {"knn": knn, "knn_int8": knn.quantized("int8", device=CPU),
            "linear": pred.LinearLambdaPredictor.fit(X_db, lam_db,
                                                     device=CPU),
            "mean": pred.MeanLambdaPredictor.fit(X_db, lam_db, device=CPU),
            "mlp": pred.MLPLambdaPredictor.fit(X_db, lam_db, d_hidden=8,
                                               num_steps=5, device=CPU)}


@pytest.mark.parametrize("family", ["knn", "knn_int8", "linear", "mean",
                                    "mlp"])
@pytest.mark.parametrize("m2", [16, 300])
def test_stateful_seam_equals_the_dispatcher(family, m2):
    p = _families()[family]
    n, m1, K = 5, 400, 6
    rng, u, a, gamma = _problem(m2, n, m1, K, m2)
    X = rng.normal(size=(n, D)).astype(np.float32)
    b = rng.uniform(0.0, 1.0, (n, K)).astype(np.float32)
    state = pred.predictor_state(p)
    for st, template in ((state, p), (_scaled(state, 2.0), p)):
        got = ops.predict_rank_audited_stateful(st, template, X, u, a, b,
                                                gamma, m2=m2, device=CPU)
        want = ops.predict_rank_audited(X, pred.with_state(p, st), u, a, b,
                                        gamma, m2=m2, device=CPU)
        for f in dataclasses.fields(want):
            assert torch.equal(getattr(got, f.name), getattr(want, f.name))
    with pytest.raises(ValueError, match="state keys"):
        ops.predict_rank_audited_stateful({"nope": 1}, p, X, u, a, b,
                                          gamma, m2=m2, device=CPU)


def _scaled(state, s):
    """Another state of the same structure: float tensors scaled by s
    (a pack's int8 rows kept), the MLP's parameter dict entry by
    entry."""
    def one(v):
        return v * s if v.is_floating_point() else v
    return {k: ({kk: one(vv) for kk, vv in v.items()}
                if isinstance(v, dict) else one(v))
            for k, v in state.items()}
