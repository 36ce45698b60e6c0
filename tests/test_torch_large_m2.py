"""m2 > MAX_KERNEL_M2 (the paper ranks the top 50, 500 and 1000) on every
route of the port, held against the JAX package's XLA route for such
an m2 (kernels.ref.predict_rank_audited_ref, which the JAX dispatcher
and its engine's executor='xla' run): lambda-hat first, then
rank_given_lambda's einsum score, stable sort and audit.

Tolerances: perm and compliant exact (thresholds b at least 1e-3 from
exposure - tol, scores without near-ties); utility and exposure
rtol=1e-5, atol=1e-5; lambda-hat rtol=1e-5, atol=1e-6 (the port's KNN
distance dot and its affine dot summed coordinate by coordinate, XLA's
in its own order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import predictors as jax_pred
from repro.kernels import ops as jax_ops
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_rank import MAX_KERNEL_M2
from test_torch_engine import _assert_streams_match, _serve_both
from test_torch_shape_limits import (
    _assert_output,
    _j,
    _ported,
    _problem,
    _thresholds,
)

CPU = "cpu"
D = 20


def _predictors(rng, n_db, K):
    X_db = rng.normal(size=(n_db, D)).astype(np.float32)
    lam_db = np.abs(rng.normal(size=(n_db, K))).astype(np.float32)
    jknn = jax_pred.KNNLambdaPredictor.fit(*_j(X_db, lam_db), k=10)
    return {"knn": jknn, "knn_int8": jknn.quantized("int8"),
            "knn_bf16": jknn.quantized("bf16"),
            "linear": jax_pred.LinearLambdaPredictor.fit(
                jknn.X_db, jknn.lam_db - 0.8),
            "mean": jax_pred.MeanLambdaPredictor.fit(
                jknn.X_db, jknn.lam_db - 0.9)}


@pytest.mark.parametrize("tag", ["knn", "knn_int8", "knn_bf16", "linear",
                                 "mean"])
def test_dispatcher_routes_m2_500_like_the_xla_route(tag, monkeypatch):
    """predict_rank_audited (KNN fused and chain) at m2 = 500 with a
    K tier wider than the predictor: lambda-hat from the KNN kernel's
    plain version (or the affine prologue's arithmetic), then the sort
    route; no rank kernel wrapper is reached."""
    def refuse(*args, **kw):
        raise AssertionError("a rank kernel wrapper was reached")

    for name in ("rank_audited_cuda", "linear_rank_audited_cuda",
                 "knn_rank_audited_cuda", "knn_rank_audited_quant_cuda"):
        monkeypatch.setattr(ops, name, refuse)
    n, m1, K, K_pred, m2 = 4, 700, 8, 5, 500
    rng, u, a, gamma = _problem(len(tag), n, m1, K, m2)
    jp = _predictors(rng, 300, K_pred)[tag]
    X = rng.normal(size=(n, D)).astype(np.float32)
    probe = jax_ops.predict_rank_audited(
        *_j(X), jp, *_j(u, a, np.zeros((n, K), np.float32), gamma), m2=m2)
    b = _thresholds(rng, np.asarray(probe.exposure))
    want = jax_ops.predict_rank_audited(*_j(X), jp, *_j(u, a, b, gamma),
                                        m2=m2)
    quant = getattr(jp, "quant", "off")
    p = _ported(jp, **({} if tag in ("linear", "mean") else dict(
        k=10, quant=None if quant == "off" else quant)))
    chains = (False, True) if tag.startswith("knn") else (False,)
    for chain in chains:
        got = ops.predict_rank_audited(X, p, u, a, b, gamma, m2=m2,
                                       knn_chain=chain, device=CPU)
        _assert_output(got, want)
        assert not got.lam[:, K_pred:].any()     # bucket-padded K priced 0
    assert ops.kernel_launch_count(p, m2) == (2 if chains[-1] else 0)


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_knn_rank_audited_at_large_m2_returns_lambda_hat_and_guard(quant):
    n, m1, K, m2 = 5, 400, 3, 200
    rng, u, a, gamma = _problem(7, n, m1, K, m2)
    jp = _predictors(rng, 300, K)["knn_int8" if quant == "int8" else "knn"]
    X = rng.normal(size=(n, D)).astype(np.float32)
    b = rng.uniform(0.0, 1.0, (n, K)).astype(np.float32)
    p = _ported(jp, k=10, quant=None if quant == "off" else quant)
    out, guard = ops.knn_rank_audited(
        X, p.X_db, p.lam_db, u, a, b, gamma, k=10, m2=m2, quant=quant,
        X_q=p.X_q, q_scale=p.q_scale, y2_q=p.y2_q, return_guard=True,
        device=CPU)
    lam_hat = ops.knn_lambda(X, p.X_db, p.lam_db, k=10, quant=quant,
                             X_q=p.X_q, q_scale=p.q_scale, y2_q=p.y2_q,
                             device=CPU)
    assert torch.equal(out.lam, lam_hat)
    if quant == "off":
        assert not guard.any()
    else:
        assert torch.equal(guard, ref.knn_lambda_quant_ref(
            torch.tensor(X), p.X_q, p.q_scale, p.y2_q, p.lam_db, 10)[1])
    want = jax_ops.predict_rank_audited(*_j(X), jp, *_j(u, a, b, gamma),
                                        m2=m2)
    _assert_output(out, want)


@pytest.mark.parametrize("max_batch,n_requests", [(4, 18)])
def test_engines_agree_on_an_m2_500_stream(max_batch, n_requests):
    """KNN, int8-KNN, linear and mean requests at m2 = 500 (the engine's
    512 bucket) beside lambda-given ones, through both engines."""
    rng = np.random.default_rng(500)
    tags = ("knn", "knn_int8", "linear", "mean")
    stream = []
    for rid in range(n_requests):
        m1 = int(rng.integers(500, 700))
        gamma = (1.0 / np.log2(np.arange(2, 502))).astype(np.float32)
        kw = dict(rid=rid, m2=500, gamma=gamma,
                  u=rng.uniform(1.0, 5.0, m1).astype(np.float32),
                  a=(rng.random((5, m1)) < 0.15).astype(np.float32),
                  b=np.full(5, 0.06 * gamma.sum(), np.float32))
        kind = rid % 5
        if kind == 4:
            kw["lam"] = rng.exponential(0.5, 5).astype(np.float32)
        else:
            kw.update(X=rng.normal(size=D).astype(np.float32),
                      tag=tags[kind])
        stream.append(kw)
    eng, got, want = _serve_both(stream, max_batch, tags=tags)
    _assert_streams_match(got, want, n_requests)
    assert {b.m2 for b in eng._rings} == {512} and 512 > MAX_KERNEL_M2
    assert eng.metrics.kernel_launches == 0     # the CPU runs the plain path
