"""The port's serving engine against repro.serving.ServingEngine on the
same mixed streams of lambda-given, KNN, linear and mean requests, both
under a frozen clock (batch composition is then a pure function of the
stream). The JAX engine runs executor='xla' (the use_kernel=False
route) at pipeline_depth=0; the port's runs its 'fused' executor (the
kernels' plain versions on the CPU) and its 'xla' one (the predictor's
predict, then rank_given_lambda; 0 launches a batch).

Per request: perm and compliant match exactly; utility and exposure
within rtol=1e-5, atol=1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import FrozenClock
from repro.core.predictors import KNNLambdaPredictor as JaxKNN
from repro.core.predictors import LinearLambdaPredictor as JaxLinear
from repro.core.predictors import MeanLambdaPredictor as JaxMean
from repro.core.predictors import predictor_state
from repro.serving import RankRequest as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.core.predictors import from_numpy
from repro_torch.serving import buckets
from repro_torch.serving.engine import RankRequest, ServingEngine

RTOL, ATOL = 1e-5, 1e-5
D, K_PRED = 20, 5


def _stream(seed, n_requests, kinds=3):
    """Mixed stream: lambda-given requests (kind 0: K=5, m2=50), KNN
    requests (kind 1: K=5, m2=50; kind 2: K=3, m2=8) and, with kinds=5,
    linear (kind 3: K=5, m2=50) and mean (kind 4: K=3, m2=8) requests,
    m1 jittered; returns request kwargs."""
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n_requests):
        kind = rng.integers(0, kinds)
        m2 = 8 if kind in (2, 4) else 50
        K = 3 if kind in (2, 4) else 5
        m1 = int(rng.integers(max(m2, 200), 513))
        gamma = (1.0 / np.log2(np.arange(2, m2 + 2))).astype(np.float32)
        kw = dict(rid=rid, m2=m2, gamma=gamma,
                  u=rng.uniform(1.0, 5.0, m1).astype(np.float32),
                  a=(rng.random((K, m1)) < 0.15).astype(np.float32),
                  b=np.full(K, 0.06 * gamma.sum(), np.float32))
        if kind == 0:
            kw["lam"] = rng.exponential(0.5, K).astype(np.float32)
        else:
            kw["X"] = rng.normal(size=D).astype(np.float32)
            kw["tag"] = {1: "knn", 2: "knn", 3: "linear", 4: "mean"}[kind]
        out.append(kw)
    return out


def _knn(seed=3, n_db=400):
    rng = np.random.default_rng(seed)
    return JaxKNN.fit(jnp.asarray(rng.normal(size=(n_db, D)), jnp.float32),
                      jnp.asarray(np.abs(rng.normal(size=(n_db, K_PRED))),
                                  jnp.float32), k=10)


def _jax_predictors():
    """KNN over a 400-row db; linear fitted on it, shifted so that some
    predictions clamp; mean fitted on it shifted below 0 on some
    constraints (a negative price the mean route must keep)."""
    jknn = _knn()
    return {"knn": jknn, "knn_int8": jknn.quantized("int8"),
            "knn_bf16": jknn.quantized("bf16"),
            "linear": JaxLinear.fit(jknn.X_db, jknn.lam_db - 0.8),
            "mean": JaxMean.fit(jknn.X_db,
                                jknn.lam_db - jnp.asarray([0.9, 0.0, 0.0,
                                                           0.0, 0.0]))}


def _serve_both(stream, max_batch, tags=("knn",), jpreds=None,
                executor="fused"):
    """Serve `stream` through both engines with the JAX predictors of
    `tags` (from _jax_predictors, or the dict `jpreds`), each carried
    across to the port by from_numpy; the port's engine runs
    `executor`."""
    if jpreds is None:
        jpreds = {t: p for t, p in _jax_predictors().items() if t in tags}
    jeng = JaxEngine(max_batch=max_batch, max_wait_ms=1e9, executor="xla",
                     pipeline_depth=0, clock=FrozenClock())
    for tag, jp in jpreds.items():
        jeng.register_predictor(tag, jp, d_cov=D)
    want = {r.rid: r for r in jeng.serve_stream(
        [JaxRequest(**kw) for kw in stream])}
    eng = ServingEngine(max_batch=max_batch, max_wait_ms=1e9,
                        clock=FrozenClock(), executor=executor, device="cpu")
    for tag, jp in jpreds.items():
        state = {f: ({k: np.asarray(x) for k, x in v.items()}
                     if isinstance(v, dict) else np.asarray(v))
                 for f, v in predictor_state(jp).items()}
        quant = getattr(jp, "quant", "off")
        eng.register_predictor(tag, from_numpy(
            state, k=10, device="cpu",
            quant=None if quant == "off" else quant), d_cov=D)
    got = {r.rid: r for r in eng.serve_stream(
        [RankRequest(**kw) for kw in stream])}
    return eng, got, want


def _assert_streams_match(got, want, n_requests):
    assert sorted(got) == sorted(want) == list(range(n_requests))
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g.perm, np.asarray(w.perm))
        assert g.compliant == w.compliant
        np.testing.assert_allclose(g.utility, w.utility, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(g.exposure, w.exposure, rtol=RTOL,
                                   atol=ATOL)
        assert g.bucket == w.bucket


@pytest.mark.parametrize("max_batch,n_requests,executor", [
    pytest.param(8, 29, "fused", id="8-29"),
    pytest.param(4, 16, "fused", id="4-16"),
    pytest.param(8, 29, "xla", id="8-29-xla"),
    pytest.param(4, 16, "xla", id="4-16-xla")])
def test_engine_matches_jax_engine_on_a_mixed_stream(max_batch, n_requests,
                                                     executor):
    stream = _stream(max_batch, n_requests)
    eng, got, want = _serve_both(stream, max_batch, executor=executor)
    _assert_streams_match(got, want, n_requests)
    m = eng.metrics
    assert m.results == m.requests == n_requests
    assert m.executable_calls == m.batches
    assert m.kernel_launches == 0              # the CPU runs the plain path
    assert m.drain_flushes >= 1 and m.capacity_flushes >= 1
    assert 0.0 < m.summary()["compliance"] <= 1.0


@pytest.mark.parametrize("max_batch,n_requests,executor", [
    pytest.param(8, 41, "fused", id="8-41"),
    pytest.param(4, 23, "fused", id="4-23"),
    pytest.param(8, 41, "xla", id="8-41-xla"),
    pytest.param(4, 23, "xla", id="4-23-xla")])
def test_engine_matches_jax_engine_on_a_four_route_stream(max_batch,
                                                          n_requests,
                                                          executor):
    """KNN, linear, mean and lambda-given requests in one stream. The
    fused executor pads an affine predictor's W and c to each bucket's K
    once; the xla executor runs the predictor's own predict."""
    stream = _stream(100 + max_batch, n_requests, kinds=5)
    assert {kw.get("tag", "_lam") for kw in stream} == {
        "_lam", "knn", "linear", "mean"}
    eng, got, want = _serve_both(stream, max_batch,
                                 tags=("knn", "linear", "mean"),
                                 executor=executor)
    _assert_streams_match(got, want, n_requests)
    assert eng.metrics.kernel_launches == 0     # the CPU runs the plain path
    if executor == "xla":
        assert eng._affine == {}
        return
    affine = {b for b in eng._rings if b.tag in ("linear", "mean")}
    assert set(eng._affine) == affine and affine
    for bucket, (W, c, relu) in eng._affine.items():
        assert W.shape[0] == c.shape[0] == bucket.K
        assert relu == (bucket.tag == "linear")
    held = {b: W for b, (W, _, _) in eng._affine.items()}
    eng.serve_stream([RankRequest(**kw) for kw in stream])
    assert all(eng._affine[b][0] is W for b, W in held.items())


@pytest.mark.parametrize("max_batch,n_requests,executor", [
    pytest.param(8, 29, "fused", id="8-29"),
    pytest.param(4, 16, "fused", id="4-16"),
    pytest.param(8, 29, "xla", id="8-29-xla"),
    pytest.param(4, 16, "xla", id="4-16-xla")])
def test_engine_matches_jax_engine_on_a_quantized_knn_stream(max_batch,
                                                             n_requests,
                                                             executor):
    """KNN requests over the int8 and the bf16 pack of one db, beside
    lambda-given ones."""
    stream = _stream(200 + max_batch, n_requests)
    for i, kw in enumerate(stream):
        if kw.get("tag") == "knn":
            kw["tag"] = ("knn_int8", "knn_bf16")[i % 2]
    assert {kw.get("tag", "_lam") for kw in stream} == {
        "_lam", "knn_int8", "knn_bf16"}
    eng, got, want = _serve_both(stream, max_batch,
                                 tags=("knn_int8", "knn_bf16"),
                                 executor=executor)
    _assert_streams_match(got, want, n_requests)
    assert eng.metrics.kernel_launches == 0     # the CPU runs the plain path
    assert {eng._predictors[t].quant for t in ("knn_int8", "knn_bf16")} == {
        "int8", "bf16"}


def test_bucket_geometry_pads_the_serve_online_cell():
    """serve_online widths (m1=1024, K=5, m2=50) land in the bucket
    (m1 1024, K tier 8, m2 64, batch 32)."""
    bk = buckets.bucket_for(m1=1024, m2=50, K=5, tag="knn", batch=32)
    assert (bk.m1, bk.m2, bk.K, bk.batch) == (1024, 64, 8, 32)
    assert buckets.bucket_for(m1=600, m2=50, K=5, tag="_lam",
                              batch=32).m1 == 1024


def _futures_metrics_and_errors(depth):
    stream = _stream(5, 6)
    eng = ServingEngine(max_batch=4, max_wait_ms=5.0, clock=FrozenClock(),
                        pipeline_depth=depth, device="cpu")
    eng.register_predictor("knn", from_numpy(
        {f: np.asarray(v) for f, v in predictor_state(_knn()).items()},
        k=10, device="cpu"), d_cov=D)
    eng.warmup([RankRequest(**kw) for kw in stream])
    early = []
    for kw in stream:
        early += eng.submit(RankRequest(**kw))
    assert len(early) < 6                          # partial batches wait
    late = eng.poll(now=1.0)                       # past max_wait_ms
    if depth:                                      # retired by the worker
        late += eng.drain()
    assert sorted(r.rid for r in early + late) == list(range(6))
    assert eng.metrics.deadline_flushes >= 1
    with pytest.raises(KeyError):
        eng.bucket_of(RankRequest(**{**stream[1], "tag": "nope",
                                     "lam": None,
                                     "X": np.zeros(D, np.float32)}))
    bad = dict(stream[0], lam=None, X=np.zeros(D, np.float32), tag="knn",
               a=np.zeros((6, stream[0]["u"].shape[0]), np.float32),
               b=np.zeros(6, np.float32))
    with pytest.raises(ValueError, match="shadow prices"):
        eng.submit(RankRequest(**bad))
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(RankRequest(**stream[0]))


def test_futures_metrics_and_errors():
    """Inline retirement (pipeline_depth=0): a deadline flush's results
    come back from the poll that flushed it."""
    _futures_metrics_and_errors(0)


def test_futures_metrics_and_errors_at_depth_1():
    """The same with the pipeline worker: the flushed batch retires on
    the worker, and drain collects it."""
    _futures_metrics_and_errors(1)


def _staging_is_reused_and_results_do_not_alias_it(depth):
    stream = [kw for kw in _stream(9, 24) if "lam" in kw][:8]
    eng = ServingEngine(max_batch=4, max_wait_ms=1e9, clock=FrozenClock(),
                        pipeline_depth=depth, device="cpu")
    res = {r.rid: r for r in eng.serve_stream(
        [RankRequest(**kw) for kw in stream])}
    assert len(eng._rings) == len({eng.bucket_of(RankRequest(**kw))
                                   for kw in stream})
    assert all(ring.allocated == depth + 2 for ring in eng._rings.values())
    again = ServingEngine(max_batch=1, max_wait_ms=1e9, device="cpu",
                          pipeline_depth=depth, clock=FrozenClock())
    for kw in stream:
        (one,) = again.serve_stream([RankRequest(**kw)])
        np.testing.assert_array_equal(one.perm, res[kw["rid"]].perm)
        assert one.utility == res[kw["rid"]].utility


def test_staging_is_reused_and_results_do_not_alias_it():
    _staging_is_reused_and_results_do_not_alias_it(0)


def test_staging_is_reused_and_results_do_not_alias_it_at_depth_1():
    _staging_is_reused_and_results_do_not_alias_it(1)
