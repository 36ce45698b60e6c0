"""The port's async pipeline: its engine at pipeline_depth 0, 1 and 2
(and its xla executor at 0 and 1) against repro.serving.ServingEngine
(executor='xla', pipeline_depth=0) on a mixed stream, and the pipeline's lifetime rules, as
tests/test_serving_pipeline.py holds the JAX engine to them.

Both engines run on a frozen clock with max_wait_ms far away, so batch
composition is a pure function of the stream. Per request: perm and
compliant exact, bucket equal; utility and exposure within rtol=1e-5,
atol=1e-5 (test_torch_engine.py's tolerance: the port's rank sums in
the kernel's order, JAX's in XLA's). Between the port's own depths
every output is bitwise equal: the pipeline only changes when a batch
retires.
"""

import sys
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jcore
import repro.serving as jserving
from conftest import FrozenClock
from repro.core.predictors import KNNLambdaPredictor as JaxKNN
from repro.core.predictors import predictor_state
from repro.serving import RankRequest as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.core.predictors import (
    KNNLambdaPredictor,
    MeanLambdaPredictor,
    from_numpy,
)
from repro_torch.core.ranking import RankingOutput
from repro_torch.serving import (
    AdmissionController,
    ExecutionPipeline,
    PendingBatch,
    RankFuture,
    RankRequest,
    Scenario,
    ServingEngine,
    Shed,
    StagingRing,
    alloc_staging,
    assemble_batch,
    bucket_for,
    fill_staging,
    make_stream,
    unpad_result,
)

RTOL, ATOL = 1e-5, 1e-5
D, K = 12, 5
MIX = (Scenario("feed", m1=500, m2=50, K=K, weight=3.0, tag="knn", d_cov=D),
       Scenario("strip", m1=1000, m2=20, K=3, weight=2.0),
       Scenario("notif", m1=120, m2=8, K=3, weight=1.0))


def _jax_knn(seed=4):
    rng = np.random.default_rng(seed)
    return JaxKNN.fit(jnp.asarray(rng.normal(size=(64, D)), jnp.float32),
                      jnp.asarray(np.abs(rng.normal(size=(64, K))),
                                  jnp.float32), k=5)


def _port_knn(jknn):
    return from_numpy({f: np.asarray(v) for f, v in
                       predictor_state(jknn).items()}, k=5, device="cpu")


def _tiny_request(rid, m1=64, m2=8, K=2):
    rng = np.random.default_rng(rid)
    return RankRequest(
        rid=rid, u=rng.uniform(1, 5, m1).astype(np.float32),
        a=(rng.random((K, m1)) < 0.3).astype(np.float32),
        b=np.zeros(K, np.float32), m2=m2, lam=np.zeros(K, np.float32),
        gamma=(1.0 / np.log2(np.arange(2, m2 + 2))).astype(np.float32))


def _engine(depth, max_batch=4, **kw):
    kw.setdefault("max_wait_ms", 1e9)
    return ServingEngine(max_batch=max_batch, pipeline_depth=depth,
                         device="cpu", **kw)


# ---------------------------------------------------------------------------
# Against the JAX engine, at every depth
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_served():
    """The mixed stream and the JAX engine's results on it."""
    reqs = make_stream(MIX, n_requests=48, seed=4)
    jknn = _jax_knn()
    jeng = JaxEngine(max_batch=8, max_wait_ms=1e9, executor="xla",
                     pipeline_depth=0, clock=FrozenClock())
    jeng.register_predictor("knn", jknn, d_cov=D)
    want = {r.rid: r for r in jeng.serve_stream([JaxRequest(**{
        f: getattr(r, f) for f in ("rid", "u", "a", "b", "m2", "lam", "X",
                                   "tag", "gamma", "surface")})
        for r in reqs])}
    return reqs, jknn, want


@pytest.fixture(scope="module")
def port_served(jax_served):
    """The port's engine on the stream, by (depth, executor): fused at
    depths 0, 1 and 2, xla at 0 and 1."""
    reqs, jknn, _ = jax_served
    out = {}
    for depth, executor in ((0, "fused"), (1, "fused"), (2, "fused"),
                            (0, "xla"), (1, "xla")):
        eng = ServingEngine(max_batch=8, max_wait_ms=1e9, clock=FrozenClock(),
                            pipeline_depth=depth, executor=executor,
                            device="cpu")
        eng.register_predictor("knn", _port_knn(jknn), d_cov=D)
        out[depth, executor] = (eng, {r.rid: r for r in
                                      eng.serve_stream(reqs)})
        eng.close()
    return out


@pytest.mark.parametrize("depth,executor", [
    pytest.param(0, "fused", id="0"), pytest.param(1, "fused", id="1"),
    pytest.param(2, "fused", id="2"), pytest.param(0, "xla", id="0-xla"),
    pytest.param(1, "xla", id="1-xla")])
def test_engine_matches_jax_engine_at_every_depth(jax_served, port_served,
                                                  depth, executor):
    reqs, _, want = jax_served
    eng, got = port_served[depth, executor]
    assert sorted(got) == sorted(want) == list(range(len(reqs)))
    assert {r.tag for r in reqs} == {"knn", "_lam"}
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g.perm, np.asarray(w.perm))
        assert g.compliant == w.compliant
        assert g.bucket == w.bucket
        assert g.deadline_hit is w.deadline_hit is True
        assert (g.rung, g.epoch) == (w.rung, w.epoch) == (0, 0)
        np.testing.assert_allclose(g.utility, w.utility, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(g.exposure, w.exposure, rtol=RTOL,
                                   atol=ATOL)
    s = eng.metrics.summary()
    assert s["dispatches_per_batch"] == 1.0
    assert s["results"] == s["requests"] == len(reqs)
    assert s["kernel_launches"] == 0            # the CPU runs the plain path
    assert len(eng.metrics.exec_ms) == len(eng.metrics.queue_depth) \
        == s["batches"]
    assert max(eng.metrics.queue_depth) <= depth


@pytest.mark.parametrize("depth,executor", [
    pytest.param(1, "fused", id="1"), pytest.param(2, "fused", id="2"),
    pytest.param(1, "xla", id="1-xla")])
def test_depths_agree_bitwise(port_served, depth, executor):
    _, ref = port_served[0, executor]
    _, got = port_served[depth, executor]
    for rid, r in ref.items():
        g = got[rid]
        np.testing.assert_array_equal(g.perm, r.perm)
        np.testing.assert_array_equal(g.exposure, r.exposure)
        assert (g.utility, g.compliant, g.bucket) == (r.utility, r.compliant,
                                                       r.bucket)


def test_summary_keys_equal_jax(port_served):
    """Every key of the JAX engine's summary, nested ones included."""
    eng, _ = port_served[1, "fused"]
    got = eng.metrics.summary()
    want = JaxEngine(max_batch=4, pipeline_depth=0).metrics.summary()

    def keys(d):
        return {k: keys(v) if isinstance(v, dict) and k != "surfaces"
                and k != "rungs" else None for k, v in d.items()}

    assert keys(got) == keys(want)


# ---------------------------------------------------------------------------
# Futures
# ---------------------------------------------------------------------------


def test_futures_resolve_to_their_own_request(jax_served, port_served):
    reqs, jknn, _ = jax_served
    _, ref = port_served[0, "fused"]
    eng = ServingEngine(max_batch=8, max_wait_ms=1e9, pipeline_depth=2,
                        device="cpu")
    eng.register_predictor("knn", _port_knn(jknn), d_cov=D)
    eng.warmup(reqs)
    futures = [eng.submit_future(r) for r in reqs]
    eng.drain()
    assert all(f.done() for f in futures)
    for req, fut in zip(reqs, futures):
        res = fut.result(timeout=5.0)
        assert fut.rid == req.rid == res.rid
        np.testing.assert_array_equal(res.perm, ref[req.rid].perm)
        assert res.bucket == fut.bucket_name
    eng.close()


def test_futures_within_a_bucket_resolve_in_dispatch_order():
    eng = _engine(2)
    order, futures = [], []
    for i in range(12):
        fut = eng.submit_future(_tiny_request(i))
        fut.add_done_callback(lambda f: order.append(f.rid))
        futures.append(fut)
    eng.drain()
    assert order == list(range(12))
    eng.close()


def test_future_result_blocks_until_drain_and_late_callbacks_fire():
    eng = _engine(2)
    fut = eng.submit_future(_tiny_request(0))
    assert not fut.done()                       # queued, not even flushed
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.01)
    eng.drain()
    assert fut.result(timeout=5.0).rid == 0
    fired = []
    fut.add_done_callback(lambda f: fired.append(f.rid))
    assert fired == [0]
    eng.close()


# ---------------------------------------------------------------------------
# Drain, close, reuse
# ---------------------------------------------------------------------------


def test_drain_retires_all_inflight_batches():
    eng = _engine(2)
    collected = []
    for i in range(19):                         # 4 full flushes + 3 queued
        collected += eng.submit(_tiny_request(i))
    collected += eng.drain()
    assert sorted(r.rid for r in collected) == list(range(19))
    assert eng.metrics.capacity_flushes == 4
    assert eng.metrics.drain_flushes == 1
    eng.close()


def test_close_is_graceful_and_idempotent():
    with _engine(2) as eng:
        futures = [eng.submit_future(_tiny_request(i)) for i in range(10)]
    assert all(f.done() for f in futures)       # queued ones flushed too
    assert eng._pipeline._worker is None        # the worker stopped
    eng.close()                                 # second close: no-op
    with pytest.raises(RuntimeError, match="closed"):
        eng._pipeline.submit(None)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(_tiny_request(99))


def test_engine_reusable_after_drain():
    eng = _engine(2)
    out1 = sum([eng.submit(_tiny_request(i)) for i in range(4)], [])
    out1 += eng.drain()
    out2 = sum([eng.submit(_tiny_request(i)) for i in range(4, 8)], [])
    out2 += eng.drain()
    assert sorted(r.rid for r in out1) == [0, 1, 2, 3]
    assert sorted(r.rid for r in out2) == [4, 5, 6, 7]
    eng.close()


def test_handoff_queued_fails_queued_futures_and_returns_requests():
    eng = _engine(1)
    futures = [eng.submit_future(_tiny_request(i)) for i in range(6)]
    evicted = eng.handoff_queued()
    assert [r.rid for r in evicted] == [4, 5]   # 0-3 flushed at capacity
    for fut in futures[4:]:
        with pytest.raises(RuntimeError, match="handoff"):
            fut.result(timeout=1.0)
    assert sorted(r.rid for r in eng.drain()) == [0, 1, 2, 3]
    eng.close()


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------


def test_retire_error_fails_futures_and_surfaces_on_flush():
    boom = RuntimeError("retire exploded")

    def bad_materialize(pending):
        raise boom

    bucket = bucket_for(m1=64, m2=8, K=2, tag="_lam", batch=4)
    ring = StagingRing(bucket, d_cov=None, depth=1, device="cpu")
    staged = ring.acquire()
    pipe = ExecutionPipeline(depth=1)
    fut = RankFuture(0, "b")
    pipe.submit(PendingBatch(bucket=bucket, entries=[], futures=[fut],
                             out=None, staged=staged, ring=ring,
                             t_launch=0.0, trigger="drain",
                             materialize=bad_materialize, build=None))
    with pytest.raises(RuntimeError, match="retire exploded"):
        pipe.flush()
    with pytest.raises(RuntimeError, match="retire exploded"):
        fut.result(timeout=5.0)
    assert ring.acquire() is staged             # recycled, not leaked
    pipe.close()
    with pytest.raises(ValueError, match="depth"):
        ExecutionPipeline(depth=0)


def _inject(eng, *, delay_s=0.0, fail_on=()):
    """Wrap the engine's dispatch: a delay before every batch and a
    failure on the listed flushes (counted from 0)."""
    orig, calls = eng._dispatch, []

    def faulty(bucket, ring, staged):
        i = len(calls)
        calls.append(i)
        if delay_s:
            time.sleep(delay_s)
        if i in fail_on:
            raise RuntimeError(f"injected fault at flush {i}")
        return orig(bucket, ring, staged)

    eng._dispatch = faulty
    return calls


@pytest.mark.parametrize("depth", [0, 1])
def test_dispatch_failure_fails_futures_and_recycles_the_ring(depth):
    reqs = [_tiny_request(i) for i in range(12)]
    eng = _engine(depth)
    eng.warmup(reqs)
    _inject(eng, fail_on={0})
    futures = [eng.submit_future(r) for r in reqs[:3]]
    with pytest.raises(RuntimeError, match="injected fault"):
        eng.submit_future(reqs[3])              # capacity flush -> boom
    for fut in futures:
        assert fut.done()
        with pytest.raises(RuntimeError, match="injected fault"):
            fut.result(timeout=1.0)
    out = sum([eng.submit(r) for r in reqs[4:]], []) + eng.drain()
    assert sorted(r.rid for r in out) == list(range(4, 12))
    ring = eng._rings[eng.bucket_of(reqs[0])]
    assert ring._free.qsize() == ring.allocated == depth + 2
    eng.close()


def test_injected_delays_with_midflight_sheds_never_deadlock():
    """Slow flushes in flight and sheds on top: drain completes, every
    future resolves exactly once, and the served/shed split is exact."""
    eng = ServingEngine(max_batch=4, max_wait_ms=2.0, pipeline_depth=2,
                        admission=True, device="cpu")
    reqs = [_tiny_request(i) for i in range(16)]
    eng.warmup(reqs)
    _inject(eng, delay_s=0.02)
    fired = {r.rid: 0 for r in reqs}
    futures = []
    for i, r in enumerate(reqs):
        r.budget_s = 10.0 if i < 8 else 1e-4    # generous, then impossible
        fut = eng.submit_future(r)
        fut.add_done_callback(lambda f: fired.__setitem__(
            f.rid, fired[f.rid] + 1))
        futures.append(fut)
    drained = []
    t = threading.Thread(target=lambda: drained.extend(eng.drain()))
    t.start()
    t.join(timeout=30.0)
    assert not t.is_alive()
    assert all(f.done() for f in futures)
    assert all(n == 1 for n in fired.values())
    served = [x for x in drained if not isinstance(x, Shed)]
    sheds = [x for x in drained if isinstance(x, Shed)]
    assert sorted(x.rid for x in served) == list(range(8))
    assert sorted(x.rid for x in sheds) == list(range(8, 16))
    assert eng.metrics.sheds == 8 and eng.metrics.results == 8
    for fut, shed in zip(futures[8:], sorted(sheds, key=lambda s: s.rid)):
        assert fut.result(timeout=1.0) is shed
    eng.close()


@pytest.mark.parametrize("depth", [0, 1])
def test_admission_noninterference_at_zero_load(depth):
    """With headroom to spare, admission changes nothing: every output
    bitwise the admission-off engine's, no shed, no degrade."""
    rng = np.random.default_rng(7)
    d, Kc = 8, 3
    knn = KNNLambdaPredictor.fit(
        rng.normal(size=(32, d)).astype(np.float32),
        np.abs(rng.normal(size=(32, Kc))).astype(np.float32), k=3,
        device="cpu")
    mean = MeanLambdaPredictor.fit(
        np.zeros((4, d), np.float32),
        np.abs(rng.normal(size=(4, Kc))).astype(np.float32), device="cpu")
    mix = (Scenario("feed", m1=200, m2=16, K=Kc, weight=2.0, tag="knn",
                    d_cov=d),
           Scenario("notif", m1=120, m2=8, K=Kc, weight=1.0))
    reqs = make_stream(mix, n_requests=48, seed=8)

    def build(admission):
        eng = ServingEngine(max_batch=8, max_wait_ms=2.0,
                            pipeline_depth=depth, admission=admission,
                            default_budget_s=10.0, device="cpu")
        eng.register_predictor("knn", knn, d_cov=d)
        eng.register_predictor("mean", mean, d_cov=d)
        eng.set_degradation_ladder("knn", ["mean"])
        return eng

    ref = {r.rid: r for r in build(None).serve_stream(reqs)}
    eng = build(AdmissionController())
    got = {r.rid: r for r in eng.serve_stream(reqs)}
    assert eng.metrics.sheds == 0 and eng.metrics.degrades == 0
    assert sorted(got) == sorted(ref)
    for rid, r in ref.items():
        g = got[rid]
        assert not isinstance(g, Shed) and g.rung == 0
        np.testing.assert_array_equal(g.perm, r.perm)
        np.testing.assert_array_equal(g.exposure, r.exposure)
        assert (g.utility, g.compliant, g.bucket) == (r.utility, r.compliant,
                                                       r.bucket)
    eng.close()


# ---------------------------------------------------------------------------
# Buffers
# ---------------------------------------------------------------------------


def test_staging_ring_blocks_when_exhausted_and_recycles():
    bucket = bucket_for(m1=64, m2=8, K=2, tag="_lam", batch=4)
    ring = StagingRing(bucket, d_cov=None, depth=2, device="cpu")
    assert ring.allocated == 2 and ring.reuses == 0
    b1, b2 = ring.acquire(), ring.acquire()
    assert b1 is not b2
    slot = ring.slot(b1)
    assert slot.event is None                   # the CPU records none
    assert set(slot.inputs) == set(b1) == {"u", "a", "b", "gamma", "lam"}
    assert slot.outputs["perm"].shape == (4, 8)
    assert slot.outputs["exposure"].shape == slot.outputs["lam"].shape \
        == (4, 4)
    assert np.shares_memory(slot.host["u"].numpy(), b1["u"])
    grabbed = []
    t = threading.Thread(target=lambda: grabbed.append(ring.acquire()))
    t.start()
    t.join(timeout=0.05)
    assert t.is_alive() and not grabbed         # exhausted: acquire blocks
    ring.release(b1)
    t.join(timeout=5.0)
    assert not t.is_alive() and grabbed == [b1]
    assert ring.reuses == 1 and ring.allocated == 2
    with pytest.raises(AssertionError, match="never allocated"):
        ring.release(alloc_staging(bucket, device="cpu"))


def test_staging_buffers_are_not_rewritten_while_in_flight():
    """Back-to-back flushes of one bucket at depth 2 use distinct slots,
    and the ring recycles a bounded set."""
    seen = []
    eng = _engine(2, max_batch=2)
    orig = eng._materialize_batch

    def spy(pending):
        seen.append(id(pending.staged["u"]))
        return orig(pending)

    eng._materialize_batch = spy
    for i in range(8):                          # 4 back-to-back flushes
        eng.submit(_tiny_request(i))
    eng.drain()
    assert len(seen) == 4
    assert len(set(seen[:2])) == 2
    assert len(set(seen)) <= eng.pipeline_depth + 2
    eng.close()


@pytest.mark.parametrize("depth", [0, 1])
def test_results_do_not_alias_recycled_buffers(depth):
    """A result held across later batches of its bucket keeps its
    values, and shares memory with no slot of the ring."""
    eng = _engine(depth)
    first = eng.serve_stream([_tiny_request(i) for i in range(4)])
    held = {r.rid: (r.perm.copy(), r.exposure.copy()) for r in first}
    eng.serve_stream([_tiny_request(i) for i in range(100, 116)],
                     warmup=False)
    (ring,) = eng._rings.values()
    assert ring.reuses > 0
    for r in first:
        np.testing.assert_array_equal(r.perm, held[r.rid][0])
        np.testing.assert_array_equal(r.exposure, held[r.rid][1])
        for slot in ring._slots.values():
            for buf in (*slot.outputs.values(), *slot.staged.values()):
                assert not np.shares_memory(r.perm, buf)
                assert not np.shares_memory(r.exposure, buf)
    eng.close()


def test_unpad_result_copies():
    out = RankingOutput(perm=np.arange(12).reshape(2, 6),
                        utility=np.ones(2, np.float32),
                        exposure=np.ones((2, 4), np.float32),
                        compliant=np.ones(2, bool), lam=None)
    perm, utility, exposure, compliant = unpad_result(
        out, 1, _tiny_request(0, m1=64, m2=5, K=3))
    np.testing.assert_array_equal(perm, [6, 7, 8, 9, 10])
    assert exposure.shape == (3,) and utility == 1.0 and compliant is True
    assert not np.shares_memory(perm, out.perm)
    assert not np.shares_memory(exposure, out.exposure)


def test_staging_on_the_cpu_is_plain_and_the_card_is_the_default():
    bucket = bucket_for(m1=64, m2=8, K=2, tag="knn", batch=4)
    staged = alloc_staging(bucket, d_cov=D, device="cpu")
    assert staged["X"].shape == (4, D) and staged["u"].dtype == np.float32
    assert all(isinstance(v, np.ndarray) for v in staged.values())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        alloc_staging(bucket, d_cov=D)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServingEngine()


def _full_request(rid, m1, m2, K, d_cov=None):
    """A request whose every field is nonzero where it is written."""
    rng = np.random.default_rng(100 + rid)
    return RankRequest(
        rid=rid, u=rng.uniform(1, 5, m1).astype(np.float32),
        a=rng.uniform(0.1, 1, (K, m1)).astype(np.float32),
        b=rng.uniform(0.1, 1, K).astype(np.float32), m2=m2,
        lam=None if d_cov else rng.uniform(0.1, 1, K).astype(np.float32),
        X=rng.normal(size=d_cov).astype(np.float32) if d_cov else None)


@pytest.mark.parametrize("d_cov", [None, D])
def test_a_refilled_staging_equals_a_fresh_one(d_cov):
    """A ring slot refilled batch after batch (wider, narrower, empty,
    after a fill that raised) holds the same bytes as fresh staging
    packed with the same requests: only the last fill's rows are reset,
    and the padding identity holds everywhere else."""
    bucket = bucket_for(m1=256, m2=32, K=8, tag="knn", batch=4)
    staged = alloc_staging(bucket, d_cov=d_cov, device="cpu")
    wide = [_full_request(i, 256, 32, 8, d_cov) for i in range(4)]
    narrow = [_full_request(10 + i, 130, 9, 5, d_cov) for i in range(2)]
    bad = [_full_request(20, 200, 20, 6, d_cov),
           _full_request(21, 300, 20, 6, d_cov)]      # m1 past the bucket
    steps = [wide, narrow, [], wide, narrow, bad, narrow, [wide[3]]]
    for reqs in steps:
        if reqs is bad:
            with pytest.raises(ValueError):
                fill_staging(staged, reqs, bucket)
            continue
        fill_staging(staged, reqs, bucket)
        fresh = assemble_batch(reqs, bucket, d_cov=d_cov, device="cpu")
        assert staged.keys() == fresh.keys()
        for k in fresh:
            np.testing.assert_array_equal(staged[k], fresh[k], err_msg=k)


def test_pending_batch_carries_the_dispatch_record():
    eng = _engine(1)
    seen = []
    orig = eng._materialize_batch

    def spy(pending):
        seen.append(pending)
        return orig(pending)

    eng._materialize_batch = spy
    eng.serve_stream([_tiny_request(i) for i in range(6)])
    assert [p.trigger for p in seen] == ["capacity", "drain"]
    for p in seen:
        assert p.staged is None and p.ring is not None  # recycled
        assert p.event is None and p.epoch == 0
        assert p.assembly_ms >= 0.0 and p.dispatch_ms >= 0.0
        assert p.fill["padded_cells"] == 4 * 128   # m1 floor MIN_M1
        assert p.depth_at_dispatch in (0, 1)
        assert isinstance(p.out.perm, np.ndarray)
    eng.close()


def test_worker_and_submitter_share_metrics_without_lost_updates():
    """A short thread switch interval and more consumer threads than
    cores, building results while the worker retires: no count is
    lost."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        eng = _engine(2, max_batch=4)
        futures = [eng.submit_future(_tiny_request(i % 7))
                   for i in range(96)]
        consumers = [threading.Thread(target=lambda fs=futures[j::12]: [
            f.result(timeout=30.0) for f in fs]) for j in range(12)]
        for c in consumers:
            c.start()
        eng.drain()
        for c in consumers:
            c.join(timeout=30.0)
        assert not any(c.is_alive() for c in consumers)
        m = eng.metrics
        assert m.results == 96 and len(m.latencies_ms) == 96
        assert len(m.exec_ms) == m.batches == 24
        assert m.deadline_hits + m.deadline_misses == 96
        eng.close()
    finally:
        sys.setswitchinterval(old)


# ---------------------------------------------------------------------------
# Exports
# ---------------------------------------------------------------------------


def test_exports_are_jax_names():
    import repro_torch.core as core
    import repro_torch.serving as serving

    assert set(serving.__all__) <= set(jserving.__all__)
    for name in serving.__all__:
        assert getattr(serving, name) is not None
    for name in core.__all__:
        assert getattr(core, name) is not None
        assert hasattr(jcore, name), name
    for name in ("ServingEngine", "ExecutionPipeline", "StagingRing",
                 "AdmissionController", "Shed", "make_stream",
                 "poisson_arrivals", "serve_open_loop"):
        assert name in serving.__all__
    for name in ("fit_pipeline", "rank_with_strategy", "KNNLambdaPredictor"):
        assert name in core.__all__
