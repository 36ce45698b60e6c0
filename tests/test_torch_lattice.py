"""The port's adaptive bucket lattice (repro_torch.serving.lattice and the
engine's lattice seam) against repro.serving's on the same inputs.

The host code (optimize_lattice, padding_waste, ShapeHistogram,
TroughDetector) is held equal to the JAX package's: the same corners,
floats and decisions. The engine and its LatticeLane at pipeline depth 0
and 1 (and with the xla executor at depth 0) serve the lattice gate's two-phase mix (benchmarks/latency_serve.py
LATTICE_MIX_P0/P1) in chunks at a small size against the JAX engine
(executor='xla', depth 0) with its lane: the same corners, swaps and
epochs; per request perm, compliant, bucket and lattice_epoch exact,
utility and exposure within rtol=1e-5, atol=1e-5 (the port's rank sums
in the kernel's order, JAX's in XLA's). Within the port, each chunk is
bitwise what a cold engine built on that chunk's lattice serves.
"""

import sys
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

import repro.serving as jserving
import repro_torch.serving as tserving
from conftest import FrozenClock
from repro.serving import lattice as jlattice
from repro_torch.serving import (
    LAM_TAG,
    Lattice,
    LatticeLane,
    RankRequest,
    Scenario,
    ServingEngine,
    ShapeHistogram,
    TroughDetector,
    make_stream,
    optimize_lattice,
    padding_waste,
)
from repro_torch.serving.lattice import expected_padded_work

RTOL, ATOL = 1e-5, 1e-5
CHUNK, BATCH = 32, 8
# the lattice gate's mixes (benchmarks/latency_serve.py)
MIX_P0 = (Scenario("feed_a", m1=540, m2=10, K=3, weight=4.0, m1_jitter=0.05,
                   surface="feed"),
          Scenario("strip_a", m1=300, m2=8, K=5, weight=2.0, m1_jitter=0.1,
                   surface="strip"),
          Scenario("notif_a", m1=140, m2=6, K=3, weight=1.0,
                   m1_jitter=0.05, surface="notif"))
MIX_P1 = (Scenario("feed_b", m1=1100, m2=12, K=3, weight=4.0,
                   m1_jitter=0.05, surface="feed"),
          Scenario("strip_a", m1=300, m2=8, K=5, weight=2.0, m1_jitter=0.1,
                   surface="strip"))
FIELDS = ("rid", "u", "a", "b", "m2", "lam", "X", "tag", "gamma", "surface")


def _jax_request(r):
    return jserving.RankRequest(**{f: getattr(r, f) for f in FIELDS})


def _corner_tuple(b):
    return (b.tag, b.m1, b.m2, b.K, b.batch)


# ---------------------------------------------------------------------------
# Host code against the JAX package's
# ---------------------------------------------------------------------------

SHAPES = st.tuples(st.integers(8, 2000), st.integers(1, 64),
                   st.integers(1, 32))


@settings(max_examples=40, deadline=None)
@given(st.dictionaries(SHAPES, st.floats(0.1, 10.0), min_size=1,
                       max_size=16),
       st.integers(1, 16), st.sampled_from((1, 4, 8)))
def test_optimize_lattice_and_waste_match_jax(weights, budget, batch):
    weights = {(m1, min(m2, m1), K): w for (m1, m2, K), w in weights.items()}
    got = optimize_lattice(weights, max_executables=budget, batch=batch)
    want = jlattice.optimize_lattice(weights, max_executables=budget,
                                     batch=batch)
    assert got.corners == want.corners
    jl = jlattice.Lattice(corners=want.corners)
    assert padding_waste(got, weights) == jlattice.padding_waste(jl, weights)
    assert padding_waste(Lattice(), weights) == jlattice.padding_waste(
        jlattice.Lattice(), weights)
    assert (expected_padded_work(got, weights, batch=batch, d_cov=20,
                                 n_db=4096)
            == jlattice.expected_padded_work(jl, weights, batch=batch,
                                             d_cov=20, n_db=4096))
    for m1, m2, K in weights:
        for tag in (LAM_TAG, "knn"):
            assert _corner_tuple(got.bucket_for(
                m1=m1, m2=m2, K=K, tag=tag, batch=batch)) == _corner_tuple(
                jl.bucket_for(m1=m1, m2=m2, K=K, tag=tag, batch=batch))


def test_lattice_validation_and_fallback_match_jax():
    for corners in ((), ((128, 8),), ((128, 0, 4),), ((64, 128, 4),)):
        with pytest.raises(ValueError) as got:
            Lattice(corners=corners).validate()
        with pytest.raises(ValueError) as want:
            jlattice.Lattice(corners=corners).validate()
        assert str(got.value) == str(want.value)
    lat = Lattice(corners=((1024, 16, 4), (192, 8, 4), (320, 8, 8)))
    jl = jlattice.Lattice(corners=lat.corners)
    for shape in ((150, 8, 3), (300, 8, 7), (300, 12, 3), (2000, 8, 3)):
        assert lat.covering_corner(*shape) == jl.covering_corner(*shape)
    assert optimize_lattice({}).corners is None
    assert optimize_lattice(ShapeHistogram()).corners is None


def _feed(hist, rng, n=300):
    for _ in range(n):
        hist.observe(tag=("knn", LAM_TAG)[int(rng.integers(2))],
                     m1=int(rng.integers(100, 140)), m2=int(rng.integers(6, 9)),
                     K=int(rng.integers(3, 6)),
                     d_cov=None if rng.random() < 0.5 else 12,
                     surface=("feed", "strip")[int(rng.integers(2))])


def test_histogram_snapshots_equal_and_files_load_across(tmp_path):
    ours, theirs = ShapeHistogram(decay=0.99), jlattice.ShapeHistogram(
        decay=0.99)
    _feed(ours, np.random.default_rng(3))
    _feed(theirs, np.random.default_rng(3))
    assert ours.snapshot() == theirs.snapshot()
    assert ours.shapes() == theirs.shapes()
    assert ours.geometry_weights() == theirs.geometry_weights()
    a, b = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    ours.save(a)
    theirs.save(b)
    assert jlattice.ShapeHistogram.load(a).snapshot() == ours.snapshot()
    assert ShapeHistogram.load(b).snapshot() == theirs.snapshot()
    assert ShapeHistogram.load(str(tmp_path / "absent.json")).total == 0


def test_trough_detector_decisions_match_jax():
    kw = dict(rate_threshold_qps=10.0, lag_threshold_ms=5.0, patience_s=0.3)
    ours, theirs = TroughDetector(**kw), jlattice.TroughDetector(**kw)
    rng = np.random.default_rng(5)
    t, got, want = 0.0, [], []
    for step in range(400):
        t += float(rng.exponential(0.002 if (step // 50) % 2 else 0.4))
        lag = float(rng.uniform(0, 10)) if step % 3 else 0.0
        for det in (ours, theirs):
            det.observe_arrival(t)
            if step % 7 == 0:
                det.observe_lag(lag)
        probe = t + float(rng.uniform(0, 1))
        got.append((ours.in_trough(probe), ours.rate_qps(probe)))
        want.append((theirs.in_trough(probe), theirs.rate_qps(probe)))
    assert got == want
    assert any(g[0] for g in got) and not all(g[0] for g in got)


# ---------------------------------------------------------------------------
# The engine and its lane against the JAX engine's, chunk by chunk
# ---------------------------------------------------------------------------


def _chunks():
    cs = [make_stream(MIX_P0, n_requests=CHUNK, seed=29),
          make_stream(MIX_P0, n_requests=CHUNK, seed=30),
          make_stream(MIX_P1, n_requests=CHUNK, seed=31),
          make_stream(MIX_P1, n_requests=CHUNK, seed=32),
          make_stream(MIX_P1, n_requests=BATCH, seed=33)]
    for i, r in enumerate(r for c in cs[1:] for r in c):
        r.rid = 10_000 + i
    return cs


def _gate(pkg, eng, chunks, convert):
    """The lattice gate's schedule: c0 on the boot lattice, a
    detector-gated re-warm (no trough yet, then a trough), c1, the phase
    shift c2, a second gated re-warm, c3; a poisoned proposal rolled back;
    c4. Returns [(epoch, lattice, results)] a chunk and the lane's
    reports."""
    lane = pkg.LatticeLane(eng, max_executables=8, min_samples=32,
                           detector=pkg.TroughDetector(
                               rate_threshold_qps=50.0, lag_threshold_ms=5.0,
                               patience_s=0.25))
    eng.warmup([convert(r) for c in chunks for r in c])
    served, reports = [], []
    for i, c in enumerate(chunks[:4]):
        got = eng.serve_stream([convert(r) for r in c], warmup=False)
        served.append((eng.lattice_epoch(), eng.lattice(), got))
        if i in (0, 2):
            now = eng.clock()
            reports.append((lane.maybe_rewarm(now + 0.1),
                            lane.maybe_rewarm(now + 1.0)))
    lane.propose = lambda: pkg.Lattice(corners=((64, 128, 4),))  # m2 > m1
    reports.append(lane.rewarm())
    del lane.propose
    got = eng.serve_stream([convert(r) for r in chunks[4]], warmup=False)
    served.append((eng.lattice_epoch(), eng.lattice(), got))
    return served, reports


@pytest.fixture(scope="module")
def jax_gate():
    chunks = _chunks()
    eng = jserving.ServingEngine(max_batch=BATCH, max_wait_ms=1e9,
                                 pipeline_depth=0, clock=FrozenClock())
    served, reports = _gate(jserving, eng, chunks, _jax_request)
    eng.close()
    return chunks, served, reports, eng.metrics


@pytest.mark.parametrize("depth,executor", [
    pytest.param(0, "fused", id="0"), pytest.param(1, "fused", id="1"),
    pytest.param(0, "xla", id="0-xla")])
def test_engine_and_lane_match_jax_on_the_gate_chunks(jax_gate, depth,
                                                      executor):
    chunks, want_served, want_reports, want_m = jax_gate
    eng = ServingEngine(max_batch=BATCH, max_wait_ms=1e9,
                        pipeline_depth=depth, clock=FrozenClock(),
                        executor=executor, device="cpu")
    served, reports = _gate(tserving, eng, chunks, lambda r: r)
    # the same gated decisions, corners and epochs
    for (g_early, g_late), (w_early, w_late) in zip(reports[:2],
                                                    want_reports[:2]):
        assert g_early["reason"] == w_early["reason"] == "no-trough"
        assert g_late["swapped"] and w_late["swapped"]
        assert g_late["corners"] == w_late["corners"]
        assert g_late["epoch"] == w_late["epoch"]
        assert g_late["buckets"] == w_late["buckets"]
    assert not reports[2]["swapped"] and not want_reports[2]["swapped"]
    assert reports[2]["reason"] == want_reports[2]["reason"]
    assert [(e, lat.corners) for e, lat, _ in served] == [
        (e, lat.corners) for e, lat, _ in want_served]
    assert [e for e, _, _ in served] == [0, 1, 1, 2, 2]
    for (_, _, got), (_, _, want) in zip(served, want_served):
        want = {r.rid: r for r in want}
        assert sorted(r.rid for r in got) == sorted(want)
        for r in got:
            w = want[r.rid]
            np.testing.assert_array_equal(r.perm, w.perm)
            assert (r.compliant, r.bucket, r.lattice_epoch) == (
                bool(w.compliant), w.bucket, w.lattice_epoch)
            np.testing.assert_allclose(r.utility, w.utility, rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(r.exposure, w.exposure, rtol=RTOL,
                                       atol=ATOL)
    m = eng.metrics
    for key in ("lattice_swaps", "lattice_rollbacks", "shadow_compiles",
                "compiles", "compiles_post_warmup", "batches",
                "real_flops", "padded_flops"):
        assert getattr(m, key) == getattr(want_m, key), key
    assert m.compiles_post_warmup == 0 and m.lattice_rollbacks == 1
    assert len(eng._rings) == m.compiles + m.shadow_compiles
    # each chunk bitwise a cold engine's on that chunk's lattice
    for (_, lattice, got), chunk in zip(served, chunks):
        cold = ServingEngine(max_batch=BATCH, max_wait_ms=1e9,
                             pipeline_depth=depth, lattice=lattice,
                             executor=executor, device="cpu")
        ref = {r.rid: r for r in cold.serve_stream(chunk)}
        cold.close()
        for r in got:
            w = ref[r.rid]
            np.testing.assert_array_equal(r.perm, w.perm)
            np.testing.assert_array_equal(r.exposure, w.exposure)
            assert (r.utility, r.compliant) == (w.utility, w.compliant)
    eng.close()


# ---------------------------------------------------------------------------
# The swap's refusals and the warm set
# ---------------------------------------------------------------------------


def _engine(depth=0, **kw):
    return ServingEngine(max_batch=4, max_wait_ms=1e9, pipeline_depth=depth,
                         device="cpu", **kw)


def test_swap_refuses_unwarmed_corners_and_rewinds():
    reqs = make_stream(MIX_P0, n_requests=12, seed=3)
    eng = _engine()
    eng.serve_stream(reqs)
    with pytest.raises(ValueError, match="shadow_warm_lattice first"):
        eng.swap_lattice(Lattice(corners=((192, 8, 4), (320, 8, 8),
                                          (576, 16, 4))))
    assert eng.lattice_epoch() == 0 and not eng.lattice().adaptive
    lane = LatticeLane(eng, max_executables=4)
    rep = lane.rewarm()
    assert rep["swapped"] and rep["epoch"] == 1
    with pytest.raises(ValueError, match="monotone"):
        eng.swap_lattice(eng.lattice(), epoch=1)
    assert lane.rewarm()["reason"] == "no-change"
    eng.close()


def test_shadow_warm_grows_the_warm_set_without_routing_there():
    """A shadow warm installs each new corner's ring and call, but the
    live lattice routes as before until the swap; nothing is allocated
    on the dispatch path before or after it."""
    reqs = make_stream(MIX_P0, n_requests=16, seed=4)
    eng = _engine(depth=1)
    eng.serve_stream(reqs)
    rings_before = set(eng._rings)
    new = optimize_lattice(eng.shape_histogram, max_executables=4, batch=4)
    rep = eng.shadow_warm_lattice(new)
    added = set(eng._rings) - rings_before
    assert {b.name for b in added} == set(rep["compiled"]) and added
    assert added <= eng._warmed and added <= set(eng._exec)
    assert eng.lattice_epoch() == 0
    assert all(eng.bucket_of(r) in rings_before for r in reqs)
    assert eng.metrics.shadow_compiles == len(added)
    eng.swap_lattice(new)
    assert all(eng.bucket_of(r) in added for r in reqs)
    for r in reqs:
        r.rid += 100
    got = eng.serve_stream(reqs, warmup=False)
    assert {r.lattice_epoch for r in got} == {1}
    assert eng.metrics.compiles_post_warmup == 0
    eng.close()


def test_shadow_warm_races_the_submitter_without_losing_a_corner():
    """A second thread shadow-warms a learned lattice while the first
    serves at depth 1, with the interpreter switching threads every
    microsecond: every warm bucket ends with its ring, call and launch
    count installed, no corner is built on the dispatch path, and each
    epoch's rows are bitwise a cold engine's on its lattice."""
    first = make_stream(MIX_P0 + MIX_P1, n_requests=96, seed=11)
    second = make_stream(MIX_P0 + MIX_P1, n_requests=48, seed=12)
    for i, r in enumerate(second):
        r.rid = 5000 + i
    eng = _engine(depth=1)
    eng.warmup(first + second)
    eng.serve_stream(first[:32], warmup=False)
    new = optimize_lattice(eng.shape_histogram, max_executables=6, batch=4)
    done = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        lane = threading.Thread(target=lambda: done.update(
            eng.shadow_warm_lattice(new)))
        lane.start()
        got0 = eng.serve_stream(first[32:], warmup=False)
        lane.join(timeout=60.0)
        assert not lane.is_alive() and done["compiled"]
        eng.swap_lattice(new)
        got1 = eng.serve_stream(second, warmup=False)
    finally:
        sys.setswitchinterval(old)
    assert set(eng._warmed) == set(eng._rings) == set(eng._exec) == set(
        eng._launches)
    assert eng.metrics.compiles_post_warmup == 0
    for lattice, reqs, got in ((None, first[32:], got0),
                               (new, second, got1)):
        cold = _engine(lattice=lattice)
        want = {r.rid: r for r in cold.serve_stream(reqs)}
        cold.close()
        assert sorted(r.rid for r in got) == sorted(want)
        for r in got:
            np.testing.assert_array_equal(r.perm, want[r.rid].perm)
            assert (r.utility, r.compliant) == (want[r.rid].utility,
                                                want[r.rid].compliant)
    eng.close()


def test_an_unwarmed_bucket_counts_a_dispatch_path_ring():
    """A request outside the warmed buckets allocates its ring on the
    dispatch path: compiles_post_warmup counts it."""
    warm = make_stream(MIX_P0[:1], n_requests=4, seed=5)
    other = make_stream(MIX_P1[:1], n_requests=4, seed=6)
    eng = _engine()
    eng.warmup(warm)
    assert eng.metrics.compiles_post_warmup == 0
    eng.serve_stream(other, warmup=False)
    assert eng.metrics.compiles_post_warmup == 1
    assert eng.metrics.summary()["compiles_post_warmup"] == 1
    eng.close()


def test_failed_proposal_rolls_back_and_the_stream_goes_on():
    c0 = make_stream(MIX_P0, n_requests=12, seed=7)
    c1 = make_stream(MIX_P0, n_requests=12, seed=8)
    for i, r in enumerate(c1):
        r.rid = 2000 + i
    eng = _engine(depth=1)
    lane = LatticeLane(eng)
    eng.warmup(c0 + c1)
    eng.serve_stream(c0, warmup=False)
    lane.propose = lambda: Lattice(corners=((64, 128, 4),))
    rep = lane.rewarm()
    assert not rep["swapped"] and "rewarm-failed" in rep["reason"]
    assert eng.lattice_epoch() == 0
    assert eng.metrics.summary()["lattice"]["lattice_rollbacks"] == 1
    got = eng.serve_stream(c1, warmup=False)
    assert sorted(r.rid for r in got) == [r.rid for r in c1]
    assert eng.metrics.compiles_post_warmup == 0
    eng.close()


def test_lattice_lane_thread_and_histogram_file(tmp_path):
    path = str(tmp_path / "hist.json")
    reqs = make_stream(MIX_P0, n_requests=16, seed=9)
    eng = _engine()
    lane = LatticeLane(eng, min_samples=4, histogram_path=path,
                       detector=TroughDetector(patience_s=0.0))
    assert lane.maybe_rewarm(0.0)["reason"] == "too-few-samples"
    eng.serve_stream(reqs)
    lane.start(interval_s=0.01)
    for _ in range(500):
        if eng.lattice_epoch() == 1:
            break
        time.sleep(0.01)
    lane.stop()
    assert eng.lattice_epoch() == 1
    assert jlattice.ShapeHistogram.load(path).total == len(reqs)
    eng.close()


def test_requests_carry_the_real_geometry_into_the_histogram():
    rng = np.random.default_rng(10)
    eng = _engine()
    req = RankRequest(rid=0, u=rng.uniform(1, 5, 150).astype(np.float32),
                      a=(rng.random((3, 150)) < 0.3).astype(np.float32),
                      b=np.zeros(3, np.float32), m2=7,
                      lam=np.zeros(3, np.float32), surface="feed")
    eng.serve_stream([req])
    assert eng.shape_histogram.shapes() == [
        (LAM_TAG, "feed", 150, 7, 3, None, 1.0)]
    eng.close()
