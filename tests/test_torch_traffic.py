"""The port's traffic generators and open-loop load generator against
repro.serving.traffic.

Both packages draw from np.random.default_rng(seed) in the same order,
so u, a, lam, X, m2, tag, surface and the Poisson arrival times match
bitwise. gamma, and b through it, match to rtol=1e-6: XLA's CPU f32
log2 is not correctly rounded, so the discounts can part by two ulps
of the quotient (the dcg_discount hazard pinned below).
serve_open_loop runs on one injected virtual clock and sleep in both
packages, so its stats dicts are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.constraints import dcg_discount as jax_dcg
from repro.data import synthetic as jsyn
from repro.serving import traffic as jtraffic
from repro_torch.core.constraints import dcg_discount
from repro_torch.data import synthetic as syn
from repro_torch.serving import (
    DEFAULT_MIX,
    Scenario,
    ServingEngine,
    make_drift_stream,
    make_stream,
    poisson_arrivals,
    serve_open_loop,
)

RTOL = 1e-6
COV_MIX = (Scenario("feed_knn", m1=300, m2=20, K=5, tag="knn", d_cov=20,
                    weight=2.0, surface="feed"),
           Scenario("notif", m1=120, m2=8, K=3, weight=1.0))


def _assert_requests_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.rid, g.m2, g.tag, g.surface) == (w.rid, w.m2, w.tag,
                                                   w.surface)
        for f in ("u", "a", "lam", "X"):
            gv, wv = getattr(g, f), getattr(w, f)
            assert (gv is None) == (wv is None)
            if gv is not None:
                np.testing.assert_array_equal(gv, wv)
                assert gv.dtype == wv.dtype
        for f in ("gamma", "b"):
            np.testing.assert_allclose(getattr(g, f), getattr(w, f),
                                       rtol=RTOL)
            assert getattr(g, f).dtype == np.float32


@pytest.mark.parametrize("mix,seed", [(DEFAULT_MIX, 0), (DEFAULT_MIX, 7),
                                      (COV_MIX, 3)])
def test_make_stream_matches_jax(mix, seed):
    jmix = tuple(jtraffic.Scenario(**vars(sc)) for sc in mix)
    got = make_stream(mix, n_requests=64, seed=seed)
    want = jtraffic.make_stream(jmix, n_requests=64, seed=seed)
    _assert_requests_match(got, want)
    assert {r.tag for r in got} == {sc.tag for sc in mix}


@pytest.mark.parametrize("kind", ["none", "tighten", "shift", "grow"])
def test_make_drift_stream_matches_jax(kind):
    kw = dict(tag="knn", n_requests=24, m1=200, m2=16, K=4, d_cov=12,
              seed=5)
    got = make_drift_stream(syn.DriftSpec(kind=kind), **kw)
    want = jtraffic.make_drift_stream(jsyn.DriftSpec(kind=kind), **kw)
    _assert_requests_match(got, want)
    with pytest.raises(ValueError, match="covariate streams"):
        make_drift_stream(syn.DriftSpec(kind=kind), tag="_lam")


@pytest.mark.parametrize("qps,seed,start", [(100.0, 0, 0.0),
                                            (2500.0, 11, 1.5)])
def test_poisson_arrivals_match_jax(qps, seed, start):
    got = poisson_arrivals(500, qps, seed=seed, start=start)
    want = jtraffic.poisson_arrivals(500, qps, seed=seed, start=start)
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(got) > 0) and got[0] > start
    with pytest.raises(ValueError, match="qps"):
        poisson_arrivals(8, qps=0.0)


def test_dcg_discount_18_pins_the_ulp_gap_to_jax():
    """The smallest input where the discounts part: slot 18 of
    dcg_discount(18), 1/log2(19). The port rounds each operation
    correctly: its f32 log2(19) is the nearest f32, and its quotient is
    the f32 division of 1 by it. JAX's f32 log2(19) lies one ulp below
    the nearest, so its quotient lies above. Neither quotient is the f32
    nearest to the exact 1/log2(19): that one lies between them, one ulp
    from each. The port's is 0.75 ulp from the exact value, JAX's 1.25,
    two ulps apart."""
    log2_19 = np.float32(np.log2(19.0))                # correctly rounded
    got = dcg_discount(18).numpy()[17]
    assert got == np.float32(1.0) / log2_19
    jax_v = np.asarray(jax_dcg(18), np.float32)[17]
    exact = 1.0 / np.log2(19.0)
    ulp = float(np.spacing(np.float32(exact)))
    nearest = np.float32(exact).view(np.int32)
    assert got.view(np.int32) == nearest - 1
    assert jax_v.view(np.int32) == nearest + 1
    assert abs(float(got) - exact) < ulp < abs(float(jax_v) - exact)
    assert abs(float(jax_v) - exact) < 1.5 * ulp


class _StubEngine:
    """serve_open_loop's engine stand-in on a virtual clock: submit()
    takes `cost_s` of clock time (pure backpressure), and the lag
    samples fed to observe_submission_lag are recorded."""

    def __init__(self, t, cost_s=0.0):
        self.t = t
        self.cost_s = cost_s
        self.fed = []
        self.polls = 0

    def poll(self):
        self.polls += 1
        return []

    def submit(self, req):
        self.t[0] += self.cost_s
        return [req]

    def drain(self):
        return []

    def observe_submission_lag(self, lag_ms):
        self.fed.append(lag_ms)


def _open_loop(serve, cost_s, overshoot_s, arrivals):
    t = [0.0]

    def sleep(dt):
        t[0] += dt + overshoot_s

    eng = _StubEngine(t, cost_s=cost_s)
    results, stats = serve(eng, list(range(len(arrivals))), arrivals,
                            clock=lambda: t[0], sleep=sleep)
    return eng, results, stats


@pytest.mark.parametrize("cost_s,overshoot_s", [(0.0, 0.0), (0.0, 1e-3),
                                                (0.02, 0.0), (4e-3, 5e-4)])
def test_serve_open_loop_stats_equal_jax(cost_s, overshoot_s):
    arrivals = poisson_arrivals(40, 300.0, seed=2)
    eng, results, stats = _open_loop(serve_open_loop, cost_s, overshoot_s,
                                     arrivals)
    jeng, jresults, jstats = _open_loop(jtraffic.serve_open_loop, cost_s,
                                        overshoot_s, arrivals)
    assert stats == jstats
    assert results == jresults == list(range(40))
    assert eng.fed == jeng.fed and eng.polls == jeng.polls


def test_open_loop_pacing_overshoot_is_drift_not_queue_lag():
    """Sleep-granularity overshoot lands in drift_ms; queue_lag_ms stays
    exactly zero, and the engine is fed those zeros."""
    arrivals = 0.01 * np.arange(1, 17)
    eng, _, stats = _open_loop(serve_open_loop, 0.0, 1e-3, arrivals)
    assert stats["queue_lag_ms"]["max"] == 0.0
    assert stats["drift_ms"]["max"] >= 1.0
    assert stats["lag_ms"]["max"] == stats["drift_ms"]["max"]
    assert eng.fed == [0.0] * 16


def test_open_loop_backpressure_is_queue_lag_not_drift():
    """A saturated engine (each submit takes twice the arrival gap)
    accumulates lateness that is pure queueing: it lands in
    queue_lag_ms, grows over the stream, and is what the engine is
    fed."""
    arrivals = 0.01 * np.arange(1, 17)
    eng, _, stats = _open_loop(serve_open_loop, 0.02, 0.0, arrivals)
    assert stats["drift_ms"]["max"] == 0.0
    assert stats["queue_lag_ms"]["last"] > 0.0
    assert stats["queue_lag_ms"]["last"] == stats["queue_lag_ms"]["max"]
    np.testing.assert_allclose(eng.fed, 10.0 * np.arange(16), atol=1e-6)
    assert stats["lag_ms"]["last"] == stats["queue_lag_ms"]["last"]


def test_serve_open_loop_refuses_mismatched_or_empty_streams():
    eng = ServingEngine(max_batch=4, pipeline_depth=0, device="cpu")
    reqs = make_stream(n_requests=3, seed=1)
    with pytest.raises(ValueError, match="arrival times"):
        serve_open_loop(eng, reqs, [0.1, 0.2])
    with pytest.raises(ValueError, match="empty request stream"):
        serve_open_loop(eng, [], [])


@pytest.mark.parametrize("depth", [0, 1])
def test_serve_open_loop_drives_the_engine_on_a_virtual_clock(depth):
    """Every request is submitted at (never before) its arrival and
    comes back; with deadline_budget_s each request carries the absolute
    deadline arrival + budget, and on a clock that only sleep advances
    every one is met."""
    t = [0.0]

    def clock():
        return t[0]

    def sleep(dt):
        t[0] += dt

    reqs = make_stream(COV_MIX[1:], n_requests=24, seed=4)
    arrivals = poisson_arrivals(len(reqs), qps=2000.0, seed=1)
    eng = ServingEngine(max_batch=4, max_wait_ms=0.5, pipeline_depth=depth,
                        clock=clock, device="cpu")
    eng.warmup(reqs)
    results, stats = serve_open_loop(eng, reqs, arrivals, clock=clock,
                                     sleep=sleep, deadline_budget_s=0.05)
    assert sorted(r.rid for r in results) == list(range(24))
    assert stats["wall_s"] >= float(arrivals[-1])
    assert stats["lag_ms"]["mean"] >= 0.0
    assert set(stats["lag_ms"]) == {"mean", "p50", "p99", "max", "last"}
    for r, due in zip(reqs, arrivals):
        assert r.deadline == pytest.approx(due + 0.05)
    assert all(r.deadline_hit for r in results)
    eng.close()


def test_jax_gamma_is_what_the_jax_stream_carries():
    """The rtol above is the discount's alone: the JAX stream's gamma is
    JAX's dcg_discount, the port's the port's."""
    want = jtraffic.make_stream(n_requests=8, seed=9)
    got = make_stream(n_requests=8, seed=9)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(w.gamma,
                                      np.asarray(jax_dcg(w.m2), jnp.float32))
        np.testing.assert_array_equal(g.gamma, dcg_discount(g.m2).numpy())
