"""The port's admission controller and the engine's deadlines, sheds,
degrades and surface budgets, against repro.serving.

The controller is plain Python over numpy in both packages: one
sequence of observe_service / observe_lag / observe_result / decide
calls gives equal decisions and equal state. The engine-level cases
mirror tests/test_admission.py on the port's engine (device="cpu"; the
shed and degrade cases with its fused and its xla executor) and hold
its outcomes (served or shed, rung, bucket, perm, compliant) to
the JAX engine's (executor="xla", pipeline_depth=0) on the same stream,
both on a frozen clock, so admission sees the same EWMAs.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from conftest import FrozenClock
from repro.core.predictors import KNNLambdaPredictor as JaxKNN
from repro.core.predictors import MeanLambdaPredictor as JaxMean
from repro.serving import AdmissionController as JaxController
from repro.serving import RankRequest as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro.serving import Shed as JaxShed
from repro_torch.core.predictors import (
    KNNLambdaPredictor,
    MeanLambdaPredictor,
)
from repro_torch.serving import (
    SHED_RUNG,
    AdmissionController,
    Scenario,
    ServingEngine,
    Shed,
    make_stream,
)

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # pragma: no cover - hypothesis is in the dev deps
    given = None

D, K = 8, 4


# ---------------------------------------------------------------------------
# The controller against JAX's
# ---------------------------------------------------------------------------


def _drive(ctrl, seed):
    """One seeded sequence of every kind of controller call; returns the
    decisions and the state the calls left."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(400):
        op = rng.integers(0, 4)
        if op == 0:
            ctrl.observe_service(f"b{rng.integers(0, 3)}",
                                 float(rng.exponential(3.0)))
        elif op == 1:
            ctrl.observe_lag(float(rng.exponential(5.0)))
        elif op == 2:
            ctrl.observe_result(float(rng.exponential(40.0)),
                                float(rng.choice([0.0, 50.0])))
        else:
            preds = [(r, ctrl.predict_ms(
                f"b{r}", queue_len=int(rng.integers(0, 32)), batch_cap=32,
                inflight=int(rng.integers(0, 3)), max_wait_ms=2.0))
                for r in range(int(rng.integers(1, 4)))]
            d = ctrl.decide(budget_ms=float(rng.uniform(1.0, 60.0)),
                            rung_predictions=preds)
            out.append((d.action, d.rung, d.predicted_ms, d.budget_ms))
    state = (ctrl.lag_ms, ctrl.default_rung, ctrl.rung_shifts,
             ctrl.decisions, dict(ctrl._exec_ms))
    return out, state


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, dict(p99_window=8, p99_patience=1)),
    (2, dict(headroom=0.5, ewma_alpha=0.6, p99_window=4, p99_patience=2,
             p99_hysteresis=0.9))])
def test_controller_decisions_equal_jax(seed, kw):
    got = _drive(AdmissionController(**kw), seed)
    want = _drive(JaxController(**kw), seed)
    assert got == want
    assert {a for a, *_ in got[0]} >= {"admit"}


if given is not None:

    @settings(max_examples=50, deadline=None)
    @given(st.floats(0, 100), st.floats(0, 50), st.integers(0, 64),
           st.integers(0, 8), st.floats(0.5, 50))
    def test_predict_ms_is_monotone_in_load(lag, exec_ms, q, inflight, wait):
        ctrl = AdmissionController()
        ctrl.observe_lag(lag)
        ctrl.observe_service("b", exec_ms)
        p = ctrl.predict_ms("b", queue_len=q, batch_cap=16,
                            inflight=inflight, max_wait_ms=wait)
        assert ctrl.predict_ms("b", queue_len=q + 1, batch_cap=16,
                               inflight=inflight, max_wait_ms=wait) >= p
        assert ctrl.predict_ms("b", queue_len=q, batch_cap=16,
                               inflight=inflight + 1, max_wait_ms=wait) >= p
        ctrl.observe_lag(lag + 100.0)
        assert ctrl.predict_ms("b", queue_len=q, batch_cap=16,
                               inflight=inflight, max_wait_ms=wait) >= p

    @settings(max_examples=50, deadline=None)
    @given(st.floats(1.0, 200.0), st.floats(0.1, 30.0), st.integers(1, 64),
           st.integers(0, 4))
    def test_admitted_at_depth_q_admitted_below_q(budget_ms, exec_ms, q,
                                                  inflight):
        """No admit/shed flapping as a queue drains."""
        ctrl = AdmissionController()
        ctrl.observe_service("b", exec_ms)

        def decision_at(depth):
            pred = ctrl.predict_ms("b", queue_len=depth, batch_cap=16,
                                   inflight=inflight, max_wait_ms=2.0)
            return ctrl.decide(budget_ms=budget_ms,
                               rung_predictions=[(0, pred)])

        if decision_at(q).admitted:
            assert all(decision_at(d).admitted for d in range(q))

    @settings(max_examples=50, deadline=None)
    @given(st.lists(st.floats(0.1, 50.0), min_size=1, max_size=5),
           st.floats(1.0, 100.0),
           st.lists(st.floats(0.0, 200.0), min_size=2, max_size=6))
    def test_chosen_rung_is_monotone_in_lag(base_ms, budget_ms, lags):
        """Load only pushes down the ladder (shed is the bottom)."""
        ctrl = AdmissionController()
        base = sorted(base_ms, reverse=True)

        def rung_at(lag):
            preds = [(i, b + lag) for i, b in enumerate(base)]
            d = ctrl.decide(budget_ms=budget_ms, rung_predictions=preds)
            return len(base) if d.rung == SHED_RUNG else d.rung

        chosen = [rung_at(lag) for lag in sorted(lags)]
        assert chosen == sorted(chosen)


def test_controller_validates_parameters():
    with pytest.raises(ValueError, match="headroom"):
        AdmissionController(headroom=0.0)
    with pytest.raises(ValueError, match="ewma_alpha"):
        AdmissionController(ewma_alpha=1.5)
    with pytest.raises(ValueError, match="p99_window"):
        AdmissionController(p99_window=0)
    with pytest.raises(ValueError, match="p99_patience"):
        AdmissionController(p99_patience=0)
    with pytest.raises(ValueError, match="p99_hysteresis"):
        AdmissionController(p99_hysteresis=1.0)
    with pytest.raises(ValueError, match="at least rung 0"):
        AdmissionController().decide(budget_ms=50, rung_predictions=[])


def test_decide_first_fit_tallies_and_ewma():
    ctrl = AdmissionController(headroom=1.0)
    d = ctrl.decide(budget_ms=10, rung_predictions=[(0, 5.0), (1, 1.0)])
    assert (d.action, d.rung, d.admitted) == ("admit", 0, True)
    d = ctrl.decide(budget_ms=10, rung_predictions=[(0, 50.0), (1, 1.0)])
    assert (d.action, d.rung) == ("degrade", 1)
    d = ctrl.decide(budget_ms=10, rung_predictions=[(0, 50.0), (1, 20.0)])
    assert (d.action, d.rung, d.predicted_ms) == ("shed", SHED_RUNG, 20.0)
    assert ctrl.decisions == {"admit": 1, "degrade": 1, "shed": 1}
    ctrl = AdmissionController(ewma_alpha=0.5, prior_exec_ms=7.0)
    assert ctrl.service_ms("unseen") == 7.0
    ctrl.observe_service("b", 10.0)
    ctrl.observe_service("b", 20.0)
    assert ctrl.service_ms("b") == 15.0


def _feed_window(ctrl, ratio, n=None):
    for _ in range(n or ctrl.p99_window):
        ctrl.observe_result(ratio * 100.0, 100.0)


def test_p99_tracker_patience_hysteresis_and_floor():
    ctrl = AdmissionController(p99_window=8, p99_patience=2,
                               p99_hysteresis=0.7)
    _feed_window(ctrl, 2.0)
    assert ctrl.default_rung == 0               # patience not yet met
    _feed_window(ctrl, 2.0)
    assert ctrl.default_rung == 1
    d = ctrl.decide(budget_ms=100, rung_predictions=[(0, 1.0), (1, 2.0)])
    assert (d.action, d.rung) == ("degrade", 1)  # the floor skips rung 0
    for _ in range(10):                         # the hysteresis band
        _feed_window(ctrl, 0.85)
    assert ctrl.default_rung == 1
    _feed_window(ctrl, 0.3)
    _feed_window(ctrl, 0.3)
    assert ctrl.default_rung == 0 and ctrl.rung_shifts[-1][0] == "up"
    spiky = AdmissionController(p99_window=8, p99_patience=3)
    for _ in range(20):                         # spike, recover, ...
        _feed_window(spiky, 5.0)
        _feed_window(spiky, 0.2)
    assert spiky.default_rung == 0 and spiky.rung_shifts == []
    deep = AdmissionController(p99_window=4, p99_patience=1)
    for _ in range(6):
        _feed_window(deep, 3.0)
    d = deep.decide(budget_ms=100, rung_predictions=[(0, 1.0), (1, 2.0)])
    assert deep.default_rung == 6 and (d.action, d.rung) == ("degrade", 1)
    unbudgeted = AdmissionController(p99_window=2, p99_patience=1)
    for _ in range(64):
        unbudgeted.observe_result(500.0, 0.0)
    assert unbudgeted.default_rung == 0 and unbudgeted._ratio_win == []


# ---------------------------------------------------------------------------
# The engine: deadlines, sheds, degrades, surface budgets
# ---------------------------------------------------------------------------


def _fits(seed=0):
    rng = np.random.default_rng(seed)
    X_db = rng.normal(size=(32, D)).astype(np.float32)
    lam_db = np.abs(rng.normal(size=(32, K))).astype(np.float32)
    mean_lam = np.abs(rng.normal(size=(4, K))).astype(np.float32)
    return X_db, lam_db, mean_lam


def _engines(**kw):
    """The port's engine and the JAX engine, each with a KNN predictor
    degrading to a mean predictor, on frozen clocks (so warmup seeds
    the admission EWMAs to exactly 0 ms in both), and a KNN stream."""
    X_db, lam_db, mean_lam = _fits()
    ctrl = kw.pop("admission", None)
    executor = kw.pop("executor", "fused")
    eng = ServingEngine(max_batch=4, max_wait_ms=2.0, clock=FrozenClock(),
                        device="cpu", admission=ctrl and ctrl(),
                        executor=executor, **kw)
    eng.register_predictor("knn", KNNLambdaPredictor.fit(
        X_db, lam_db, k=5, device="cpu"), d_cov=D)
    eng.register_predictor("mean", MeanLambdaPredictor.fit(
        np.zeros((4, D), np.float32), mean_lam, device="cpu"), d_cov=D)
    eng.set_degradation_ladder("knn", ["mean"])
    kw.pop("pipeline_depth", None)
    jeng = JaxEngine(max_batch=4, max_wait_ms=2.0, clock=FrozenClock(),
                     executor="xla", pipeline_depth=0,
                     admission=ctrl and JaxController(), **kw)
    jeng.register_predictor("knn", JaxKNN.fit(
        jnp.asarray(X_db), jnp.asarray(lam_db), k=5), d_cov=D)
    jeng.register_predictor("mean", JaxMean.fit(
        jnp.zeros((4, D), jnp.float32), jnp.asarray(mean_lam)), d_cov=D)
    jeng.set_degradation_ladder("knn", ["mean"])
    mix = (Scenario("s", m1=200, m2=16, K=K, tag="knn", d_cov=D),)
    return eng, jeng, make_stream(mix, n_requests=8, seed=1)


def _as_jax(reqs):
    return [JaxRequest(**{f: getattr(r, f) for f in (
        "rid", "u", "a", "b", "m2", "lam", "X", "tag", "gamma",
        "deadline", "budget_s", "surface")}) for r in reqs]


def _assert_outcomes_match(got, want):
    got = {r.rid: r for r in got}
    want = {r.rid: r for r in want}
    assert sorted(got) == sorted(want)
    for rid, w in want.items():
        g = got[rid]
        assert isinstance(g, Shed) == isinstance(w, JaxShed)
        assert g.rung == w.rung
        if isinstance(g, Shed):
            assert g.bucket == w.bucket
            continue
        assert g.bucket == w.bucket
        np.testing.assert_array_equal(g.perm, np.asarray(w.perm))
        assert g.compliant == w.compliant
        assert g.deadline_hit == w.deadline_hit


def test_deadline_tracking_without_admission():
    """On a frozen clock zero time elapses: every served result is a
    deadline hit against the 50 ms default budget."""
    eng = ServingEngine(max_batch=4, pipeline_depth=0, clock=FrozenClock(),
                        device="cpu")
    res = eng.serve_stream(make_stream(n_requests=8, seed=2))
    assert all(r.deadline_hit is True and r.rung == 0 for r in res)
    m = eng.metrics
    assert m.deadline_hits == len(res) and m.deadline_misses == 0
    assert m.sheds == 0 and m.degrades == 0
    assert eng.metrics.deadline_summary()["hit_rate"] == 1.0


@pytest.mark.parametrize("depth", [0, 1])
def test_absolute_deadline_wins_over_budget(depth):
    """On a ticking clock (1 ms a read) a 1 ns budget has expired by the
    time the batch is home: a hit can only come from the absolute
    deadline winning."""
    for Engine, Request, kw in (
            (ServingEngine, lambda r: r, dict(device="cpu",
                                              pipeline_depth=depth)),
            (JaxEngine, lambda r: _as_jax([r])[0], dict(pipeline_depth=0))):
        eng = Engine(max_batch=4, clock=FrozenClock(tick=1e-3), **kw)
        req = Request(make_stream(n_requests=1, seed=3)[0])
        req.deadline, req.budget_s = 1e9, 1e-9
        assert eng.serve_stream([req], warmup=True)[0].deadline_hit is True
        req.deadline, req.budget_s = -1.0, 1e9
        assert eng.serve_stream([req], warmup=False)[0].deadline_hit is False
        req.deadline = None
        assert eng.serve_stream([req], warmup=False)[0].deadline_hit is True


# the port's executors against JAX's xla engine: the fused cases keep
# their depth ids, the xla ones end in "-xla"
EXECUTOR_CASES = [pytest.param(0, "fused", id="0"),
                  pytest.param(1, "fused", id="1"),
                  pytest.param(0, "xla", id="0-xla"),
                  pytest.param(1, "xla", id="1-xla")]


@pytest.mark.parametrize("depth,executor", EXECUTOR_CASES + [
    pytest.param(2, "fused", id="2")])
def test_shed_resolves_futures_with_typed_results_as_jax(depth, executor):
    eng, jeng, reqs = _engines(admission=AdmissionController,
                               pipeline_depth=depth, executor=executor)
    eng.warmup(reqs)
    jeng.warmup(_as_jax(reqs))
    for e in (eng, jeng):
        for b in e._warmed:                     # every rung predicted late
            e.admission.observe_service(b.name, 1e6)
    fut = eng.submit_future(reqs[0])
    out = fut.result(timeout=1.0)
    assert isinstance(out, Shed) and fut.done()
    assert out.rid == reqs[0].rid and out.rung == SHED_RUNG
    assert out.predicted_ms > out.budget_ms
    drained = eng.drain()
    assert [x.rid for x in drained if isinstance(x, Shed)] == [reqs[0].rid]
    got = eng.serve_stream(reqs[1:], warmup=False)
    want = jeng.serve_stream(_as_jax(reqs[1:]), warmup=False)
    _assert_outcomes_match(got, want)
    assert eng.metrics.sheds == len(reqs) and eng.metrics.results == 0
    eng.close()


@pytest.mark.parametrize("depth,executor", EXECUTOR_CASES)
def test_degrade_routes_to_the_fallback_bucket_as_jax(depth, executor):
    """Rung 0 predicted to miss, the mean rung to fit: every request is
    served from the mean bucket with rung 1, its shortfall accounted,
    and perm and compliant equal the JAX engine's."""
    eng, jeng, reqs = _engines(admission=AdmissionController,
                               pipeline_depth=depth, executor=executor)
    eng.warmup(reqs)
    jeng.warmup(_as_jax(reqs))
    home = eng.bucket_of(reqs[0])
    rungs = dict(eng._rung_buckets(reqs[0], home))
    assert set(rungs) == {0, 1} and rungs[1].tag == "mean"
    for e in (eng, jeng):
        for b in e._warmed:
            if b.tag == "knn":
                e.admission.observe_service(b.name, 1e6)
    got = eng.serve_stream(reqs, warmup=False)
    _assert_outcomes_match(got, jeng.serve_stream(_as_jax(reqs),
                                                  warmup=False))
    assert got and all(r.rung == 1 and r.bucket.startswith("mean/")
                       for r in got)
    assert eng.metrics.degrades == len(got)
    dl = eng.metrics.deadline_summary()
    assert dl["rungs"]["1"]["served"] == len(got)
    assert np.isfinite(dl["rungs"]["1"]["mean_shortfall"])
    eng.close()


def test_ladder_validation_and_raw_lam_requests():
    eng, _, _ = _engines()
    with pytest.raises(KeyError, match="not a registered"):
        eng.set_degradation_ladder("knn", ["nope"])
    with pytest.raises(KeyError, match="no predictor"):
        eng.set_degradation_ladder("nope", ["mean"])
    rng = np.random.default_rng(5)
    eng.register_predictor("small", MeanLambdaPredictor.fit(
        np.zeros((4, D), np.float32),
        np.abs(rng.normal(size=(4, 2))).astype(np.float32), device="cpu"),
        d_cov=D)
    with pytest.raises(ValueError, match="shadow"):
        eng.set_degradation_ladder("knn", ["small"])
    req = make_stream(n_requests=1, seed=4)[0]
    assert req.lam is not None
    assert eng._rung_buckets(req, eng.bucket_of(req)) == [
        (0, eng.bucket_of(req))]


def test_engine_feeds_the_tracker_from_measured_results():
    ctrl = AdmissionController(p99_window=10_000)
    eng = ServingEngine(max_batch=4, pipeline_depth=0, admission=ctrl,
                        clock=FrozenClock(tick=1e-3), device="cpu")
    res = eng.serve_stream(make_stream(n_requests=16, seed=6))
    served = [r for r in res if not isinstance(r, Shed)]
    assert served and len(ctrl._ratio_win) == len(served)
    assert all(r > 0.0 for r in ctrl._ratio_win)


def test_surface_budget_classes_set_deadlines():
    eng = ServingEngine(max_batch=4, pipeline_depth=0, device="cpu",
                        default_budget_s=0.050,
                        surface_budgets={"feed": 0.025, "search": 0.100})
    jeng = JaxEngine(max_batch=4, pipeline_depth=0, default_budget_s=0.050,
                     surface_budgets={"feed": 0.025, "search": 0.100})
    req = make_stream(n_requests=1, seed=7)[0]
    for surface, budget_s, want in (("feed", None, 1.025),
                                    ("search", None, 1.100),
                                    ("unknown", None, 1.050),
                                    ("feed", 0.200, 1.200)):
        req.surface, req.budget_s = surface, budget_s
        assert eng._deadline_of(req, 1.0) == pytest.approx(want)
        assert eng._deadline_of(req, 1.0) == jeng._deadline_of(
            _as_jax([req])[0], 1.0)


def test_surface_stats_and_sheds_per_class():
    mix = (Scenario("f", m1=64, m2=8, K=3, surface="feed", weight=1.0),
           Scenario("s", m1=64, m2=8, K=3, surface="search", weight=1.0))
    eng = ServingEngine(max_batch=4, pipeline_depth=1, device="cpu",
                        surface_budgets={"feed": 0.05, "search": 1.0},
                        clock=FrozenClock())
    res = eng.serve_stream(make_stream(mix, n_requests=24, seed=8))
    ss = eng.metrics.surface_stats
    assert set(ss) == {"feed", "search"}
    assert sum(s["hits"] + s["misses"] for s in ss.values()) == len(res)
    surf = eng.metrics.deadline_summary()["surfaces"]
    assert all(surf[name]["hit_rate"] == 1.0 for name in ("feed", "search"))
    eng.close()
    shed_eng, _, reqs = _engines(admission=AdmissionController)
    for r in reqs:
        r.surface = "feed"
    shed_eng.warmup(reqs)
    for b in shed_eng._warmed:
        shed_eng.admission.observe_service(b.name, 1e6)
    res = shed_eng.serve_stream(reqs, warmup=False)
    assert all(isinstance(r, Shed) for r in res)
    assert shed_eng.metrics.surface_stats["feed"]["sheds"] == len(reqs)
