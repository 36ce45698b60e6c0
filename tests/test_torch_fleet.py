"""The port's fault-tolerant replica fleet (repro_torch.serving.health,
faults and fleet) against repro.serving's on the same inputs.

The health machine, backoff, ring owners and chaos plans are host code
and are held equal to the JAX package's. The fleet gate's chaos run
(benchmarks/latency_serve.py run_fleet: three replicas with a KNN
predictor, a RefreshLane and a CheckpointStore each, a fault-free
prefix with a checkpointed refresh, then FaultPlan.chaos) runs at a
small size through both fleets on the same stream, with engines at
pipeline depth 0 and a step clock on the router so every health
decision is a function of the stream: the same served rids, each rid's
perm equal, the same crashes, restarts, restored epochs, transitions and
refusals, and no orphaned future. The engine's side of the seam (a
ReplicaCrash through the real failure path, close() after a failed
drain) is checked on the port alone.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as tserving
from conftest import FrozenClock
from repro.checkpoint import CheckpointStore as JaxStore
from repro.core.predictors import KNNLambdaPredictor as JaxKNN
from repro_torch.checkpoint import CheckpointStore
from repro_torch.core.predictors import KNNLambdaPredictor, MeanLambdaPredictor
from repro_torch.serving import (
    DEAD,
    HEALTHY,
    RECOVERING,
    SUSPECT,
    FaultInjector,
    FaultPlan,
    FleetRouter,
    HealthConfig,
    ReplicaCrash,
    ReplicaFaults,
    ReplicaHealth,
    Scenario,
    ServingEngine,
    Shed,
    backoff_s,
    make_stream,
    optimize_lattice,
)

TAG, D, K = "fleet_arch", 12, 4
FIELDS = ("rid", "u", "a", "b", "m2", "lam", "X", "tag", "gamma", "surface")


# ---------------------------------------------------------------------------
# Host code against the JAX package's
# ---------------------------------------------------------------------------


def _events(seed, n=200):
    rng = np.random.default_rng(seed)
    t, out = 0.0, []
    for _ in range(n):
        t += float(rng.exponential(0.05))
        out.append((t, int(rng.integers(6)), float(rng.uniform(0, 400))))
    return out


def _drive(h, events):
    states = []
    for t, kind, x in events:
        if kind == 0:
            h.heartbeat(t)
        elif kind == 1:
            h.observe_lag(x)
        elif kind == 2:
            h.on_failure(t, fatal=x > 380.0)
        elif kind == 3:
            h.on_success(t)
        elif kind == 4 and h.state == DEAD:
            h.begin_recovery(t)
            (h.mark_recovered if x > 100.0 else h.fail_recovery)(t)
        states.append((h.evaluate(t), h.routable, h.lag_ewma_ms,
                       h.consecutive_failures))
    return states, h.transitions


@pytest.mark.parametrize("seed", range(4))
def test_health_machine_matches_jax(seed):
    cfg = dict(suspect_after_s=0.1, dead_after_s=0.4, lag_suspect_ms=200.0,
               lag_alpha=0.5, fail_threshold=3)
    got = _drive(ReplicaHealth("r", HealthConfig(**cfg)), _events(seed))
    want = _drive(jserving.ReplicaHealth("r", jserving.HealthConfig(**cfg)),
                  _events(seed))
    assert got == want
    assert {s[0] for s in got[0]} >= {HEALTHY, SUSPECT, DEAD}
    assert (HEALTHY, SUSPECT, DEAD, RECOVERING) == (
        jserving.HEALTHY, jserving.SUSPECT, jserving.DEAD,
        jserving.RECOVERING)
    for bad in (dict(suspect_after_s=1.0, dead_after_s=0.5),
                dict(lag_hysteresis=0.0)):
        with pytest.raises(ValueError) as e1:
            HealthConfig(**bad)
        with pytest.raises(ValueError) as e2:
            jserving.HealthConfig(**bad)
        assert str(e1.value) == str(e2.value)


def test_backoff_matches_jax():
    for seed in (0, 3, 17 * 1009 + 2):
        for attempt in range(12):
            kw = dict(base_s=0.02, cap_s=0.2, seed=seed)
            assert backoff_s(attempt, **kw) == jserving.backoff_s(attempt,
                                                                  **kw)
    with pytest.raises(ValueError):
        backoff_s(-1)


@pytest.mark.parametrize("seed", [0, 5, 11, 17])
def test_chaos_plan_matches_jax(seed):
    names = ["r2", "r0", "r1", "r3"]
    got = FaultPlan.chaos(names, seed=seed, slow_ms=1.5)
    want = jserving.FaultPlan.chaos(names, seed=seed, slow_ms=1.5)
    assert got.seed == want.seed
    assert {n: dataclasses.asdict(f) for n, f in got.replicas.items()} == {
        n: dataclasses.asdict(f) for n, f in want.replicas.items()}
    with pytest.raises(ValueError, match=">= 3"):
        FaultPlan.chaos(names[:2])


def test_injector_schedules_match_jax():
    faults = dict(crash_at_batch=2, blackhole_after=1, blackhole_until=4,
                  kill_during_drain=True)
    ours = FaultInjector(ReplicaFaults(**faults), "r")
    theirs = jserving.FaultInjector(jserving.ReplicaFaults(**faults), "r")

    def trace(inj):
        out = []
        for step in range(12):
            if step == 7:
                inj.restore()
            inj.draining = step == 9
            try:
                inj._before_flush()
                out.append("ok")
            except Exception as e:      # noqa: BLE001 - compared by name
                out.append(type(e).__name__)
            out.append(inj.heartbeat_delivered())
        return out

    assert trace(ours) == trace(theirs)


def test_ring_owners_match_jax():
    ours = FleetRouter(lambda n: ServingEngine(device="cpu"), 3,
                       heartbeat_interval_s=float("inf"))
    theirs = jserving.FleetRouter(lambda n: jserving.ServingEngine(), 3,
                                  heartbeat_interval_s=float("inf"))
    names = [f"_lam/m1={m1}/m2=16/K=4/B=8" for m1 in (128, 192, 576)] + [
        f"bucket/{i}" for i in range(64)]
    for name in names:
        assert ours._owners(name) == theirs._owners(name)
    assert {ours._owners(n)[0] for n in names} == {0, 1, 2}
    ours.close()
    theirs.close()


def test_poison_state_nan_fills_float_tensors():
    inj = FaultInjector(ReplicaFaults(poison_swap_at=1), "r")
    state = {"X_db": torch.ones(4, 3), "lam_db": torch.ones(4, 2),
             "idx": torch.arange(4)}
    assert inj.poison_state(state) is state          # refresh 0: untouched
    bad = inj.poison_state(state)                    # refresh 1: poisoned
    assert torch.isnan(bad["X_db"]).all() and torch.isnan(bad["lam_db"]).all()
    assert bad["X_db"].dtype == torch.float32 and bad["X_db"].shape == (4, 3)
    assert bad["idx"] is state["idx"]
    assert inj.poison_state(state) is state          # one-shot


# ---------------------------------------------------------------------------
# The engine's side of the seam
# ---------------------------------------------------------------------------


def _mean_engine(depth):
    rng = np.random.default_rng(1)
    eng = ServingEngine(max_batch=4, max_wait_ms=1e9, pipeline_depth=depth,
                        device="cpu")
    eng.register_predictor(TAG, MeanLambdaPredictor.fit(
        rng.normal(size=(16, D)).astype(np.float32),
        np.abs(rng.normal(size=(16, K))).astype(np.float32), device="cpu"),
        d_cov=D)
    return eng


def _cov_stream(n, seed=0):
    mix = (Scenario("s", m1=64, m2=8, K=K, tag=TAG, d_cov=D, m1_jitter=0.0),)
    return make_stream(mix, n_requests=n, seed=seed)


@pytest.mark.parametrize("depth", [0, 1])
def test_a_crash_takes_the_engines_failure_path(depth):
    """The injected ReplicaCrash raises inside the bucket's call: the
    generation the batch pinned is let go, its futures fail, its slot
    goes back to the ring, and nothing was launched or counted."""
    reqs = _cov_stream(8)
    eng = _mean_engine(depth)
    eng.warmup(reqs)
    inj = FaultInjector(ReplicaFaults(crash_at_batch=0), "r")
    inj.wrap_engine(eng)
    futures = [eng.submit_future(r) for r in reqs[:3]]
    with pytest.raises(ReplicaCrash, match="planned"):
        eng.submit_future(reqs[3])                  # capacity flush
    for fut in futures:
        with pytest.raises(ReplicaCrash):
            fut.result(timeout=1.0)
    assert eng._inflight_gens == {}
    ring = eng._rings[eng.bucket_of(reqs[0])]
    assert ring._free.qsize() == ring.allocated
    assert eng.metrics.executable_calls == eng.metrics.batches == 0
    eng.close()


def test_close_stops_the_worker_after_a_failed_drain():
    """close() on a replica whose final flush crashes: the drain's error
    re-raises, but the pipeline worker is stopped, the engine is closed,
    and every future (queued ones included) has resolved."""
    reqs = _cov_stream(6)
    eng = _mean_engine(depth=1)
    eng.warmup(reqs)
    inj = FaultInjector(ReplicaFaults(kill_during_drain=True), "r")
    inj.wrap_engine(eng)
    futures = [eng.submit_future(r) for r in reqs]  # one flush, 2 queued
    worker = eng._pipeline._worker
    inj.draining = True
    with pytest.raises(ReplicaCrash, match="mid-drain"):
        eng.close()
    assert eng._closed and worker is not None and not worker.is_alive()
    assert eng._pipeline._worker is None
    assert all(f.done() for f in futures)
    assert futures[0].result(timeout=0).rid == reqs[0].rid
    with pytest.raises(ReplicaCrash):
        futures[-1].result(timeout=0)
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit_future(reqs[2])
    eng.close()                                      # idempotent


# ---------------------------------------------------------------------------
# The fleet gate's chaos run through both fleets
# ---------------------------------------------------------------------------


def _step_clock(step_s=1e-3):
    t = [0.0]

    def clock():
        t[0] += step_s
        return t[0]
    return clock


def _chaos_run(pkg, factory, reqs):
    """latency_serve.py's run_fleet on `pkg` at a small size."""
    router = pkg.FleetRouter(
        factory, 3, clock=_step_clock(),
        health=pkg.HealthConfig(suspect_after_s=0.02, dead_after_s=0.5),
        heartbeat_interval_s=float("inf"), backoff_base_s=0.02,
        backoff_cap_s=0.2, seed=17)
    router.warmup(reqs)

    def serve(chunk, out):
        for r in chunk:
            out += router.submit(r)
            out += router.poll()
            router.tick()

    results, prefix = [], len(reqs) // 4
    serve(reqs[:prefix], results)
    results += router.drain()
    order = []
    for r in reqs:
        name = router.replicas[router._owners(router._bucket_key(r))[0]].name
        if name not in order:
            order.append(name)
    order += [rep.name for rep in router.replicas if rep.name not in order]
    pre = router.refresh()[order[0]][TAG]
    plan = pkg.FaultPlan.chaos(order, seed=17, slow_ms=0.0)
    router.fault_plan = plan
    for rep in router.replicas:
        rep.injector = pkg.FaultInjector(plan.faults_for(rep.name), rep.name)
        rep.lane.publish_filter = (
            lambda tag, state, inj=rep.injector: inj.poison_state(state))
    router.arm_faults()
    rest, refused = reqs[prefix:], 0
    step = max(1, len(rest) // 3)
    for i in range(0, len(rest), step):
        serve(rest[i:i + step], results)
        for reports in router.refresh().values():
            reason = str(reports.get(TAG, {}).get("reason", ""))
            refused += reason.startswith("refused")
    results += router.drain()
    s = router.fleet_summary()
    out = {"order": order, "prefix": (pre["swapped"], pre["epoch"],
                                      pre["checkpointed"]),
           "refused": refused,
           "restored": [r.restore_history for r in router.replicas],
           "transitions": [[t[1:] for t in r.health.transitions]
                           for r in router.replicas],
           "compiles_post_warmup": sum(r.engine.metrics.compiles_post_warmup
                                       for r in router.replicas),
           **{k: s[k] for k in ("submitted", "served", "sheds", "lost",
                                "crashes", "restarts", "failovers", "hedges",
                                "retries", "heartbeats_missed",
                                "orphaned_futures")}}
    router.close()
    return out, results, router


def _fleet_inputs(n):
    rng = np.random.default_rng(17)
    X = rng.normal(size=(96, D)).astype(np.float32)
    lam = np.abs(rng.normal(size=(96, K))).astype(np.float32)
    mix = (Scenario("feed", m1=128, m2=16, K=K, tag=TAG, d_cov=D,
                    m1_jitter=0.0, b_frac=0.25, weight=2.0, surface="feed"),
           Scenario("strip", m1=192, m2=16, K=K, tag=TAG, d_cov=D,
                    m1_jitter=0.0, b_frac=0.25, weight=1.0, surface="strip"))
    return X, lam, make_stream(mix, n_requests=n, seed=18)


def _port_factory(X, lam, root, depth):
    def factory(name):
        eng = ServingEngine(max_batch=8, max_wait_ms=1e9,
                            pipeline_depth=depth, clock=FrozenClock(),
                            device="cpu")
        eng.register_predictor(TAG, KNNLambdaPredictor.fit(
            X, lam, k=5, device="cpu"), d_cov=D)
        store = CheckpointStore(os.path.join(root, name), keep_last=3)
        return eng, tserving.RefreshLane(eng, eta=0.5, min_samples=8,
                                         checkpoint=store)
    return factory


def test_chaos_run_matches_the_jax_fleet(tmp_path):
    X, lam, reqs = _fleet_inputs(160)

    def jax_factory(name):
        eng = jserving.ServingEngine(max_batch=8, max_wait_ms=1e9,
                                     pipeline_depth=0, clock=FrozenClock())
        eng.register_predictor(TAG, JaxKNN.fit(jnp.asarray(X),
                                               jnp.asarray(lam), k=5),
                               d_cov=D)
        store = JaxStore(str(tmp_path / "jax" / name), keep_last=3)
        return eng, jserving.RefreshLane(eng, eta=0.5, min_samples=8,
                                         checkpoint=store)

    want, want_res, _ = _chaos_run(
        jserving, jax_factory,
        [jserving.RankRequest(**{f: getattr(r, f) for f in FIELDS})
         for r in reqs])
    got, got_res, router = _chaos_run(
        tserving, _port_factory(X, lam, str(tmp_path / "port"), 0), reqs)
    assert got == want
    assert got["crashes"] >= 1 and got["restarts"] >= 1
    assert got["refused"] >= 1 and got["prefix"] == (True, 1, True)
    assert got["lost"] == got["orphaned_futures"] == 0
    assert got["compiles_post_warmup"] == 0
    crashed = next(r for r in router.replicas if r.name == got["order"][0])
    assert crashed.restore_history and crashed.restore_history[0]
    assert len(crashed.restart_ms) == len(crashed.restore_history)
    assert set(crashed.restart_ms[0]) == {"factory", "reload", "rewarm"}
    want_res = {r.rid: r for r in want_res if not isinstance(r, jserving.Shed)}
    got_res = {r.rid: r for r in got_res if not isinstance(r, Shed)}
    assert sorted(got_res) == sorted(want_res) == list(range(len(reqs)))
    for rid, r in got_res.items():
        np.testing.assert_array_equal(r.perm, want_res[rid].perm)
        assert r.epoch == want_res[rid].epoch


def test_chaos_run_at_depth_1_serves_every_request_once(tmp_path):
    X, lam, reqs = _fleet_inputs(128)
    got, res, _ = _chaos_run(
        tserving, _port_factory(X, lam, str(tmp_path), 1), reqs)
    served = [r for r in res if not isinstance(r, Shed)]
    assert sorted(r.rid for r in served) == list(range(len(reqs)))
    assert got["submitted"] == got["served"] + got["sheds"] + got["lost"]
    assert got["lost"] == got["orphaned_futures"] == 0
    assert got["crashes"] >= 1 and got["restarts"] >= 1
    assert got["compiles_post_warmup"] == 0


def test_fleet_lattice_rewarm_and_restart_resume_its_epoch():
    mix = (Scenario("feed", m1=150, m2=8, K=3, weight=2.0, m1_jitter=0.1),
           Scenario("strip", m1=300, m2=8, K=5, weight=1.0, m1_jitter=0.1))
    router = FleetRouter(
        lambda n: ServingEngine(max_batch=4, max_wait_ms=1e9,
                                pipeline_depth=1, device="cpu"),
        3, auto_restart=False, heartbeat_interval_s=float("inf"))
    router.serve_stream(make_stream(mix, n_requests=48, seed=12))
    weights = {}
    for rep in router.replicas:
        for g, w in rep.engine.shape_histogram.geometry_weights().items():
            weights[g] = weights.get(g, 0.0) + w
    new = optimize_lattice(weights, max_executables=4, batch=4)
    epoch = router.rewarm_lattice(new)["epoch"]
    assert {r.engine.lattice_epoch() for r in router.replicas} == {epoch}
    later = make_stream(mix, n_requests=24, seed=13)
    for i, r in enumerate(later):
        r.rid = 3000 + i
    got = router.serve_stream(later, warmup=False)
    assert sorted(r.rid for r in got) == [r.rid for r in later]
    assert {r.lattice_epoch for r in got} == {epoch}
    rep = router.replicas[0]
    rep.health.on_failure(0.0, fatal=True)
    router.restart(rep.name)
    assert rep.engine.lattice_epoch() == epoch
    assert rep.engine.lattice().corners == new.corners
    assert rep.health.state == HEALTHY
    for r in router.replicas:
        assert r.engine.metrics.compiles_post_warmup == 0
    router.close()
