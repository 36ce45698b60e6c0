"""The port's refresh lane (repro_torch.serving.refresh) and its engine
seam (predictor epochs, the swap fence, the pins), held against
repro.serving.refresh and the JAX engine on the same numpy inputs.

Tolerances:
  * the update rules (dual_refresh_targets, ridge_refresh,
    running_mean_update) and knn_ring_update: bitwise, written rows
    and cursor included;
  * the lane on the port's engine against the lane on the JAX engine
    over one drift stream: every refresh report's swapped, reason and
    epoch equal; every served row's perm, compliant and epoch equal;
    utility and exposure within rtol=1e-5, atol=1e-5 (the port's rank
    sums in the kernel's order, JAX's in XLA's) and so each published
    state's floats (the lambda-hat the targets start from differs by
    ulps). The MLP family takes test_torch_mlp.py's fit tolerance
    (ROADMAP Queue 3) for its published params, atol 2e-3: its warm re-fit follows JAX's
    Adam only that far. Its served rows are held like the others',
    which this stream's scores allow;
  * the port against itself (hot against cold, rollback, refusals,
    the stationary stream): bitwise.

Every engine runs on a frozen clock with max_wait_ms far away, so batch
composition is a pure function of the stream.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.serving as jserving
import repro_torch.serving as pserving
from conftest import FrozenClock
from repro.core import predictors as jpred
from repro.data.synthetic import DriftSpec
from repro_torch.core.predictors import (
    KNNLambdaPredictor,
    MeanLambdaPredictor,
    from_numpy,
    pack_knn_db,
    predictor_state,
    with_state,
)
from repro_torch.serving import (
    RankRequest,
    RefreshLane,
    ServingEngine,
    dual_refresh_targets,
    knn_ring_update,
    ridge_refresh,
    running_mean_update,
)

CPU = "cpu"
TAG = "arch"
D, K, N_DB, M1, M2, KNN_K = 6, 3, 64, 128, 16, 5
RTOL, ATOL = 1e-5, 1e-5
MLP_ATOL = 2e-3
FAMILIES = ("knn", "knn_int8", "linear", "mean", "mlp")
TIGHTEN = DriftSpec(kind="tighten", magnitude=8.0, start=0.25, end=0.75)


def _jax_fit(family, seed=0):
    """A JAX predictor of `family`, fitted on seeded numpy data: prices
    near 0 (the compliant era), so tighten drift brings shortfall."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N_DB, D)).astype(np.float32)
    lam = (0.05 * np.abs(rng.normal(size=(N_DB, K)))).astype(np.float32)
    if family == "knn":
        return jpred.KNNLambdaPredictor.fit(X, lam, k=KNN_K)
    if family == "knn_int8":
        return jpred.KNNLambdaPredictor.fit(X, lam, k=KNN_K).quantized(
            mode="int8", slab=16)
    if family == "linear":
        return jpred.LinearLambdaPredictor.fit(jnp.asarray(X),
                                               jnp.asarray(lam))
    if family == "mean":
        return jpred.MeanLambdaPredictor.fit(X, lam)
    return jpred.MLPLambdaPredictor.fit(X, lam, d_hidden=16, num_steps=30)


def _carry(jp):
    """The port's predictor with the JAX predictor's arrays."""
    state = jpred.predictor_state(jp)
    if "params" in state:
        state = {"params": {k: np.asarray(v)
                            for k, v in state["params"].items()}}
    else:
        state = {k: np.asarray(v) for k, v in state.items()}
    k = jp.k if isinstance(jp, jpred.KNNLambdaPredictor) else None
    return from_numpy(state, k=k, device=CPU)


def _jax_stream(n, spec=TIGHTEN, **kw):
    kw = dict(tag=TAG, n_requests=n, m1=M1, m2=M2, K=K, d_cov=D,
              b_frac=0.03, seed=10) | kw
    return jserving.make_drift_stream(spec, **kw)


def _port_requests(jreqs):
    return [RankRequest(**{f: getattr(r, f) for f in (
        "rid", "u", "a", "b", "m2", "lam", "X", "tag", "gamma")})
        for r in jreqs]


def _engine(pred, *, depth=0, max_batch=8):
    eng = ServingEngine(max_batch=max_batch, max_wait_ms=1e9,
                        pipeline_depth=depth, clock=FrozenClock(),
                        device=CPU)
    eng.register_predictor(TAG, pred, d_cov=D)
    return eng


def _assert_same(got, ref):
    np.testing.assert_array_equal(got.perm, ref.perm)
    np.testing.assert_array_equal(got.exposure, ref.exposure)
    assert got.utility == ref.utility
    assert got.compliant == ref.compliant
    assert got.bucket == ref.bucket


def _host_state(state):
    return {k: ({kk: vv.numpy().copy() for kk, vv in v.items()}
                if isinstance(v, dict) else v.numpy().copy())
            for k, v in state.items()}


# ---------------------------------------------------------------------------
# The update rules, bitwise against JAX
# ---------------------------------------------------------------------------


def _rule_inputs(seed):
    rng = np.random.default_rng(seed)
    lam = np.abs(rng.normal(size=(20, K))).astype(np.float32)
    b = rng.uniform(0, 2, (20, K)).astype(np.float32)
    expo = rng.uniform(0, 2, (20, K)).astype(np.float32)
    expo[:3] = b[:3]                              # exactly met rows
    X = rng.normal(size=(20, D)).astype(np.float32)
    W = rng.normal(size=(K, D)).astype(np.float32)
    c = rng.normal(size=K).astype(np.float32)
    return lam, b, expo, X, W, c


@pytest.mark.parametrize("rule,arg", [
    ("dual_refresh_targets", 0.5), ("dual_refresh_targets", 1.7),
    ("ridge_refresh", 32.0), ("ridge_refresh", 0.25),
    ("running_mean_update", 32.0), ("running_mean_update", 3.0)])
def test_update_rules_match_jax_bitwise(rule, arg):
    lam, b, expo, X, W, c = _rule_inputs(int(arg * 10))
    if rule == "dual_refresh_targets":
        got = [dual_refresh_targets(lam, b, expo, eta=arg)]
        want = [jserving.dual_refresh_targets(lam, b, expo, eta=arg)]
    elif rule == "ridge_refresh":
        targets = jserving.dual_refresh_targets(lam, b, expo, eta=0.5)
        got = ridge_refresh(torch.from_numpy(W), torch.from_numpy(c), X,
                            targets, mu=arg)
        want = jserving.ridge_refresh(W, c, X, targets, mu=arg)
    else:
        got = running_mean_update(torch.from_numpy(c), arg, lam)
        want = jserving.running_mean_update(c, arg, lam)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case,n_new,cursor", [
    ("in place", 5, 3), ("wrap", 9, 60), ("n > n_train", 150, 17),
    ("n == n_train", N_DB, 40), ("empty", 0, 11)])
def test_knn_ring_update_matches_jax_bitwise(case, n_new, cursor):
    rng = np.random.default_rng(n_new)
    X_db = rng.normal(size=(N_DB, D)).astype(np.float32)
    lam_db = rng.normal(size=(N_DB, K)).astype(np.float32)
    X_new = rng.normal(size=(n_new, D)).astype(np.float32)
    lam_new = rng.normal(size=(n_new, K)).astype(np.float32)
    X_t, lam_t = torch.from_numpy(X_db.copy()), torch.from_numpy(
        lam_db.copy())
    got = knn_ring_update(X_t, lam_t, X_new, lam_new, cursor,
                          return_written=True)
    want = jserving.knn_ring_update(X_db, lam_db, X_new, lam_new, cursor,
                                    return_written=True)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    assert got[3].dtype == torch.int64
    # the inputs are left as they are
    np.testing.assert_array_equal(X_t.numpy(), X_db)
    np.testing.assert_array_equal(lam_t.numpy(), lam_db)
    assert len(knn_ring_update(X_t, lam_t, X_new, lam_new, cursor)) == 3


# ---------------------------------------------------------------------------
# The lane on the port's engine against the lane on the JAX engine
# ---------------------------------------------------------------------------


def _drive(mod, pred, reqs, *, depth, every=32, **kw):
    eng = mod.ServingEngine(max_batch=8, max_wait_ms=1e9,
                            pipeline_depth=depth, clock=FrozenClock(), **kw)
    eng.register_predictor(TAG, pred, d_cov=D)
    lane = mod.RefreshLane(eng, eta=1.0, min_samples=8, mlp_steps=10)
    eng.warmup(reqs)
    results, reports, states = [], [], []
    for i in range(0, len(reqs), every):
        results += eng.serve_stream(reqs[i:i + every], warmup=False)
        rep = lane.refresh()[TAG]
        reports.append({k: rep[k] for k in ("swapped", "reason", "epoch")})
        states.append(eng.predictor_state_of(TAG))
    eng.close()
    return {r.rid: r for r in results}, reports, states, eng


@pytest.fixture(scope="module")
def jax_lanes():
    """family -> the JAX lane's run over the tighten drift stream."""
    jreqs = _jax_stream(128)
    out = {}
    for family in FAMILIES:
        jp = _jax_fit(family)
        got = _drive(jserving, jp, jreqs, depth=0)
        states = [{k: (jnp.asarray(v) if not isinstance(v, dict) else
                       {kk: np.asarray(vv) for kk, vv in v.items()})
                   for k, v in s.items()} for s in got[2]]
        out[family] = (jp, got[0], got[1], states)
    return jreqs, out


def _state_close(got, want, atol):
    got, want = _host_state(got), want
    assert set(got) == set(want)
    for k, g in got.items():
        w = want[k]
        if isinstance(g, dict):
            for kk in g:
                np.testing.assert_allclose(g[kk], np.asarray(w[kk]),
                                           rtol=RTOL, atol=atol)
        elif g.dtype == np.float32:
            np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL,
                                       atol=atol)
        else:                                    # a pack's int8 rows
            np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("family", FAMILIES)
def test_lane_matches_the_jax_lane_over_a_drift_stream(jax_lanes, family,
                                                       depth):
    jreqs, lanes = jax_lanes
    jp, want, want_reports, want_states = lanes[family]
    got, reports, states, eng = _drive(
        pserving, _carry(jp), _port_requests(jreqs), depth=depth,
        device=CPU)
    assert reports == want_reports
    assert sum(r["swapped"] for r in reports) >= 2
    assert sorted(got) == sorted(want) == list(range(len(jreqs)))
    for rid, w in want.items():
        g = got[rid]
        np.testing.assert_array_equal(g.perm, np.asarray(w.perm))
        assert (g.compliant, g.epoch, g.bucket) == (w.compliant, w.epoch,
                                                     w.bucket)
        np.testing.assert_allclose(g.utility, w.utility, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(g.exposure, w.exposure, rtol=RTOL,
                                   atol=ATOL)
    atol = MLP_ATOL if family == "mlp" else ATOL
    for g, w in zip(states, want_states):
        _state_close(g, w, atol)
    s = eng.metrics.refresh_summary()
    assert s["swaps"] == sum(r["swapped"] for r in reports)
    assert s["refresh_failures"] == 0
    assert s["states_retired"] == s["swaps"]      # nothing left pinned
    assert not eng._inflight_gens


# ---------------------------------------------------------------------------
# The swap fence on the port's engine
# ---------------------------------------------------------------------------


def _port_knn(seed=0):
    return _carry(_jax_fit("knn", seed))


@pytest.mark.parametrize("depth", [0, 1, 2])
@pytest.mark.parametrize("swap_at", [0, 2, 5])
def test_mid_stream_swap_never_tears_a_batch(depth, swap_at):
    """A swap landing before the stream, mid-queue or with batches in
    flight: every result is wholly one generation, bitwise the cold
    engine of its epoch; requests queued before the swap but flushed
    after it are served by the new generation."""
    pred = _port_knn()
    state1 = predictor_state(_port_knn(seed=99))
    reqs = _port_requests(_jax_stream(12, spec=DriftSpec(kind="none"),
                                      b_frac=0.25))
    refs = {e: {r.rid: r for r in _engine(p, max_batch=4).serve_stream(
        reqs)} for e, p in ((0, pred), (1, with_state(pred, state1)))}
    eng = _engine(pred, depth=depth, max_batch=4)
    eng.warmup(reqs)
    results = []
    for i, r in enumerate(reqs):
        if i == swap_at:
            assert eng.swap_predictor(TAG, state1) == 1
        results += eng.submit(r)
    results += eng.drain()
    assert sorted(r.rid for r in results) == list(range(12))
    for r in results:
        assert r.epoch in (0, 1)
        _assert_same(r, refs[r.epoch][r.rid])
    assert all(r.epoch == 1 for r in results if r.rid >= swap_at + 4)
    assert [r.epoch for r in sorted(results, key=lambda r: r.rid)] == \
        sorted(r.epoch for r in results)         # epochs never go back
    eng.close()


class _GatedEngine(ServingEngine):
    """Holds each batch at the door of materialize until `gate` opens,
    and records the pins the batch finds there and leaves behind."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.gate = threading.Event()
        self.seen = []

    def _materialize_batch(self, pending):
        assert self.gate.wait(timeout=30.0)
        before = dict(self._inflight_gens)
        super()._materialize_batch(pending)
        self.seen.append((pending.epoch, before, dict(self._inflight_gens)))


def test_pins_release_after_materialize_and_retire_superseded_states():
    pred = _port_knn()
    reqs = _port_requests(_jax_stream(8, spec=DriftSpec(kind="none")))
    eng = _GatedEngine(max_batch=4, max_wait_ms=1e9, pipeline_depth=1,
                       clock=FrozenClock(), device=CPU)
    eng.register_predictor(TAG, pred, d_cov=D)
    eng.gate.set()
    eng.warmup(reqs)
    eng.gate.clear()
    gen0 = eng.predictor_state_of(TAG)
    for r in reqs[:4]:                  # one capacity flush, held in flight
        eng.submit(r)
    assert eng._inflight_gens == {(TAG, 0): 1}
    state1 = predictor_state(_port_knn(seed=7))
    assert eng.swap_predictor(TAG, state1) == 1
    # superseded but pinned: kept, not retired
    assert eng._old_states[TAG] == {0: gen0}
    assert eng.metrics.states_retired == 0
    with pytest.raises(ValueError, match="monotone"):
        eng.swap_predictor(TAG, state1, epoch=1)
    eng.gate.set()
    out = eng.drain()
    for r in reqs[4:]:
        eng.submit(r)
    out += eng.drain()
    assert [r.epoch for r in sorted(out, key=lambda r: r.rid)] == \
        [0] * 4 + [1] * 4
    epoch, before, after = eng.seen[0]
    assert epoch == 0 and before == {(TAG, 0): 1} and after == {}
    assert eng._old_states[TAG] == {}
    assert eng.metrics.states_retired == 1
    assert eng.swap_predictor(TAG, predictor_state(pred), epoch=5) == 5
    assert eng.predictor_epoch(TAG) == 5
    eng.close()


def test_swap_refusals_keep_serving_on_the_live_generation():
    pred = _port_knn()
    reqs = _port_requests(_jax_stream(8, spec=DriftSpec(kind="none")))
    eng = _engine(pred)
    eng.warmup(reqs)
    good = _host_state(eng.predictor_state_of(TAG))
    bad = [
        ("state keys", {"X_db": good["X_db"]}),
        ("frozen", {"X_db": good["X_db"], "lam_db": good["lam_db"][:-1]}),
        ("frozen", {"X_db": good["X_db"],
                    "lam_db": good["lam_db"].astype(np.float64)}),
        ("poisoned", {"X_db": good["X_db"],
                      "lam_db": np.where(np.arange(N_DB)[:, None] == 9,
                                         np.nan, good["lam_db"])}),
    ]
    for match, state in bad:
        with pytest.raises(ValueError, match=match):
            eng.swap_predictor(TAG, state)
    with pytest.raises(KeyError, match="no predictor registered"):
        eng.swap_predictor("nope", good)
    assert eng.predictor_epoch(TAG) == 0 and eng.metrics.swaps == 0
    ref = {r.rid: r for r in _engine(pred).serve_stream(reqs)}
    for r in eng.serve_stream(reqs, warmup=False):
        assert r.epoch == 0
        _assert_same(r, ref[r.rid])

    class Opaque:
        num_constraints = K
        device = torch.device(CPU)

        def predict(self, X):
            return torch.zeros(X.shape[:-1] + (K,))

    other = ServingEngine(max_batch=4, pipeline_depth=0, device=CPU)
    other.register_predictor("opaque", Opaque(), d_cov=D)
    with pytest.raises(ValueError, match="refreshable state"):
        other.swap_predictor("opaque", {})


def test_a_poisoned_refresh_is_refused_and_counted():
    """A publish_filter that poisons the candidate (NaN in lam_db):
    the engine refuses it, the lane counts a refresh failure, serving
    stays on the last good generation bitwise."""
    pred = _port_knn()
    reqs = _port_requests(_jax_stream(64))

    def poison(tag, state):
        lam = state["lam_db"].clone()
        lam[3, 1] = float("nan")
        return {**state, "lam_db": lam}

    eng = _engine(pred)
    lane = RefreshLane(eng, eta=1.0, min_samples=8, publish_filter=poison)
    eng.warmup(reqs)
    eng.serve_stream(reqs[:48], warmup=False)
    rep = lane.refresh(TAG)[TAG]
    assert not rep["swapped"] and rep["reason"].startswith("refused:")
    assert "poisoned" in rep["reason"]
    assert eng.metrics.refresh_failures == 1 and eng.predictor_epoch(TAG) == 0
    ref = {r.rid: r for r in _engine(pred).serve_stream(reqs[48:])}
    for r in eng.serve_stream(reqs[48:], warmup=False):
        _assert_same(r, ref[r.rid])


@pytest.mark.parametrize("family", ["knn", "linear", "mean"])
def test_rollback_serves_the_pre_swap_generation_bitwise(family):
    pred = _carry(_jax_fit(family))
    reqs = _port_requests(_jax_stream(64))
    ref = {r.rid: r for r in _engine(pred).serve_stream(reqs[48:])}
    eng = _engine(pred)
    lane = RefreshLane(eng, eta=1.0, min_samples=8)
    eng.warmup(reqs)
    before = _host_state(eng.predictor_state_of(TAG))
    eng.serve_stream(reqs[:48], warmup=False)
    assert lane.refresh(TAG)[TAG]["swapped"]
    assert lane.rollback(TAG) == 2
    after = _host_state(eng.predictor_state_of(TAG))
    for k in before:
        np.testing.assert_array_equal(before[k], after[k])
    out = eng.serve_stream(reqs[48:], warmup=False)
    for r in out:
        assert r.epoch == 2
        _assert_same(r, ref[r.rid])
    with pytest.raises(KeyError, match="no pre-swap state"):
        RefreshLane(_engine(pred)).rollback(TAG)


def test_stationary_compliant_stream_never_swaps_and_is_neutral():
    """No dual pressure (compliant, served with lambda-hat = 0): the
    lane publishes nothing and serving is bitwise refresh-off."""
    reqs = _port_requests(_jax_stream(
        96, spec=DriftSpec(kind="none"), topic_rate=0.6, b_frac=0.01,
        seed=11))
    rng = np.random.default_rng(12)
    pred = KNNLambdaPredictor.fit(
        rng.normal(size=(N_DB, D)).astype(np.float32),
        np.zeros((N_DB, K), np.float32), k=KNN_K, device=CPU)

    def run(on):
        eng = _engine(pred)
        lane = RefreshLane(eng, min_samples=8) if on else None
        eng.warmup(reqs)
        results = []
        for i in range(0, len(reqs), 16):
            results += eng.serve_stream(reqs[i:i + 16], warmup=False)
            if lane is not None:
                for rep in lane.refresh().values():
                    assert not rep["swapped"]
                    assert rep["reason"] in ("no-pressure",
                                             "below-min-samples")
        return {r.rid: r for r in results}, eng

    ref, _ = run(False)
    assert all(r.compliant for r in ref.values())
    got, eng = run(True)
    assert eng.metrics.swaps == 0 and eng.predictor_epoch(TAG) == 0
    for rid, r in got.items():
        assert r.epoch == 0
        _assert_same(r, ref[rid])


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_packed_refresh_equals_a_full_repack(mode):
    """After each refresh of a packed db the published pack is bitwise
    pack_knn_db of the refreshed f32 db: no slab keeps a stale scale."""
    reqs = _port_requests(_jax_stream(64, b_frac=0.25, seed=31))
    rng = np.random.default_rng(32)
    pred = KNNLambdaPredictor.fit(
        rng.normal(size=(N_DB, D)).astype(np.float32),
        np.abs(rng.normal(size=(N_DB, K))).astype(np.float32), k=KNN_K,
        device=CPU).quantized(mode, slab=16, device=CPU)
    eng = _engine(pred)
    lane = RefreshLane(eng, min_samples=8)
    eng.warmup(reqs)
    swaps = 0
    for i in range(0, len(reqs), 16):
        eng.serve_stream(reqs[i:i + 16], warmup=False)
        if not lane.refresh()[TAG]["swapped"]:
            continue
        swaps += 1
        state = eng.predictor_state_of(TAG)
        full = pack_knn_db(state["X_db"], mode=mode, slab=16, device=CPU)
        for name, want in zip(("X_q", "q_scale", "y2_q"), full):
            assert torch.equal(state[name], want), name
    assert swaps >= 2


def test_background_lane_and_stop_final_refresh_never_race():
    """stop(final_refresh=True) waits for the background pass in flight
    (held inside its publish) and only then runs the final pass: the
    running-mean weight shows both windows applied in sequence."""
    pred = MeanLambdaPredictor.fit(np.zeros((4, D), np.float32),
                                   np.ones((4, K), np.float32), device=CPU)
    eng = ServingEngine(max_batch=4, pipeline_depth=0, device=CPU)
    eng.register_predictor(TAG, pred, d_cov=D)
    entered, gate = threading.Event(), threading.Event()
    inside, max_inside = [0], [0]
    ilock = threading.Lock()

    def publish_filter(tag, state):
        with ilock:
            inside[0] += 1
            max_inside[0] = max(max_inside[0], inside[0])
        entered.set()
        if not gate.wait(timeout=30.0):
            raise RuntimeError("gate never opened")
        with ilock:
            inside[0] -= 1
        return state

    lane = RefreshLane(eng, min_samples=4, publish_filter=publish_filter)
    rng = np.random.default_rng(0)

    def window(n):
        for _ in range(n):
            lane.observe(TAG, X=rng.normal(size=D).astype(np.float32),
                         lam=np.abs(rng.normal(size=K)).astype(np.float32),
                         exposure=np.zeros(K, np.float32),
                         b=np.ones(K, np.float32))

    w0 = lane._default_mean_weight
    window(4)
    lane.start(interval_s=1e-3)
    with pytest.raises(RuntimeError, match="already started"):
        lane.start(interval_s=1e-3)
    assert entered.wait(timeout=30.0)
    window(6)
    stopper = threading.Thread(target=lambda: lane.stop(final_refresh=True))
    stopper.start()
    stopper.join(timeout=0.3)
    assert stopper.is_alive()                  # stop waits for the pass
    gate.set()
    stopper.join(timeout=30.0)
    assert not stopper.is_alive() and lane._thread is None
    assert max_inside[0] == 1
    assert eng.predictor_epoch(TAG) == 2 and eng.metrics.swaps == 2
    assert lane._mean_weight[TAG] == w0 + 4 + 6
    assert lane.pending(TAG) == 0
