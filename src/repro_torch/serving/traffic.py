"""Scenario-mix request generator + paced open-loop load generation for
the port's serving engine (counterpart of repro.serving.traffic: the
same numpy draws in the same order, so both packages make the same
streams and arrival times from one seed; only gamma, and b through it,
can part from JAX's in the last bit, where XLA's f32 log2 is not
correctly rounded).

A live fleet multiplexes surfaces — a home feed with ~500 candidates and
50 slots, a related-items strip with ~1k candidates and 20 slots, a
notification ranker with tiny slates, a retrieval head with 10^5+
candidates — each behind a different recommender architecture with its
own constraint system. A Scenario captures one such surface's geometry
distribution; `make_stream` interleaves scenarios by weight into a
single request sequence the engine can be driven with.

Payloads are synthetic (utilities ~ U[1, 5], sparse topic attributes,
thresholds as a fraction of the total slot discount — the same
conventions as benchmarks/ and the dual-solver tests) but every request
is a well-posed instance of the paper's online problem, so compliance
numbers are meaningful, not decorative. Plugging real backbone scores in
instead is a one-line swap.

Load generation: `poisson_arrivals` + `serve_open_loop` drive a stream
OPEN-LOOP — request i is submitted at its pre-drawn Poisson arrival
time regardless of how far behind the engine is. A closed-loop run
(submit back-to-back, next request waits for the previous dispatch)
measures only the engine's saturated throughput and silently hides
queueing delay: offered load can never exceed service rate, so the
latency/throughput frontier is invisible. Open-loop pacing is what
exposes it — below saturation, p99 reflects batching + service time;
approaching saturation, queueing delay blows the tail up
(chip_smoke.py's phase S sweeps this curve on the card).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from repro_torch.core.constraints import dcg_discount
from repro_torch.serving.engine import LAM_TAG, RankRequest


@dataclass(frozen=True)
class Scenario:
    """One traffic surface: a geometry distribution + arrival weight."""

    name: str
    m1: int                    # nominal candidate count
    m2: int                    # nominal slot count
    K: int                     # constraint count
    weight: float = 1.0        # relative arrival rate
    tag: str = LAM_TAG         # predictor tag ('_lam' = request carries lam)
    d_cov: int = 20            # covariate dim (used when tag != '_lam')
    m1_jitter: float = 0.5     # m1 sampled from [m1*(1-jitter), m1]
    topic_rate: float = 0.15   # sparsity of the constraint attributes
    b_frac: float = 0.06       # threshold as fraction of sum(gamma)
    surface: str = "default"   # budget class (engine.surface_budgets)


# A default mix spanning >= 3 geometries and 2 "archs" (surfaces): the
# shapes mirror the repo's recsys configs (sasrec feed, bert4rec strip,
# mind notifications, deepfm retrieval).
DEFAULT_MIX = (
    Scenario("feed_sasrec", m1=500, m2=50, K=5, weight=4.0),
    Scenario("strip_bert4rec", m1=1000, m2=20, K=5, weight=2.0),
    Scenario("notif_mind", m1=120, m2=8, K=3, weight=1.0),
    Scenario("retrieval_deepfm", m1=4000, m2=50, K=8, weight=1.0),
)


def make_request(rng: np.random.Generator, scenario: Scenario,
                 rid: int) -> RankRequest:
    """One synthetic request drawn from the scenario's distribution."""
    lo = max(scenario.m2, int(scenario.m1 * (1.0 - scenario.m1_jitter)))
    m1 = int(rng.integers(lo, scenario.m1 + 1))
    m2, K = scenario.m2, scenario.K
    u = rng.uniform(1.0, 5.0, m1).astype(np.float32)
    a = (rng.random((K, m1)) < scenario.topic_rate).astype(np.float32)
    gamma = dcg_discount(m2).numpy()
    b = (scenario.b_frac * float(gamma.sum())
         * np.ones(K, np.float32))
    lam = X = None
    if scenario.tag == LAM_TAG:
        lam = rng.exponential(0.5, K).astype(np.float32)
    else:
        X = rng.normal(size=scenario.d_cov).astype(np.float32)
    return RankRequest(rid=rid, u=u, a=a, b=b, m2=m2, lam=lam, X=X,
                       tag=scenario.tag, gamma=gamma,
                       surface=scenario.surface)


def make_stream(scenarios=DEFAULT_MIX, *, n_requests: int = 256,
                seed: int = 0) -> list[RankRequest]:
    """Weighted interleaving of the scenarios into one request stream."""
    rng = np.random.default_rng(seed)
    w = np.asarray([s.weight for s in scenarios], np.float64)
    w = w / w.sum()
    picks = rng.choice(len(scenarios), size=n_requests, p=w)
    return [make_request(rng, scenarios[int(i)], rid)
            for rid, i in enumerate(picks)]


def make_drift_stream(spec, *, tag: str, n_requests: int = 256,
                      m1: int = 256, m2: int = 16, K: int = 4,
                      d_cov: int = 20, topic_rate: float = 0.15,
                      b_frac: float = 0.03, seed: int = 0
                      ) -> list[RankRequest]:
    """A single-surface covariate stream whose distribution drifts
    mid-stream per `spec` (data.synthetic.DriftSpec): request i sits at
    stream fraction i/(n-1) on the drift ramp. Fixed geometry — the
    drift scenarios isolate DISTRIBUTION shift from shape churn, so a
    refresh-on/refresh-off comparison sees identical bucketing and
    batch composition. `tag` must name a registered predictor (the
    stream carries covariates, never raw λ)."""
    from repro_torch.data.synthetic import drift_request_params  # deferred

    if tag == LAM_TAG:
        raise ValueError("drift streams are covariate streams: pass a "
                         "predictor tag, not the raw-lam tag")
    rng = np.random.default_rng(seed)
    denom = max(n_requests - 1, 1)
    reqs = []
    for rid in range(n_requests):
        p = drift_request_params(
            rng, spec, rid / denom, m1=m1, m2=m2, K=K, d_cov=d_cov,
            topic_rate=topic_rate, b_frac=b_frac)
        reqs.append(RankRequest(rid=rid, u=p["u"], a=p["a"], b=p["b"],
                                m2=m2, X=p["X"], tag=tag,
                                gamma=p["gamma"]))
    return reqs


# ---------------------------------------------------------------------------
# Paced open-loop load generation
# ---------------------------------------------------------------------------

def poisson_arrivals(n_requests: int, qps: float, *, seed: int = 0,
                     start: float = 0.0) -> np.ndarray:
    """Arrival times (seconds, relative to the stream start) of a Poisson
    process at rate `qps`: i.i.d. exponential inter-arrival gaps with
    mean 1/qps. The canonical open-loop offered-load model — arrivals do
    not react to the server, and bursts (several requests inside one
    service time) occur with the probability real traffic has."""
    if qps <= 0:
        raise ValueError(f"qps must be > 0, got {qps}")
    rng = np.random.default_rng(seed)
    return start + np.cumsum(rng.exponential(1.0 / qps, int(n_requests)))


def serve_open_loop(engine, requests, arrivals, *,
                    clock=time.perf_counter, sleep=time.sleep,
                    poll_interval_s: float = 5e-4,
                    deadline_budget_s: float | None = None):
    """Drive `engine` open-loop: submit requests[i] once the stream clock
    reaches arrivals[i], never waiting on completions. While pacing
    between arrivals the engine is polled so deadline flushes fire on
    schedule. Returns (results, stats) — stats carries the wall clock
    and the SUBMISSION-LAG profile (ms by which each submit trailed its
    scheduled arrival).

    With `deadline_budget_s` set, every request is stamped with the
    ABSOLUTE deadline `t0 + arrival + deadline_budget_s` before submit
    — the budget runs from the request's scheduled arrival, the way a
    caller-side SLA does. A relative budget (engine default) would
    restart the clock at submit time, silently forgiving any lateness
    the load generator accumulated blocking on engine backpressure —
    exactly the lateness an overloaded server inflicts.

    Open-loop semantics under overload: submission keeps pressing at the
    offered rate; the only thing allowed to slow it down is the engine's
    own backpressure (a full pipeline window blocking `submit`), which
    is exactly the queueing delay a saturated server inflicts — it shows
    up in per-request latency instead of being silently absorbed by the
    load generator, so the measured frontier is honest. Below saturation
    lag stays bounded (sleep-granularity noise); past it, lag grows over
    the stream.

    The lag profile is DECOMPOSED so the saturation detector (and the
    admission controller, which consumes it online via
    `engine.observe_submission_lag`) never trips on pacing jitter:

      queue_lag_ms  lateness already present when the pacing loop REACHES an
                    arrival's pacing loop — carry-over from earlier
                    submits that blocked on engine backpressure. Zero
                    below saturation; grows over the stream past it.
                    `queue_lag_ms['last']` is the saturation telltale.
      drift_ms      lateness accrued INSIDE the pacing wait — sleep
                    granularity overshoot + in-loop poll time. Bounded
                    by the platform timer resolution at any load;
                    charging it to the engine (the pre-decomposition
                    bug) made the detector trip on pacing jitter.
      lag_ms        the sum: total lateness at submit time (kept for
                    continuity with earlier frontier artifacts).
    """
    requests = list(requests)
    arrivals = np.asarray(arrivals, np.float64)
    if len(requests) != len(arrivals):
        raise ValueError(f"{len(requests)} requests vs {len(arrivals)} "
                         f"arrival times")
    if not requests:
        raise ValueError("empty request stream: an open-loop run needs at "
                         "least one arrival")
    feed_lag = getattr(engine, "observe_submission_lag", None)
    results = []
    lags = np.zeros(len(requests))
    queue_lags = np.zeros(len(requests))
    t0 = clock()
    for i, (req, due) in enumerate(zip(requests, arrivals)):
        # lateness at ENTRY is queueing carry-over (earlier submits
        # blocked on backpressure), not pacing noise: nothing in this
        # arrival's own pacing loop has run yet.
        queue_lags[i] = max(0.0, (clock() - t0 - due)) * 1e3
        while clock() - t0 < due:
            results += engine.poll()
            remaining = due - (clock() - t0)
            if remaining > 0:
                sleep(min(remaining, poll_interval_s))
        lags[i] = (clock() - t0 - due) * 1e3
        if feed_lag is not None:
            feed_lag(queue_lags[i])
        if deadline_budget_s is not None:
            req.deadline = t0 + due + deadline_budget_s
        results += engine.submit(req)
        results += engine.poll()
    results += engine.drain()
    wall = clock() - t0
    drifts = lags - queue_lags

    def _profile(xs):
        return {
            "mean": float(xs.mean()),
            "p50": float(np.percentile(xs, 50)),
            "p99": float(np.percentile(xs, 99)),
            "max": float(xs.max()),
            "last": float(xs[-1]),
        }

    stats = {
        "wall_s": wall,
        "offered_qps": len(requests) / float(arrivals[-1]),
        "achieved_qps": len(requests) / wall,
        "lag_ms": _profile(lags),
        "queue_lag_ms": _profile(queue_lags),
        "drift_ms": _profile(drifts),
    }
    return results, stats
