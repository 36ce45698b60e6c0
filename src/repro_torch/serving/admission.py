"""Deadline-aware admission control for the serving engine (the port's
own copy of repro.serving.admission: plain Python over numpy).

The paper's whole premise is serving constrained rankings "within the
required 50 milliseconds" — but an engine without a notion of the
budget will happily queue past saturation and return every answer
late. Production LP-serving systems treat the latency budget as a
first-class admission signal; the online primal-dual view justifies
degrading to a cheaper predictor instead of dropping requests (the
served audit outputs are dual subgradients — compliance is recoverable
downstream), and shedding only when even the cheapest rung would miss.

The controller makes a three-way decision at `submit` time, before a
request ever enters a bucket queue:

  admit    rung 0 — the request's own predictor/bucket — is predicted
           to complete inside the deadline;
  degrade  rung 0 would miss, but a cheaper rung of the request's
           degradation ladder (e.g. KNN -> mean, whose bucket warmup
           already ran) is predicted to
           make it; the request is served from that rung's bucket and
           its compliance cost is accounted per rung;
  shed     every rung would miss: the request's RankFuture resolves
           immediately with a typed `Shed` result (engine.Shed) rather
           than queueing work that is already dead on arrival.

Prediction model (deliberately simple — EWMAs a property-based test
can reason about, not a learned latency model):

    predicted_ms(bucket, q, inflight) =
        lag_ewma                       # online saturation signal: the
                                       # open-loop load's queueing-lag
                                       # profile (serving.traffic
                                       # separates it from pacing
                                       # clock-drift), fed back via
                                       # engine.observe_submission_lag
      + max_wait_ms                    # worst-case assembly wait (the
                                       # deadline-flush bound)
      + inflight * exec_ewma(bucket)   # pipeline window ahead of us
      + exec_ewma(bucket) * (1 + q/B)  # our own batch; a fuller queue
                                       # means a fuller (costlier)
                                       # flush and a busier engine

Every term is monotone non-decreasing in queue depth, in-flight count,
and observed lag — which yields the two invariants
tests/test_torch_admission.py checks with hypothesis:

  * a request admitted at queue depth q is admitted at every depth
    < q (no admit/shed flapping as the queue drains);
  * the chosen degradation rung is monotone non-decreasing in the
    predicted lag (load only ever pushes DOWN the ladder, never back
    up mid-decision).

Service-time EWMAs are seeded by `ServingEngine.warmup` (one timed
phantom batch per bucket, after the first has built the kernels) and
updated online from each retired micro-batch's launch->outputs-home
time, so the controller tracks the live service rate without ever
blocking the hot path.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

__all__ = ["AdmissionController", "AdmissionDecision", "SHED_RUNG"]

# Rung index reported for a shed decision (no rung served).
SHED_RUNG = -1


@dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of one submit-time admission check.

    action        'admit' | 'degrade' | 'shed'
    rung          ladder rung to serve from (0 = the request's own
                  bucket); SHED_RUNG (-1) when shedding
    predicted_ms  predicted completion latency of the chosen rung (for
                  'shed': of the cheapest rung — the best the engine
                  could have done)
    budget_ms     the deadline headroom the decision was made against
    """

    action: str
    rung: int
    predicted_ms: float
    budget_ms: float

    @property
    def admitted(self) -> bool:
        return self.action != "shed"


class AdmissionController:
    """Queue-depth- and EWMA-service-time-aware admission control.

    headroom      fraction of the budget a rung's prediction must fit
                  inside (0.85: leave 15% for unpadding/jitter that the
                  launch->home EWMA cannot see)
    ewma_alpha    smoothing of the per-bucket service-time EWMAs and
                  the submission-lag EWMA
    prior_exec_ms service-time prior for a bucket never yet observed
                  (warmup seeds real values; the prior only matters for
                  traffic hitting an unwarmed bucket)

    Measured-trend ladder (the windowed p99 tracker): per-request
    prediction is optimistic exactly when it matters — under load the
    EWMAs trail the true service rate, so requests keep being admitted
    on rung 0 while measured latency is already blowing budgets. The
    tracker accumulates each result's latency/budget RATIO
    (`observe_result`, fed by the engine at result-build time); every
    `p99_window` results it takes the window p99 and compares it to
    1.0 (= the budget):

      p99 over budget for `p99_patience` CONSECUTIVE windows
          → `default_rung` += 1: first-fit decisions start one rung
            further down the ladder (prediction has been lying — stop
            trusting rung 0);
      p99 under `p99_hysteresis` (strictly BELOW budget, not merely
          at it) for `p99_patience` consecutive windows
          → `default_rung` -= 1.

    The patience requirement plus the hysteresis band is the anti-flap
    design: a transient spike fills at most one window and resets
    nothing permanent, and a p99 hovering between hysteresis·budget
    and budget moves the rung in NEITHER direction.
    `rung_shifts` records every shift (for tests and dashboards).

    Thread-safety: `observe_service` runs on the completion worker,
    `observe_lag` on whichever thread drives the open-loop pacing,
    `observe_result` on whichever consumer thread builds results, and
    `predict_ms`/`decide` on the submission thread — all touch shared
    EWMAs, so updates take a small lock (reads of a stale EWMA are
    harmless; torn dict updates are not).
    """

    def __init__(self, *, headroom: float = 0.85, ewma_alpha: float = 0.25,
                 prior_exec_ms: float = 5.0, p99_window: int = 64,
                 p99_patience: int = 3, p99_hysteresis: float = 0.7,
                 max_default_rung: int = 8):
        if not 0.0 < headroom <= 1.0:
            raise ValueError(f"headroom must be in (0, 1], got {headroom}")
        if not 0.0 < ewma_alpha <= 1.0:
            raise ValueError(f"ewma_alpha must be in (0, 1], got {ewma_alpha}")
        if p99_window < 1:
            raise ValueError(f"p99_window must be >= 1, got {p99_window}")
        if p99_patience < 1:
            raise ValueError(f"p99_patience must be >= 1, got {p99_patience}")
        if not 0.0 < p99_hysteresis < 1.0:
            raise ValueError(f"p99_hysteresis must be in (0, 1), got "
                             f"{p99_hysteresis}")
        self.headroom = float(headroom)
        self.ewma_alpha = float(ewma_alpha)
        self.prior_exec_ms = float(prior_exec_ms)
        self.p99_window = int(p99_window)
        self.p99_patience = int(p99_patience)
        self.p99_hysteresis = float(p99_hysteresis)
        self.max_default_rung = int(max_default_rung)
        self.lag_ms = 0.0
        self.default_rung = 0
        self.rung_shifts: list[tuple[str, int, float]] = []
        self._exec_ms: dict[str, float] = {}
        self._ratio_win: list[float] = []
        self._over_windows = 0
        self._under_windows = 0
        self._lock = threading.Lock()
        # decision tallies (the engine's metrics carry the per-request
        # accounting; these are the controller's own view for debugging)
        self.decisions = {"admit": 0, "degrade": 0, "shed": 0}

    # -- observation --------------------------------------------------------

    def observe_service(self, bucket_name: str, exec_ms: float) -> None:
        """One micro-batch of `bucket_name` took `exec_ms` from launch
        to outputs-home. First observation seeds the EWMA directly."""
        exec_ms = max(0.0, float(exec_ms))
        with self._lock:
            prev = self._exec_ms.get(bucket_name)
            if prev is None:
                self._exec_ms[bucket_name] = exec_ms
            else:
                a = self.ewma_alpha
                self._exec_ms[bucket_name] = (1.0 - a) * prev + a * exec_ms

    def observe_lag(self, lag_ms: float) -> None:
        """Feed the open-loop load generator's QUEUEING lag (not pacing
        clock-drift — serving.traffic.serve_open_loop separates the
        two) as the online saturation signal."""
        lag_ms = max(0.0, float(lag_ms))
        with self._lock:
            a = self.ewma_alpha
            self.lag_ms = (1.0 - a) * self.lag_ms + a * lag_ms

    def observe_result(self, latency_ms: float, budget_ms: float) -> None:
        """One served result's MEASURED latency against its own budget
        — the windowed p99 tracker's feed (see class doc). Called by
        the engine at result-build time; requests without a positive
        budget are skipped (nothing to compare against)."""
        if budget_ms <= 0.0:
            return
        with self._lock:
            self._ratio_win.append(float(latency_ms) / float(budget_ms))
            if len(self._ratio_win) < self.p99_window:
                return
            r99 = float(np.percentile(self._ratio_win, 99))
            self._ratio_win = []
            if r99 > 1.0:
                self._over_windows += 1
                self._under_windows = 0
                if (self._over_windows >= self.p99_patience
                        and self.default_rung < self.max_default_rung):
                    self.default_rung += 1
                    self._over_windows = 0
                    self.rung_shifts.append(("down", self.default_rung, r99))
            elif r99 < self.p99_hysteresis:
                self._under_windows += 1
                self._over_windows = 0
                if (self._under_windows >= self.p99_patience
                        and self.default_rung > 0):
                    self.default_rung -= 1
                    self._under_windows = 0
                    self.rung_shifts.append(("up", self.default_rung, r99))
            else:
                # the hysteresis band: neither trend accumulates.
                self._over_windows = 0
                self._under_windows = 0

    def service_ms(self, bucket_name: str) -> float:
        with self._lock:
            return self._exec_ms.get(bucket_name, self.prior_exec_ms)

    # -- prediction + decision ----------------------------------------------

    def predict_ms(self, bucket_name: str, *, queue_len: int, batch_cap: int,
                   inflight: int, max_wait_ms: float) -> float:
        """Predicted completion latency (ms) for a request joining
        `bucket_name`'s queue now. Monotone non-decreasing in
        queue_len, inflight, and the observed lag EWMA — the admission
        invariants depend on exactly this."""
        exec_ms = self.service_ms(bucket_name)
        fill = queue_len / max(1, batch_cap)
        return (self.lag_ms
                + float(max_wait_ms)
                + max(0, inflight) * exec_ms
                + exec_ms * (1.0 + fill))

    def decide(self, *, budget_ms: float,
               rung_predictions) -> AdmissionDecision:
        """Pick the FIRST (highest-quality) rung whose prediction fits
        inside headroom * budget; shed when none does.

        rung_predictions: [(rung_index, predicted_ms)] ordered rung 0
        first. First-fit makes the chosen rung monotone non-decreasing
        in any uniform lag shift: a rung that fits under more lag also
        fit under less.

        The measured-trend floor: rungs above `default_rung` (shifted
        by the windowed p99 tracker) are skipped — when trailing
        MEASURED p99 has been blowing budgets, per-request prediction
        has lost the benefit of the doubt. A ladder too short to reach
        the floor keeps its deepest rung eligible (the floor degrades,
        it never turns into a shed).
        """
        rung_predictions = list(rung_predictions)
        if not rung_predictions:
            raise ValueError("decide() needs at least rung 0")
        with self._lock:
            floor = self.default_rung
        eligible = [(r, p) for r, p in rung_predictions if r >= floor]
        if not eligible:
            eligible = [rung_predictions[-1]]
        limit = self.headroom * float(budget_ms)
        for rung, predicted in eligible:
            if predicted <= limit:
                action = "admit" if rung == 0 else "degrade"
                self.decisions[action] += 1
                return AdmissionDecision(action, rung, float(predicted),
                                         float(budget_ms))
        self.decisions["shed"] += 1
        cheapest = min(p for _, p in eligible)
        return AdmissionDecision("shed", SHED_RUNG, float(cheapest),
                                 float(budget_ms))
