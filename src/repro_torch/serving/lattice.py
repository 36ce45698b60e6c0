"""Adaptive bucket lattice of the port (counterpart of
repro.serving.lattice): traffic-learned shapes, padded-work accounting
and trough-time shadow re-warm.

The static power-of-two lattice (serving.buckets) rounds every request
up to the next (m1, m2, K) corner; on skewed traffic that rounding pads
a surface serving m1 ~ 520 candidates to 1024, so about half the rank
sweep's work and the staged bytes of every batch are padding. This
module closes the loop:

  ShapeHistogram   exact per-(tag, surface, m1, m2, K, d_cov) counts with
                   decayed EWMA weights, fed by the engine at enqueue (a
                   dict update a request, no device reads). Saved as JSON
                   in the JAX package's format, so a histogram saved by
                   either package loads in the other.

  optimize_lattice a greedy corner chooser over the histogram: start from
                   the power-of-two grouping, shrink each group's corner
                   to the aligned cover of the shapes it serves, merge
                   groups while over the budget and split the wasteful
                   ones along histogram quantiles while under it. The
                   objective is the expected padded work a request (rank
                   m1*m2 + audit K*m1 cells, plus the amortized db sweep).
                   Every observed shape stays covered, the corner count
                   never exceeds the budget, and the expected padded work
                   never exceeds the power-of-two lattice's whenever that
                   lattice fits the budget.

  TroughDetector   arrival-rate EWMA and the submission-lag EWMA; a
                   trough is both quiet for a patience window. A re-warm
                   allocates rings and runs phantom batches, host work
                   that would compete with assembly mid-rush.

  LatticeLane      the background re-warm lane (RefreshLane's sibling):
                   propose a lattice from the live histogram, have the
                   engine warm its corners off the dispatch path
                   (engine.shadow_warm_lattice), then flip lattice and
                   warmed set under the engine's swap lock
                   (engine.swap_lattice: epoch-fenced, monotone; every
                   served row carries RankResult.lattice_epoch). Any
                   failure rolls back to last-good: nothing flipped,
                   serving never paused, and metrics.lattice_rollbacks
                   counts it.

On the card nothing compiles per shape. What a corner needs is its
StagingRing (page-locked host slots and device sets), an affine
predictor's W and c padded to the corner's K, and a first launch at the
new geometry. `compiles_post_warmup` counts rings allocated on the
dispatch path after warmup, and must stay 0 across any stream inside the
warmed lattice; corners warmed by a shadow warm count as
`metrics.shadow_compiles`.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from dataclasses import dataclass, field

from repro_torch.serving.buckets import MIN_M1, MIN_M2, Bucket, bucket_for

__all__ = [
    "DEFAULT_HISTOGRAM_PATH",
    "LatticeLane",
    "Lattice",
    "ShapeHistogram",
    "TroughDetector",
    "expected_padded_work",
    "optimize_lattice",
    "padded_work",
    "padding_waste",
]

# the JAX package's path for the histogram file
DEFAULT_HISTOGRAM_PATH = "experiments/bench/shape_histogram.json"

# Adaptive-corner alignment: m1 to 64, m2 to 8, K to 4. The floors match
# the static lattice's, so an adaptive corner is never smaller than the
# smallest shape the kernels see there.
ALIGN_M1, ALIGN_M2, ALIGN_K = 64, 8, 4
FLOOR_K = 4


def _align_up(n: int, align: int, floor: int) -> int:
    n = max(int(n), int(floor))
    return ((n + align - 1) // align) * align


# ---------------------------------------------------------------------------
# Padded-work model
# ---------------------------------------------------------------------------

def padded_work(m1: int, m2: int, K: int, *, d_cov: int = 0,
                n_db: int = 0, batch: int = 1) -> float:
    """Analytic work of serving one request at geometry (m1, m2, K): the
    rank sweep touches m1*m2 score cells, the audit reads K*m1 attribute
    cells, and a KNN bucket amortizes its db sweep (n_db rows x d_cov
    f32) over the micro-batch. Relative, not absolute: the optimizer only
    compares corners."""
    work = float(m1) * float(m2) + float(K) * float(m1)
    if n_db and d_cov and batch:
        work += (float(n_db) * float(d_cov) * 4.0) / float(batch)
    return work


# ---------------------------------------------------------------------------
# The lattice
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class Lattice:
    """A set of (m1, m2, K) bucket corners, or the power-of-two default.

    `corners=None` is the static power-of-two lattice (exactly
    buckets.bucket_for: every engine's boot lattice). An adaptive lattice
    routes each request to its cheapest covering corner and falls back
    to the power-of-two ceiling for a shape outside every corner, so
    routing is total.
    """

    corners: tuple | None = None      # ((m1, m2, K), ...) or None = pow2
    epoch: int = 0                    # a label; the engine owns the epoch

    @property
    def adaptive(self) -> bool:
        return self.corners is not None

    def validate(self) -> None:
        """Structural check (the swap's first gate): every corner is a
        well-posed ranking geometry. Raises ValueError otherwise."""
        if self.corners is None:
            return
        if not self.corners:
            raise ValueError("adaptive lattice with zero corners")
        for c in self.corners:
            if len(c) != 3:
                raise ValueError(f"corner {c!r}: need (m1, m2, K)")
            m1, m2, K = (int(x) for x in c)
            if m1 <= 0 or m2 <= 0 or K <= 0:
                raise ValueError(f"corner {c!r}: non-positive dimension")
            if m2 > m1:
                raise ValueError(f"corner {c!r}: m2 > m1 is not a "
                                 f"well-posed ranking problem")

    def covering_corner(self, m1: int, m2: int, K: int):
        """The cheapest corner covering (m1, m2, K), or None."""
        if not self.corners:
            return None
        best, best_cost = None, math.inf
        for c in self.corners:
            c1, c2, c3 = c
            if c1 >= m1 and c2 >= m2 and c3 >= K:
                cost = padded_work(c1, c2, c3)
                if cost < best_cost:
                    best, best_cost = c, cost
        return best

    def bucket_for(self, *, m1: int, m2: int, K: int, tag: str,
                   batch: int) -> Bucket:
        """Route a request geometry: the cheapest covering corner, else
        the power-of-two fallback (the static lattice's bucket)."""
        if m2 > m1:
            raise ValueError(f"request needs m2 <= m1, got m2={m2} > "
                             f"m1={m1}")
        c = self.covering_corner(m1, m2, K)
        if c is None:
            return bucket_for(m1=m1, m2=m2, K=K, tag=tag, batch=batch)
        return Bucket(tag=tag, m1=int(c[0]), m2=int(c[1]), K=int(c[2]),
                      batch=int(batch))


# ---------------------------------------------------------------------------
# Shape-histogram telemetry
# ---------------------------------------------------------------------------

class ShapeHistogram:
    """Exact per-(tag, surface, m1, m2, K, d_cov) arrival counts with a
    decayed EWMA weight per cell.

    The EWMA clock is the observation counter, not wall time: each
    arrival discounts every cell's weight by `decay` per observation
    since that cell was last touched (applied lazily, so observe stays
    O(1)). Replaying a stream reproduces the histogram bit for bit.
    """

    def __init__(self, *, decay: float = 0.999):
        if not (0.0 < decay <= 1.0):
            raise ValueError(f"decay must be in (0, 1], got {decay}")
        self.decay = float(decay)
        self._cells: dict[tuple, dict] = {}
        self._t = 0

    def observe(self, *, tag: str, m1: int, m2: int, K: int,
                d_cov: int | None = None, surface: str = "default",
                weight: float = 1.0) -> None:
        self._t += 1
        key = (str(tag), str(surface), int(m1), int(m2), int(K),
               -1 if d_cov is None else int(d_cov))
        cell = self._cells.get(key)
        if cell is None:
            cell = self._cells[key] = {"count": 0, "ewma": 0.0,
                                       "t": self._t}
        cell["ewma"] = (cell["ewma"] * self.decay ** (self._t - cell["t"])
                        + float(weight))
        cell["t"] = self._t
        cell["count"] += 1

    @property
    def total(self) -> int:
        """Total observations ever (the EWMA clock)."""
        return self._t

    def __len__(self) -> int:
        return len(self._cells)

    def shapes(self, *, min_weight: float = 0.0) -> list:
        """[(tag, surface, m1, m2, K, d_cov, weight)] with every cell's
        EWMA decayed to now; d_cov is None for lambda-given cells."""
        out = []
        for key, cell in list(self._cells.items()):
            w = cell["ewma"] * self.decay ** (self._t - cell["t"])
            if w < min_weight:
                continue
            tag, surface, m1, m2, K, d = key
            out.append((tag, surface, m1, m2, K,
                        None if d < 0 else d, w))
        out.sort(key=lambda s: (s[0], s[1], s[2], s[3], s[4]))
        return out

    def geometry_weights(self) -> dict:
        """{(m1, m2, K): weight} summed over tags and surfaces: the
        optimizer's view (corners are tag-independent)."""
        agg: dict[tuple, float] = {}
        for _, _, m1, m2, K, _, w in self.shapes():
            agg[(m1, m2, K)] = agg.get((m1, m2, K), 0.0) + w
        return agg

    # -- serialization ------------------------------------------------------

    def snapshot(self) -> dict:
        return {
            "version": 1,
            "decay": self.decay,
            "t": self._t,
            "cells": [
                {"tag": k[0], "surface": k[1], "m1": k[2], "m2": k[3],
                 "K": k[4], "d_cov": k[5], **c}
                for k, c in sorted(self._cells.items())
            ],
        }

    def save(self, path: str = DEFAULT_HISTOGRAM_PATH) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)
        return path

    @classmethod
    def load(cls, path: str = DEFAULT_HISTOGRAM_PATH) -> "ShapeHistogram":
        """Load a saved histogram; empty when the file is absent."""
        hist = cls()
        if not os.path.exists(path):
            return hist
        with open(path) as f:
            payload = json.load(f)
        hist.decay = float(payload.get("decay", hist.decay))
        hist._t = int(payload.get("t", 0))
        for c in payload.get("cells", ()):
            key = (str(c["tag"]), str(c["surface"]), int(c["m1"]),
                   int(c["m2"]), int(c["K"]), int(c["d_cov"]))
            hist._cells[key] = {"count": int(c["count"]),
                                "ewma": float(c["ewma"]),
                                "t": int(c["t"])}
        return hist


# ---------------------------------------------------------------------------
# The lattice optimizer
# ---------------------------------------------------------------------------

def _cover(shapes) -> tuple:
    """The aligned componentwise-max corner of a shape group."""
    m1 = _align_up(max(s[0] for s in shapes), ALIGN_M1, MIN_M1)
    m2 = _align_up(max(s[1] for s in shapes), ALIGN_M2, MIN_M2)
    K = _align_up(max(s[2] for s in shapes), ALIGN_K, FLOOR_K)
    return (m1, min(m2, m1), K)


def expected_padded_work(lattice: Lattice, weights: dict, *,
                         batch: int = 1, d_cov: int = 0,
                         n_db: int = 0) -> float:
    """Expected padded work a request of serving `weights`
    ({(m1, m2, K): weight}) on `lattice`: the optimizer's objective and
    padding_waste's numerator."""
    total = 0.0
    for (m1, m2, K), w in weights.items():
        bk = lattice.bucket_for(m1=m1, m2=m2, K=K, tag="_", batch=batch)
        total += w * padded_work(bk.m1, bk.m2, bk.K, d_cov=d_cov,
                                 n_db=n_db, batch=batch)
    return total


def padding_waste(lattice: Lattice, weights: dict, *,
                  batch: int = 1) -> float:
    """Padded over real work (>= 1.0) of serving `weights` on `lattice`,
    computed from the histogram rather than from live counters."""
    real = sum(w * padded_work(m1, m2, K)
               for (m1, m2, K), w in weights.items())
    if real <= 0.0:
        return float("nan")
    return expected_padded_work(lattice, weights, batch=batch) / real


def _route_cost(corners: list, weights: dict, batch: int = 1) -> float:
    """Optimizer objective: expected routing work plus each corner's
    batch fragmentation. Every live corner drains on average half a
    partial micro-batch of padding a serving window, so a split must buy
    more routing work than the batch/2 padded rows it adds."""
    lat = Lattice(corners=tuple(corners))
    cost = expected_padded_work(lat, weights)
    if batch > 1:
        cost += (batch / 2.0) * sum(padded_work(*c) for c in corners)
    return cost


def _quantile_cuts(values: list, max_cuts: int = 16) -> list:
    """Candidate cut points: every distinct boundary when few, weighted
    quantiles when many."""
    distinct = sorted(set(values))
    if len(distinct) <= max_cuts + 1:
        return distinct[:-1]          # cut after each value but the max
    step = len(distinct) / (max_cuts + 1)
    return [distinct[int(step * (i + 1)) - 1] for i in range(max_cuts)]


def optimize_lattice(hist: ShapeHistogram | dict, *,
                     max_executables: int = 16,
                     min_weight: float = 0.0,
                     batch: int = 1) -> Lattice:
    """Pick bucket corners for the observed traffic.

    (1) group shapes by their power-of-two corner and shrink each corner
    to the aligned cover of its members; (2) while over the budget,
    merge the pair of corners whose union costs least; (3) while under
    it, split the group whose best quantile cut saves the most, where a
    corner's cost includes batch/2 padded rows of fragmentation (pass
    the engine's max_batch). Every observed shape stays covered, the
    corner count never exceeds `max_executables` (the name is the JAX
    package's: a budget of warmed corners), and whenever the
    power-of-two lattice fits the budget the result's expected padded
    work is at most its.

    `hist` is a ShapeHistogram or a {(m1, m2, K): weight} dict. An empty
    histogram gives the power-of-two lattice.
    """
    if max_executables < 1:
        raise ValueError(f"max_executables must be >= 1, got "
                         f"{max_executables}")
    weights = (hist.geometry_weights() if isinstance(hist, ShapeHistogram)
               else dict(hist))
    if min_weight > 0.0:
        kept = {s: w for s, w in weights.items() if w >= min_weight}
        weights = kept or weights     # never drop everything
    if not weights:
        return Lattice(corners=None)

    # 1) power-of-two grouping, then shrink each corner to its cover
    pow2 = Lattice(corners=None)
    groups: dict[Bucket, list] = {}
    for shape in weights:
        m1, m2, K = shape
        bk = pow2.bucket_for(m1=m1, m2=m2, K=K, tag="_", batch=1)
        groups.setdefault(bk, []).append(shape)
    members: list[list] = [sorted(g) for g in groups.values()]
    corners: list[tuple] = [_cover(g) for g in members]

    # 2) merge while over budget (cheapest union first)
    while len(corners) > max_executables:
        best, best_cost = None, math.inf
        for i in range(len(corners)):
            for j in range(i + 1, len(corners)):
                merged = _cover(members[i] + members[j])
                trial = ([c for k, c in enumerate(corners)
                          if k not in (i, j)] + [merged])
                cost = _route_cost(trial, weights, batch)
                if cost < best_cost:
                    best, best_cost = (i, j, merged), cost
        i, j, merged = best
        members[i] = sorted(members[i] + members[j])
        corners[i] = merged
        del members[j], corners[j]

    # 3) split while under budget (largest quantile-cut saving first)
    while len(corners) < max_executables:
        cost_now = _route_cost(corners, weights, batch)
        best, best_cost = None, cost_now
        for gi, group in enumerate(members):
            if len(group) < 2:
                continue
            for axis in (0, 1, 2):
                for cut in _quantile_cuts([s[axis] for s in group]):
                    lo = [s for s in group if s[axis] <= cut]
                    hi = [s for s in group if s[axis] > cut]
                    if not lo or not hi:
                        continue
                    trial = ([c for k, c in enumerate(corners) if k != gi]
                             + [_cover(lo), _cover(hi)])
                    cost = _route_cost(trial, weights, batch)
                    if cost < best_cost:
                        best, best_cost = (gi, lo, hi), cost
        if best is None:              # no improving split anywhere
            break
        gi, lo, hi = best
        members[gi] = lo
        corners[gi] = _cover(lo)
        members.append(hi)
        corners.append(_cover(hi))

    return Lattice(corners=tuple(sorted(set(corners))))


# ---------------------------------------------------------------------------
# Trough detection
# ---------------------------------------------------------------------------

@dataclass
class TroughDetector:
    """Arrival-rate EWMA and the submission-lag EWMA with a patience
    window: `in_trough(now)` is True only once both signals have been
    quiet for `patience_s` straight. A backed-up engine is never in a
    trough however slow arrivals look: its backlog needs the host cycles
    a re-warm would take."""

    rate_threshold_qps: float = 100.0
    lag_threshold_ms: float = 5.0
    patience_s: float = 0.5
    alpha: float = 0.2                # EWMA weight of each new sample

    _gap_ewma_s: float | None = field(default=None, repr=False)
    _lag_ewma_ms: float = field(default=0.0, repr=False)
    _last_arrival: float | None = field(default=None, repr=False)
    _quiet_since: float | None = field(default=None, repr=False)

    def observe_arrival(self, now: float) -> None:
        if self._last_arrival is not None:
            gap = max(now - self._last_arrival, 1e-9)
            self._gap_ewma_s = (gap if self._gap_ewma_s is None else
                                (1.0 - self.alpha) * self._gap_ewma_s
                                + self.alpha * gap)
        self._last_arrival = now
        self._update_quiet(now)

    def observe_lag(self, lag_ms: float) -> None:
        self._lag_ewma_ms = ((1.0 - self.alpha) * self._lag_ewma_ms
                             + self.alpha * float(lag_ms))

    def rate_qps(self, now: float) -> float:
        """The smoothed arrival rate, with the time since the last
        arrival folded in, so a stream that stopped decays towards 0."""
        if self._last_arrival is None or self._gap_ewma_s is None:
            return 0.0
        gap = max(self._gap_ewma_s, now - self._last_arrival, 1e-9)
        return 1.0 / gap

    def _quiet(self, now: float) -> bool:
        return (self.rate_qps(now) < self.rate_threshold_qps
                and self._lag_ewma_ms < self.lag_threshold_ms)

    def _update_quiet(self, now: float) -> None:
        if self._quiet(now):
            if self._quiet_since is None:
                self._quiet_since = now
        else:
            self._quiet_since = None

    def in_trough(self, now: float) -> bool:
        self._update_quiet(now)
        return (self._quiet_since is not None
                and now - self._quiet_since >= self.patience_s)


# ---------------------------------------------------------------------------
# The shadow re-warm lane
# ---------------------------------------------------------------------------

class LatticeLane:
    """Background lattice re-warm lane for one ServingEngine.

    The engine feeds the lane's trough detector arrival times at enqueue
    and lag samples through observe_submission_lag; `maybe_rewarm(now)`
    (from a serving loop or the `start()` thread) proposes a lattice from
    the live histogram when the detector reports a trough and enough new
    traffic has arrived, warms it off the dispatch path and flips it.
    Any failure (validation, a ring or phantom batch that fails, a
    poisoned proposal) rolls back to last-good: nothing flips, and
    metrics.lattice_rollbacks counts it.
    """

    def __init__(self, engine, *, max_executables: int = 16,
                 min_samples: int = 64, detector: TroughDetector | None = None,
                 histogram_path: str | None = None):
        self.engine = engine
        self.max_executables = int(max_executables)
        self.min_samples = int(min_samples)
        self.detector = detector if detector is not None else TroughDetector()
        self.histogram_path = histogram_path
        self._lock = threading.Lock()   # serializes rewarm attempts
        self._samples_at_last = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        engine.attach_lattice_lane(self)

    # -- telemetry feeds (engine seam) --------------------------------------

    def observe_arrival(self, now: float) -> None:
        self.detector.observe_arrival(now)

    def observe_lag(self, lag_ms: float) -> None:
        self.detector.observe_lag(lag_ms)

    # -- proposing / re-warming ---------------------------------------------

    def propose(self) -> Lattice:
        """The optimizer's lattice for the engine's live histogram, with
        split fragmentation priced at the engine's micro-batch."""
        return optimize_lattice(self.engine.shape_histogram,
                                max_executables=self.max_executables,
                                batch=self.engine.max_batch)

    def maybe_rewarm(self, now: float | None = None) -> dict:
        """One lane tick: re-warm iff the detector reports a trough and
        at least `min_samples` observations arrived since the last
        attempt. Returns a report (swapped: bool, reason: str)."""
        now = time.perf_counter() if now is None else now
        hist = self.engine.shape_histogram
        if hist.total - self._samples_at_last < self.min_samples:
            return {"swapped": False, "reason": "too-few-samples"}
        if not self.detector.in_trough(now):
            return {"swapped": False, "reason": "no-trough"}
        return self.rewarm()

    def rewarm(self) -> dict:
        """One shadow re-warm attempt now, without the trough check.
        Serialized: a second caller waits for the first attempt."""
        with self._lock:
            self._samples_at_last = self.engine.shape_histogram.total
            proposal = self.propose()
            live = self.engine.lattice()
            if proposal.corners == live.corners:
                return {"swapped": False, "reason": "no-change",
                        "epoch": self.engine.lattice_epoch()}
            try:
                report = self.engine.rewarm_lattice(proposal)
            except BaseException as e:          # noqa: BLE001
                # nothing flipped: the live lattice and its warmed
                # corners keep serving, so the rollback is a no-op
                self.engine.metrics.on_lattice_rollback()
                return {"swapped": False,
                        "reason": f"rewarm-failed: {type(e).__name__}: {e}",
                        "epoch": self.engine.lattice_epoch()}
            if self.histogram_path:
                self.engine.shape_histogram.save(self.histogram_path)
            return {"swapped": True, "epoch": report["epoch"],
                    "corners": proposal.corners,
                    "warm_ms": report["warm_ms"],
                    "buckets": report["buckets"]}

    # -- background thread ----------------------------------------------------

    def start(self, interval_s: float = 0.25) -> None:
        """Run `maybe_rewarm` every `interval_s` on a daemon thread. A
        crash inside one tick counts as a rollback and the lane keeps
        ticking; serving is never interrupted."""
        if self._thread is not None:
            raise RuntimeError("lattice lane already started")
        self._stop.clear()

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.maybe_rewarm()
                except BaseException:           # noqa: BLE001
                    self.engine.metrics.on_lattice_rollback()

        self._thread = threading.Thread(target=loop, name="lattice-lane",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
