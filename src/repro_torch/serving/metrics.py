"""Serving-engine counters, percentiles and pipeline stage timelines
(counterpart of repro.serving.metrics.EngineMetrics, key for key).

The compile counters keep the JAX names with the card's meaning: nothing
compiles per shape on the card, and what a bucket corner needs is its
StagingRing (page-locked host slots and device sets). `compiles` counts
rings built through the engine's `_executor_for` (warmup and the
dispatch path), `compiles_post_warmup` those built on the dispatch path
after warmup (the contract: it stays 0 for traffic inside the warmed
lattice), and `shadow_compiles` corners warmed off the dispatch path by
a shadow warm.

Recording is split the way the engine is: `on_dispatch` fires on the
submission thread when a micro-batch is assembled and launched,
`on_retire` on the completion worker when its outputs are home, and
`on_result` on whichever consumer thread builds a result. The counters
the worker and the consumers update take a lock.
"""

from __future__ import annotations

import threading
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np


@dataclass
class EngineMetrics:
    requests: int = 0
    results: int = 0
    batches: int = 0
    # dispatcher calls outside warmup: one per flushed micro-batch
    executable_calls: int = 0
    # kernel launches those calls made (kernels.ops.kernel_launch_count
    # of the bucket's route: 1 lambda-given, 2 KNN, 0 on the plain path)
    kernel_launches: int = 0
    bucket_hits: dict = field(default_factory=lambda: defaultdict(int))
    compiles: int = 0                 # corners' rings built, ever
    compiles_post_warmup: int = 0     # ... on the dispatch path after warmup
    warmed: bool = False
    oversize_requests: int = 0        # fell outside the warmed buckets
    capacity_flushes: int = 0
    deadline_flushes: int = 0
    drain_flushes: int = 0
    # padding: cells are batch x m1 rows, flops the rank+audit sweep
    # work (m1*m2 + K*m1 per request against the bucket corner's)
    real_cells: int = 0
    padded_cells: int = 0
    real_flops: int = 0
    padded_flops: int = 0
    # pipeline stage timelines (per micro-batch, ms)
    assembly_ms: list = field(default_factory=list)  # host packing
    dispatch_ms: list = field(default_factory=list)  # copies + launch enqueued
    exec_ms: list = field(default_factory=list)      # launch -> outputs home
    queue_depth: list = field(default_factory=list)  # in flight at dispatch
    # serving window (for the overlap ratio): first dispatch, last retire
    t_first_dispatch: float | None = None
    t_last_retire: float | None = None
    compliant_sum: float = 0.0
    latencies_ms: list = field(default_factory=list)
    queue_wait_ms: list = field(default_factory=list)
    # deadlines: every result is checked against its request's absolute
    # deadline when it is built; sheds and degrades are the admission
    # controller's submit-time decisions. rung_stats accumulates, per
    # degradation rung served, compliance and the exposure shortfall
    # sum(max(b - exposure, 0)).
    deadline_hits: int = 0
    deadline_misses: int = 0
    sheds: int = 0
    degrades: int = 0
    rung_stats: dict = field(default_factory=lambda: defaultdict(
        lambda: {"served": 0, "compliant": 0.0, "shortfall": 0.0}))
    # every deadline outcome also lands in its request's surface class
    surface_stats: dict = field(default_factory=lambda: defaultdict(
        lambda: {"hits": 0, "misses": 0, "sheds": 0, "degrades": 0}))
    # predictor hot swap: swaps = generations published and flipped
    # (engine.swap_predictor successes); refresh_failures = refresh
    # attempts whose state the engine refused, or that crashed in the
    # lane, serving staying on last-good each time; states_retired =
    # superseded generations let go after their last pinned batch
    # retired. swap_validate_ms / swap_flip_ms: each swap's host time
    # checking the new state (shapes, dtypes, finiteness on the device,
    # one sync) and flipping it live (the engine's stream waits for the
    # writer's, then the (state, epoch) pair changes under the lock).
    swaps: int = 0
    refresh_failures: int = 0
    states_retired: int = 0
    swaps_by_tag: dict = field(default_factory=lambda: defaultdict(int))
    swap_validate_ms: list = field(default_factory=list)
    swap_flip_ms: list = field(default_factory=list)
    # the adaptive lattice: lattice_swaps = lattices flipped live
    # (engine.swap_lattice successes); lattice_rollbacks = re-warm
    # attempts that failed, serving staying on the last-good lattice;
    # shadow_compiles = corners warmed by shadow_warm_lattice;
    # shadow_warm_ms = wall time of each shadow-warm window
    lattice_swaps: int = 0
    lattice_rollbacks: int = 0
    shadow_compiles: int = 0
    shadow_warm_ms: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock,
                                  repr=False)

    # -- recording ----------------------------------------------------------

    def on_submit(self, bucket, known: bool) -> None:
        self.requests += 1
        self.bucket_hits[bucket.name] += 1
        if self.warmed and not known:
            self.oversize_requests += 1

    def on_compile(self, in_warmup: bool = False) -> None:
        """A bucket corner's ring was built. Builds inside warmup never
        count against the post-warmup contract; only those forced by
        traffic (an unwarmed bucket hit by a live request) do."""
        with self._lock:
            self.compiles += 1
            if self.warmed and not in_warmup:
                self.compiles_post_warmup += 1

    def on_executable_call(self, kernel_launches: int) -> None:
        self.executable_calls += 1
        self.kernel_launches += kernel_launches

    def on_dispatch(self, trigger: str, fill: dict, *, assembly_ms: float,
                    dispatch_ms: float, depth: int, t_now: float) -> None:
        """Submission side: a micro-batch was assembled and launched."""
        self.batches += 1
        self.assembly_ms.append(assembly_ms)
        self.dispatch_ms.append(dispatch_ms)
        self.queue_depth.append(depth)
        if trigger == "capacity":
            self.capacity_flushes += 1
        elif trigger == "deadline":
            self.deadline_flushes += 1
        else:
            self.drain_flushes += 1
        self.real_cells += fill["real_cells"]
        self.padded_cells += fill["padded_cells"]
        self.real_flops += fill["real_flops"]
        self.padded_flops += fill["padded_flops"]
        if self.t_first_dispatch is None:
            self.t_first_dispatch = t_now

    def on_retire(self, exec_ms: float, t_now: float) -> None:
        """Completion side: a micro-batch's outputs reached the host."""
        with self._lock:
            self.exec_ms.append(exec_ms)
            self.t_last_retire = t_now

    def on_result(self, latency_ms: float, wait_ms: float,
                  compliant: bool, *, deadline_hit: bool | None = None,
                  rung: int = 0, shortfall: float = 0.0,
                  surface: str = "default") -> None:
        with self._lock:
            self.results += 1
            self.latencies_ms.append(latency_ms)
            self.queue_wait_ms.append(wait_ms)
            self.compliant_sum += float(compliant)
            if deadline_hit is not None:
                if deadline_hit:
                    self.deadline_hits += 1
                    self.surface_stats[surface]["hits"] += 1
                else:
                    self.deadline_misses += 1
                    self.surface_stats[surface]["misses"] += 1
            rs = self.rung_stats[int(rung)]
            rs["served"] += 1
            rs["compliant"] += float(compliant)
            rs["shortfall"] += float(shortfall)

    def on_shed(self, bucket, *, surface: str = "default") -> None:
        """Submission side: a request was shed at admission (its future
        resolved with a typed Shed; it entered no queue)."""
        with self._lock:
            self.sheds += 1
            self.surface_stats[surface]["sheds"] += 1

    def on_degrade(self, rung: int, *, surface: str = "default") -> None:
        """Submission side: a request was admitted on a cheaper rung of
        its degradation ladder."""
        with self._lock:
            self.degrades += 1
            self.surface_stats[surface]["degrades"] += 1

    def on_swap(self, tag: str, *, validate_ms: float,
                flip_ms: float) -> None:
        """A new predictor generation was published and flipped live
        (engine.swap_predictor succeeded)."""
        with self._lock:
            self.swaps += 1
            self.swaps_by_tag[tag] += 1
            self.swap_validate_ms.append(validate_ms)
            self.swap_flip_ms.append(flip_ms)

    def on_refresh_failure(self, tag: str) -> None:
        """A refresh attempt failed (state the engine refused, or a
        crash inside the lane): serving kept the last-good generation."""
        with self._lock:
            self.refresh_failures += 1

    def on_state_retired(self, tag: str) -> None:
        """A superseded predictor generation was let go (its last pinned
        batch retired)."""
        with self._lock:
            self.states_retired += 1

    def on_shadow_compile(self) -> None:
        """A corner was warmed off the dispatch path, in a shadow-warm
        window (never counted in compiles_post_warmup)."""
        with self._lock:
            self.shadow_compiles += 1

    def on_lattice_swap(self, epoch: int, *, warm_ms: float = 0.0) -> None:
        """A lattice was shadow-warmed and flipped live."""
        with self._lock:
            self.lattice_swaps += 1
            if warm_ms:
                self.shadow_warm_ms.append(float(warm_ms))

    def on_lattice_rollback(self) -> None:
        """A re-warm attempt failed: serving kept the last-good lattice
        and its warm corners."""
        with self._lock:
            self.lattice_rollbacks += 1

    # -- reporting ----------------------------------------------------------

    @staticmethod
    def _pct(xs, qs=(50, 95, 99)):
        if not xs:
            return {f"p{q}": float("nan") for q in qs}
        arr = np.asarray(xs)
        return {f"p{q}": float(np.percentile(arr, q)) for q in qs}

    def overlap_ratio(self) -> float:
        """How much pipelining compressed the serving window: 1 - wall /
        serial, where serial lays the stages end to end (sum of
        assembly, dispatch and launch-to-home times) and wall runs from
        the first dispatch to the last retire. 0 is fully serial (depth
        0); towards 1, host assembly ran under the card's work. Only
        meaningful for back-to-back streams: arrival gaps inflate the
        wall."""
        if self.t_first_dispatch is None or self.t_last_retire is None:
            return 0.0
        serial = (sum(self.assembly_ms) + sum(self.dispatch_ms)
                  + sum(self.exec_ms))
        wall = (self.t_last_retire - self.t_first_dispatch) * 1e3
        if serial <= 0.0 or wall <= 0.0:
            return 0.0
        return max(0.0, min(1.0, 1.0 - wall / serial))

    def summary(self) -> dict:
        nan = float("nan")
        return {
            "requests": self.requests,
            "results": self.results,
            "batches": self.batches,
            "executable_calls": self.executable_calls,
            "dispatches_per_batch":
                self.executable_calls / self.batches if self.batches else nan,
            "kernel_launches": self.kernel_launches,
            "kernel_launches_per_batch":
                self.kernel_launches / self.batches if self.batches else nan,
            "buckets_used": len(self.bucket_hits),
            "compiles": self.compiles,
            "compiles_post_warmup": self.compiles_post_warmup,
            "oversize_requests": self.oversize_requests,
            "flushes": {"capacity": self.capacity_flushes,
                        "deadline": self.deadline_flushes,
                        "drain": self.drain_flushes},
            "fill_rate": self.real_cells / self.padded_cells
                         if self.padded_cells else nan,
            "padding": self.padding_summary(),
            "latency_ms": self._pct(self.latencies_ms),
            "queue_wait_ms": self._pct(self.queue_wait_ms),
            "pipeline": {
                "assembly_ms_per_batch": self._pct(self.assembly_ms),
                "dispatch_ms_per_batch": self._pct(self.dispatch_ms),
                "exec_ms_per_batch": self._pct(self.exec_ms),
                "queue_depth_max": max(self.queue_depth, default=0),
                "queue_depth_mean": float(np.mean(self.queue_depth))
                                    if self.queue_depth else 0.0,
                "overlap_ratio": self.overlap_ratio(),
            },
            "compliance": self.compliant_sum / self.results
                          if self.results else nan,
            "deadline": self.deadline_summary(),
            "refresh": self.refresh_summary(),
            "lattice": self.lattice_summary(),
        }

    def padding_summary(self) -> dict:
        """Padded/real work ratios (>= 1.0; lower is better): rows is
        the batch x m1 view, flops the rank+audit sweep view."""
        nan = float("nan")
        return {
            "waste_rows": self.padded_cells / self.real_cells
                          if self.real_cells else nan,
            "waste_flops": self.padded_flops / self.real_flops
                           if self.real_flops else nan,
            "real_flops": self.real_flops,
            "padded_flops": self.padded_flops,
        }

    def lattice_summary(self) -> dict:
        """Adaptive-lattice view: lattices flipped, failed re-warms
        (serving stayed last-good), corners warmed off the dispatch path,
        and the shadow-warm windows' wall times."""
        with self._lock:
            return {
                "lattice_swaps": self.lattice_swaps,
                "lattice_rollbacks": self.lattice_rollbacks,
                "shadow_compiles": self.shadow_compiles,
                "shadow_warm_ms": self._pct(self.shadow_warm_ms),
            }

    def refresh_summary(self) -> dict:
        """Hot-swap view: generations published, refreshes refused or
        crashed (serving stayed last-good), superseded generations let
        go. Each swap's validate and flip times stay in
        swap_validate_ms and swap_flip_ms."""
        with self._lock:
            return {
                "swaps": self.swaps,
                "swaps_by_tag": dict(self.swaps_by_tag),
                "refresh_failures": self.refresh_failures,
                "states_retired": self.states_retired,
            }

    def deadline_summary(self) -> dict:
        """Hit rate over served requests (a shed is admission doing its
        job, not a miss), shed and degrade counts, per-surface classes
        and the per-rung compliance cost."""
        nan = float("nan")
        with self._lock:
            tracked = self.deadline_hits + self.deadline_misses
            surfaces = {s: dict(v) for s, v in self.surface_stats.items()}
            rungs = {r: dict(v) for r, v in self.rung_stats.items()}
            hits, misses = self.deadline_hits, self.deadline_misses
            sheds, degrades = self.sheds, self.degrades
        return {
            "hits": hits,
            "misses": misses,
            "hit_rate": hits / tracked if tracked else nan,
            "sheds": sheds,
            "degrades": degrades,
            "surfaces": {
                surface: {**ss, "hit_rate": ss["hits"] / (
                    ss["hits"] + ss["misses"])
                    if ss["hits"] + ss["misses"] else nan}
                for surface, ss in sorted(surfaces.items())
            },
            "rungs": {
                str(rung): {
                    "served": rs["served"],
                    "compliance": rs["compliant"] / rs["served"]
                                  if rs["served"] else nan,
                    "mean_shortfall": rs["shortfall"] / rs["served"]
                                      if rs["served"] else nan,
                }
                for rung, rs in sorted(rungs.items())
            },
        }
