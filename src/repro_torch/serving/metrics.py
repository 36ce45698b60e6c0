"""Serving-engine counters and percentiles (the parts of
repro.serving.metrics.EngineMetrics this slice's engine feeds)."""

from __future__ import annotations

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
    warmed: bool = False
    oversize_requests: int = 0        # fell outside the warmed buckets
    capacity_flushes: int = 0
    deadline_flushes: int = 0
    drain_flushes: int = 0
    real_cells: int = 0
    padded_cells: int = 0
    assembly_ms: list = field(default_factory=list)  # host packing
    exec_ms: list = field(default_factory=list)      # launch -> outputs home
    compliant_sum: float = 0.0
    latencies_ms: list = field(default_factory=list)
    queue_wait_ms: list = field(default_factory=list)

    def on_submit(self, bucket, known: bool) -> None:
        self.requests += 1
        self.bucket_hits[bucket.name] += 1
        if self.warmed and not known:
            self.oversize_requests += 1

    def on_executable_call(self, kernel_launches: int) -> None:
        self.executable_calls += 1
        self.kernel_launches += kernel_launches

    def on_dispatch(self, trigger: str, fill: dict, *,
                    assembly_ms: float) -> None:
        self.batches += 1
        self.assembly_ms.append(assembly_ms)
        if trigger == "capacity":
            self.capacity_flushes += 1
        elif trigger == "deadline":
            self.deadline_flushes += 1
        else:
            self.drain_flushes += 1
        self.real_cells += fill["real_cells"]
        self.padded_cells += fill["padded_cells"]

    def on_retire(self, exec_ms: float) -> None:
        self.exec_ms.append(exec_ms)

    def on_result(self, latency_ms: float, wait_ms: float,
                  compliant: bool) -> None:
        self.results += 1
        self.latencies_ms.append(latency_ms)
        self.queue_wait_ms.append(wait_ms)
        self.compliant_sum += float(compliant)

    @staticmethod
    def _pct(xs, qs=(50, 95, 99)):
        if not xs:
            return {f"p{q}": float("nan") for q in qs}
        arr = np.asarray(xs)
        return {f"p{q}": float(np.percentile(arr, q)) for q in qs}

    def summary(self) -> dict:
        nan = float("nan")
        return {
            "requests": self.requests,
            "results": self.results,
            "batches": self.batches,
            "executable_calls": self.executable_calls,
            "kernel_launches": self.kernel_launches,
            "kernel_launches_per_batch":
                self.kernel_launches / self.batches if self.batches else nan,
            "buckets_used": len(self.bucket_hits),
            "oversize_requests": self.oversize_requests,
            "flushes": {"capacity": self.capacity_flushes,
                        "deadline": self.deadline_flushes,
                        "drain": self.drain_flushes},
            "fill_rate": self.real_cells / self.padded_cells
                         if self.padded_cells else nan,
            "latency_ms": self._pct(self.latencies_ms),
            "queue_wait_ms": self._pct(self.queue_wait_ms),
            "assembly_ms_per_batch": self._pct(self.assembly_ms),
            "exec_ms_per_batch": self._pct(self.exec_ms),
            "compliance": self.compliant_sum / self.results
                          if self.results else nan,
        }
