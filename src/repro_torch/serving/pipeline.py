"""Async execution pipeline of the port's serving engine (counterpart of
repro.serving.pipeline).

The engine's hot path is split in two:

  submission side   the caller's thread: bucketing, assembly of a
                    micro-batch into a recycled StagingRing slot (page-
                    locked host memory on the card), then, on the
                    engine's CUDA stream, non-blocking copies of the
                    inputs to the slot's device set, ONE dispatcher
                    call, non-blocking copies of the five outputs into
                    the slot's page-locked output set, and an event
                    recorded after them. Nothing there waits for the
                    card, so the thread goes straight back to assembling
                    the next batch.

  completion side   one worker thread per ExecutionPipeline that retires
                    batches in dispatch order: it waits on batch N's
                    event (cudaEventSynchronize, which releases the GIL)
                    while the card runs batch N+1, copies N's outputs
                    out of its slot, releases the slot and marks N's
                    RankFutures done. It launches nothing. Unpadding
                    each row into a RankResult is Python work, so it
                    runs lazily on whichever consumer thread asks:
                    `RankFuture.result()` or the engine's collect path.

The bounded in-flight queue is the double buffer: `depth` batches may
queue behind the one the worker is retiring, and a further dispatch
blocks the submission side (backpressure). A StagingRing holds one slot
more than that window (depth queued + 1 retiring + 1 being assembled);
a slot goes back to the ring only after its batch's event has
completed, so neither a host buffer nor a device buffer is rewritten
while a copy or a kernel still reads it.

Nothing here knows about ranking: PendingBatch's `materialize` and
`build` callables (bound by the engine) own the wait, the unpadding
and the metrics. This module owns threads, queues, futures, buffers
and their lifetime.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.serving.buckets import Bucket, alloc_staging, host_empty

__all__ = ["RankFuture", "StagingRing", "StagingSlot", "PendingBatch",
           "ExecutionPipeline"]


class RankFuture:
    """Handle for one submitted request's eventual RankResult.

    Marked done by the completion side when the request's micro-batch
    outputs reach the host. `result()` blocks (optionally with a
    timeout) and builds and memoizes the RankResult on the calling
    thread; `done()` and `add_done_callback()` never block. Callbacks
    run on the thread that marks the future done (the pipeline worker
    at depth >= 1, the submitting thread at depth 0), so they must be
    cheap.

    Settlement is first-wins: `_finish`/`_resolve`/`_fail` each return
    True only for the call that settled the future.
    """

    __slots__ = ("rid", "bucket_name", "_event", "_batch", "_index",
                 "_result", "_error", "_callbacks", "_lock")

    def __init__(self, rid: int, bucket_name: str):
        self.rid = rid
        self.bucket_name = bucket_name
        self._event = threading.Event()
        self._batch: "PendingBatch | None" = None
        self._index = -1
        self._result = None
        self._error: BaseException | None = None
        self._callbacks: list[Callable] = []
        self._lock = threading.Lock()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None):
        """The RankResult, blocking until the batch's outputs are home."""
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid}: no result within "
                               f"{timeout}s (did you drain()?)")
        with self._lock:
            if self._error is not None:
                raise self._error
            if self._result is None:
                self._result = self._batch.build(self._batch, self._index)
                self._batch = None   # do not pin the whole batch
            return self._result

    def add_done_callback(self, cb: Callable[["RankFuture"], None]) -> None:
        with self._lock:
            if not self._event.is_set():
                self._callbacks.append(cb)
                return
        cb(self)

    def _fire_callbacks(self) -> None:
        with self._lock:
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(self)

    def _finish(self, batch: "PendingBatch", index: int) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._batch, self._index = batch, index
        self._event.set()
        self._fire_callbacks()
        return True

    def _resolve(self, result) -> bool:
        """Resolve now with a pre-built result (the typed Shed of an
        admission shed). First caller wins."""
        with self._lock:
            if self._event.is_set():
                return False
            self._result = result
        self._event.set()
        self._fire_callbacks()
        return True

    def _fail(self, error: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._error = error
        self._event.set()
        self._fire_callbacks()
        return True


# The outputs a batch brings home, with their dtypes and their shapes as
# functions of the bucket (B, m2, K).
OUTPUTS = {
    "perm": (torch.int32, lambda bk: (bk.batch, bk.m2)),
    "utility": (torch.float32, lambda bk: (bk.batch,)),
    "exposure": (torch.float32, lambda bk: (bk.batch, bk.K)),
    "compliant": (torch.bool, lambda bk: (bk.batch,)),
    "lam": (torch.float32, lambda bk: (bk.batch, bk.K)),
}


@dataclass
class StagingSlot:
    """One ring slot: everything a batch of the bucket needs between
    assembly and retirement, allocated once."""

    staged: dict                      # host numpy inputs fill_staging packs
    host: dict                        # torch views of `staged` (copy sources)
    inputs: dict                      # same shapes, on the device
    outputs: dict                     # host numpy outputs (OUTPUTS)
    output_views: dict                # torch views of `outputs` (copy targets)
    event: Any = None                 # torch.cuda.Event; None on the CPU


class StagingRing:
    """Fixed ring of reusable slots for one bucket.

    `acquire` hands out a free slot's staging dict and blocks when every
    slot is attached to an in-flight batch: backpressure that bounds
    memory to `depth` slots per bucket whatever the offered load.
    `release` (the completion side, once the batch's event completed)
    returns it. On the card each slot's host inputs and outputs are
    page-locked and its device inputs stay allocated for the ring's
    lifetime. `release` refuses a dict the ring never handed out: that
    would mean a path allocated fresh staging per batch, which the ring
    exists to prevent. `reuses` counts acquires beyond the first use of
    each slot.
    """

    def __init__(self, bucket: Bucket, *, d_cov: int | None, depth: int,
                 device=None):
        self.bucket = bucket
        self.depth = int(depth)
        self.device = resolve_device(device)
        self._free: queue.Queue = queue.Queue()
        self._slots: dict[int, StagingSlot] = {}
        self._handed_out = 0
        for _ in range(self.depth):
            slot = self._alloc_slot(d_cov)
            self._slots[id(slot.staged)] = slot
            self._free.put(slot.staged)

    def _alloc_slot(self, d_cov: int | None) -> StagingSlot:
        dev = self.device
        staged = alloc_staging(self.bucket, d_cov=d_cov, device=dev)
        host = {k: torch.from_numpy(v) for k, v in staged.items()}
        inputs = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                  for k, v in host.items()}
        outputs = {k: host_empty(shape(self.bucket), dtype, dev)
                   for k, (dtype, shape) in OUTPUTS.items()}
        return StagingSlot(
            staged=staged, host=host, inputs=inputs, outputs=outputs,
            output_views={k: torch.from_numpy(v) for k, v in outputs.items()},
            event=torch.cuda.Event() if dev.type == "cuda" else None)

    @property
    def allocated(self) -> int:
        """Slots this ring ever allocated: depth, for its lifetime."""
        return len(self._slots)

    @property
    def reuses(self) -> int:
        """Acquires beyond the first use of each slot."""
        return max(0, self._handed_out - self.depth)

    def acquire(self) -> dict:
        self._handed_out += 1
        return self._free.get()

    def slot(self, staged: dict) -> StagingSlot:
        """The slot whose staging dict `staged` is."""
        return self._slots[id(staged)]

    def release(self, staged: dict) -> None:
        if id(staged) not in self._slots:
            raise AssertionError(
                f"StagingRing[{self.bucket.name}]: released a buffer set "
                f"it never allocated: a submission path allocated fresh "
                f"staging instead of reusing the ring")
        self._free.put(staged)


@dataclass
class PendingBatch:
    """One dispatched micro-batch, from dispatch through result build.

    Created by the submission side at dispatch. `materialize`
    (engine-bound) waits for `event`, restamps `out` with host arrays,
    sets `t_done` and recycles `staged`; `build` (engine-bound) unpads
    row i into a RankResult. The completion worker calls only
    `materialize`; `build` runs lazily on consumer threads.
    """

    bucket: Bucket
    entries: list                     # [engine._QueueEntry]
    futures: list                     # [RankFuture], aligned with entries
    out: Any                          # RankingOutput of host arrays, once home
    staged: dict | None               # the ring slot to recycle
    ring: StagingRing | None
    t_launch: float
    trigger: str
    materialize: Callable = None      # (PendingBatch) -> None
    build: Callable = None            # (PendingBatch, i) -> RankResult
    t_done: float | None = None
    assembly_ms: float = 0.0
    dispatch_ms: float = 0.0
    depth_at_dispatch: int = 0
    fill: dict = field(default_factory=dict)
    # predictor generation the batch was dispatched against (pinned
    # until materialize has passed the event)
    epoch: int = 0
    event: Any = None                 # recorded after the output copies
    lattice_epoch: int = 0            # bucket-lattice generation at dispatch

    def finish(self) -> None:
        """Materialize outputs and mark every future done. Called by
        the pipeline worker (depth >= 1) or inline (depth 0)."""
        self.materialize(self)
        for i, fut in enumerate(self.futures):
            fut._finish(self, i)

    def results(self) -> list:
        """Build (or fetch memoized) results for all rows, in order."""
        return [fut.result(timeout=0) for fut in self.futures]


class ExecutionPipeline:
    """Completion side: a worker thread retiring batches in dispatch
    order.

    `submit` enqueues a PendingBatch (blocking while `depth` batches are
    in flight), the worker calls `pending.finish()` on each, and retired
    batches wait until the submission side collects them with `collect`
    (non-blocking) or `flush` (a barrier). A worker error fails that
    batch's futures, recycles its slot, and re-raises on the next
    `flush`/`submit`.
    """

    def __init__(self, *, depth: int):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        self.depth = int(depth)
        self._inflight: queue.Queue = queue.Queue(maxsize=self.depth)
        self._retired: queue.Queue = queue.Queue()
        self._error: BaseException | None = None
        self._worker: threading.Thread | None = None
        self._closed = False
        self._lock = threading.Lock()

    # -- worker -------------------------------------------------------------

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._run, name="serving-pipeline", daemon=True)
                self._worker.start()

    def _run(self) -> None:
        while True:
            pending = self._inflight.get()
            if pending is None:                       # shutdown sentinel
                self._inflight.task_done()
                return
            try:
                pending.finish()
                self._retired.put(pending)
            except BaseException as e:  # noqa: BLE001 - stored, re-raised
                self._error = self._error or e
                for fut in pending.futures:
                    fut._fail(e)
                # recycle the slot even on failure: the ring is finite,
                # and a leaked slot would deadlock acquire() later
                if pending.ring is not None and pending.staged is not None:
                    pending.ring.release(pending.staged)
                    pending.staged = None
            finally:
                self._inflight.task_done()

    # -- submission-side API ------------------------------------------------

    def submit(self, pending: PendingBatch) -> None:
        """Hand a dispatched batch to the completion side. Blocks while
        `depth` batches are in flight. A stored worker error re-raises
        here, after this batch is enqueued (it was already dispatched:
        dropping it would leak its slot and strand its futures)."""
        if self._closed:
            raise RuntimeError("pipeline is closed")
        self._ensure_worker()
        pending.depth_at_dispatch = self._inflight.qsize()
        self._inflight.put(pending)
        self._raise_pending_error()

    def inflight(self) -> int:
        """Batches dispatched but not yet picked up by the worker."""
        return self._inflight.qsize()

    def collect(self) -> list:
        """All batches retired so far; never blocks."""
        out = []
        while True:
            try:
                out.append(self._retired.get_nowait())
            except queue.Empty:
                return out

    def flush(self) -> list:
        """Barrier: wait until every in-flight batch has retired, then
        return everything collected."""
        if self._worker is not None:
            self._inflight.join()
        self._raise_pending_error()
        return self.collect()

    def close(self) -> None:
        """Retire everything in flight, then stop the worker.
        Idempotent; submits are refused afterwards."""
        if self._closed:
            return
        self._closed = True
        if self._worker is not None:
            self._inflight.put(None)
            self._worker.join()
            self._worker = None

    def _raise_pending_error(self) -> None:
        if self._error is not None:
            err, self._error = self._error, None
            raise err
