"""Per-request futures and the dispatched-batch record (counterpart of
repro.serving.pipeline's RankFuture and PendingBatch). The async
ExecutionPipeline worker is a later slice: the port's engine finishes
each batch inline on the submitting thread."""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Callable

__all__ = ["RankFuture", "PendingBatch"]


class RankFuture:
    """Handle for one submitted request's eventual RankResult.

    Marked done when its micro-batch's outputs reach the host;
    `result()` builds and memoizes the RankResult on the calling thread.
    Settlement is first-wins: `_finish`/`_fail` return True only for the
    call that settled the future.
    """

    __slots__ = ("rid", "bucket_name", "_event", "_batch", "_index",
                 "_result", "_error", "_lock")

    def __init__(self, rid: int, bucket_name: str):
        self.rid = rid
        self.bucket_name = bucket_name
        self._event = threading.Event()
        self._batch: "PendingBatch | None" = None
        self._index = -1
        self._result = None
        self._error: BaseException | None = None
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

    def _finish(self, batch: "PendingBatch", index: int) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._batch, self._index = batch, index
        self._event.set()
        return True

    def _fail(self, error: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._error = error
        self._event.set()
        return True


@dataclass
class PendingBatch:
    """One dispatched micro-batch, from dispatch through result build.
    `materialize` (engine-bound) copies the outputs to the host and sets
    `t_done`; `build` (engine-bound) unpads row i into a RankResult."""

    bucket: Any
    entries: list                     # [(request, t_enqueue)]
    futures: list                     # [RankFuture], aligned with entries
    out: Any                          # RankingOutput: device, then host
    t_launch: float
    materialize: Callable = None      # (PendingBatch) -> None
    build: Callable = None            # (PendingBatch, i) -> RankResult
    t_done: float | None = None

    def finish(self) -> None:
        """Materialize outputs and mark every future done."""
        self.materialize(self)
        for i, fut in enumerate(self.futures):
            fut._finish(self, i)

    def results(self) -> list:
        """Build (or fetch memoized) results for all rows, in order."""
        return [fut.result(timeout=0) for fut in self.futures]
