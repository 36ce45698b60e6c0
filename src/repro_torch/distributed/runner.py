"""Fault-tolerant training runner (counterpart of
repro.distributed.runner): checkpoint/restart, failure injection,
straggler detection.

Failures surface as exceptions raised by the step function (a CUDA
error, a lost device) or by the failure-injection hook. The runner's
contract:

  * every `ckpt_every` steps (and after the last): a checkpoint, async
    by default (atomic, versioned; checkpoint/store.py);
  * on a step failure: wait for the checkpoint in flight, restore the
    newest one and replay from its `next_step` (with none yet, from the
    state and step the run started with): data order is reproducible
    because batches derive from the step number;
  * `max_restarts` bounds the retry budget; exhausted -> re-raise;
  * straggler detection: per-step wall times feed an EWMA; steps slower
    than `straggler_factor` x EWMA are counted in the report.

The runner is model-agnostic: state is a tree of tensors (the
launcher's is (params, AdamState)), `step_fn(state, batch) -> (state,
metrics)` must be functional (the state it returns is all the next step
reads, so a restore replaces everything a step depends on), and
`batch_fn(step) -> batch` regenerates data deterministically for
replay. Metrics come back to the host through `.item()`. A restore
passes `shardings` through to CheckpointStore.restore, as JAX's does
(the leaves with a sharding come back placed onto their mesh), and puts
the other leaves on `device` (None = the card).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.checkpoint.store import CheckpointStore

PyTree = Any


@dataclass
class RunnerReport:
    steps_run: int = 0
    restarts: int = 0
    straggler_steps: int = 0
    checkpoints: int = 0
    metrics_history: list = field(default_factory=list)
    step_times: list = field(default_factory=list)


class FaultTolerantRunner:
    def __init__(
        self,
        store: CheckpointStore,
        step_fn: Callable[[PyTree, Any], tuple[PyTree, dict]],
        batch_fn: Callable[[int], Any],
        *,
        ckpt_every: int = 50,
        max_restarts: int = 3,
        straggler_factor: float = 3.0,
        async_ckpt: bool = True,
    ):
        self.store = store
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.straggler_factor = straggler_factor
        self.async_ckpt = async_ckpt

    def _restore(self, state: PyTree, device, shardings
                 ) -> tuple[PyTree, int]:
        state, extra = self.store.restore(state, shardings=shardings,
                                          device=device)
        return state, int(extra.get("next_step", self.store.latest_step()))

    def run(
        self,
        state: PyTree,
        num_steps: int,
        *,
        start_step: int = 0,
        resume: bool = True,
        fail_at: Callable[[int], bool] | None = None,
        shardings: PyTree | None = None,
        device=None,
    ) -> tuple[PyTree, RunnerReport]:
        """Run to `num_steps`, surviving step failures. A restore places
        each leaf with a sharding in `shardings` onto its mesh
        (CheckpointStore.restore) and the rest on `device` (None = the
        card).

        `fail_at(step)` is the failure-injection hook used by tests and
        chaos drills: when it returns True the runner behaves as if the
        step raised.
        """
        report = RunnerReport()
        initial = state
        step = start_step
        if resume and self.store.latest_step() is not None:
            state, step = self._restore(state, device, shardings)
        restarts = 0
        ewma = None

        while step < num_steps:
            batch = self.batch_fn(step)
            t0 = time.perf_counter()
            try:
                if fail_at is not None and fail_at(step):
                    raise RuntimeError(f"injected failure at step {step}")
                state, metrics = self.step_fn(state, batch)
                metrics = {k: v.item() if hasattr(v, "item") else v
                           for k, v in metrics.items()}
            except Exception:
                restarts += 1
                report.restarts = restarts
                self.store.wait()
                if restarts > self.max_restarts:
                    raise
                if self.store.latest_step() is not None:
                    state, step = self._restore(state, device, shardings)
                else:
                    state, step = initial, start_step
                continue
            dt = time.perf_counter() - t0
            report.step_times.append(dt)
            if ewma is None:
                ewma = dt
            else:
                if dt > self.straggler_factor * ewma:
                    report.straggler_steps += 1
                ewma = 0.9 * ewma + 0.1 * dt
            report.metrics_history.append(metrics)
            report.steps_run += 1
            step += 1
            if step % self.ckpt_every == 0 or step == num_steps:
                save = (self.store.save_async if self.async_ckpt
                        else self.store.save)
                save(step, state, extra={"next_step": step})
                report.checkpoints += 1
        self.store.wait()
        return state, report
