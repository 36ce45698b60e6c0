"""Deterministic seed-driven fault injection for the port's serving fleet
(counterpart of repro.serving.faults).

Every failure mode is a plan: a `FaultPlan` maps replica names to
`ReplicaFaults`, `FaultPlan.chaos` derives the canonical five-fault
scenario from a seed (the same plan as the JAX package's for the same
seed), and a `FaultInjector` attached to a replica's engine executes it
at the seams a real failure would hit:

  crash-at-batch-k      the replica's k-th micro-batch flush after arming
                        raises ReplicaCrash from inside the bucket's call,
                        before anything is launched, and the replica stays
                        down (every later call raises) until the supervisor
                        restarts it.
  heartbeat blackhole   heartbeats in [blackhole_after, blackhole_until)
                        (tick indices) are dropped: the replica serves but
                        looks SUSPECT, then DEAD.
  slow replica          every flush sleeps slow_ms first: alive, on time
                        with its heartbeats, late with every batch.
  poisoned swap         the replica's n-th refresh publishes non-finite
                        state; the engine's swap validation must refuse it.
  partial-drain kill    the replica crashes on the first flush of its
                        drain; its queued requests must be handed off.

The seam. The port's engine dispatches a flush through its per-bucket
call table `engine._exec` (bucket -> call(slot, state, epoch)), filled
when a corner is warmed; the injector wraps those calls. A ReplicaCrash
raised there takes the engine's own failure path: the generation the
batch pinned is unpinned, its futures fail and its ring slot goes back.

One CUDA context serves every replica on a card: an injected crash
models a replica-level failure only. A real device fault (an illegal
address) poisons the process's context and takes every replica with it.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch.checkpoint.store import flatten_with_paths, unflatten_like

__all__ = ["ReplicaCrash", "ReplicaFaults", "FaultPlan", "FaultInjector"]


class ReplicaCrash(RuntimeError):
    """A replica died mid-operation. Fatal for the replica: its health
    machine goes straight to DEAD and only a supervised restart brings
    it back."""


@dataclass(frozen=True)
class ReplicaFaults:
    """The faults scheduled for one replica. All indices count events
    after arming on that replica, so a plan replays identically whenever
    the request stream (and so the flush order) does."""

    crash_at_batch: int | None = None   # k-th flush raises ReplicaCrash
    blackhole_after: int | None = None  # heartbeat ticks >= this dropped...
    blackhole_until: int | None = None  # ...until this tick (None = forever)
    slow_ms: float = 0.0                # injected latency per flush
    poison_swap_at: int | None = None   # n-th refresh publishes NaNs
    kill_during_drain: bool = False     # crash on the first drain flush

    def any(self) -> bool:
        return (self.crash_at_batch is not None
                or self.blackhole_after is not None
                or self.slow_ms > 0.0
                or self.poison_swap_at is not None
                or self.kill_during_drain)


@dataclass(frozen=True)
class FaultPlan:
    """A replayable fleet-wide failure scenario: {replica_name:
    ReplicaFaults} plus the seed it was derived from."""

    replicas: dict
    seed: int = 0

    def faults_for(self, name: str) -> ReplicaFaults:
        return self.replicas.get(name, ReplicaFaults())

    @staticmethod
    def none(names) -> "FaultPlan":
        return FaultPlan(replicas={n: ReplicaFaults() for n in names})

    @staticmethod
    def chaos(names, *, seed: int = 0, slow_ms: float = 5.0) -> "FaultPlan":
        """The canonical five-fault scenario over >= 3 replicas, every
        parameter drawn from `seed` (numpy's generator, as the JAX
        package draws it):

          names[0]  crash-at-batch-k (k in [2, 5)) and, once restarted,
                    a kill on the first flush of its drain;
          names[1]  heartbeat blackhole over a tick window, plus a
                    poisoned swap on its first or second refresh;
          names[2]  slow replica (`slow_ms` per flush).

        Replicas beyond the third stay clean.
        """
        names = list(names)
        if len(names) < 3:
            raise ValueError(
                f"the chaos plan needs >= 3 replicas, got {len(names)}")
        rng = np.random.default_rng(seed)
        crash_k = int(rng.integers(2, 5))
        hole_at = int(rng.integers(2, 5))
        hole_len = int(rng.integers(4, 8))
        poison_at = int(rng.integers(1, 3))
        replicas = {n: ReplicaFaults() for n in names}
        replicas[names[0]] = ReplicaFaults(
            crash_at_batch=crash_k, kill_during_drain=True)
        replicas[names[1]] = ReplicaFaults(
            blackhole_after=hole_at, blackhole_until=hole_at + hole_len,
            poison_swap_at=poison_at)
        replicas[names[2]] = ReplicaFaults(slow_ms=float(slow_ms))
        return FaultPlan(replicas=replicas, seed=seed)


@dataclass
class _WrappedExec:
    """One bucket's call under injection. The shared injector decides
    crashes and delays, so 'crash at batch k' means the replica's k-th
    flush, whichever bucket it lands in."""

    fn: object
    injector: "FaultInjector"

    def __call__(self, *args):
        self.injector._before_flush()
        return self.fn(*args)


@dataclass
class FaultInjector:
    """Executes one replica's ReplicaFaults at the engine's seams. Attach
    with `wrap_engine(engine)` after warmup (warmup's phantom batches are
    not traffic); re-attach after a restart. The chaos plan's faults are
    one-shot, so a restarted replica comes back clean."""

    faults: ReplicaFaults
    name: str = "replica"
    sleep: object = time.sleep
    flushes: int = 0                    # flushes seen since arming
    heartbeat_ticks: int = 0
    refreshes: int = 0
    crashed: bool = False
    draining: bool = False
    drain_killed: bool = False
    wrapped: dict = field(default_factory=dict)

    # -- attachment ----------------------------------------------------------

    def wrap_engine(self, engine) -> None:
        """Interpose on every warmed bucket call of `engine` (under the
        engine's swap lock, where its call table changes)."""
        with engine._swap_lock:
            for bucket, fn in list(engine._exec.items()):
                if isinstance(fn, _WrappedExec):      # idempotent
                    continue
                wrapped = _WrappedExec(fn=fn, injector=self)
                engine._exec[bucket] = wrapped
                self.wrapped[bucket] = wrapped

    # -- seams ---------------------------------------------------------------

    def _before_flush(self) -> None:
        if self.crashed:
            raise ReplicaCrash(
                f"{self.name}: call into a crashed replica")
        if self.faults.kill_during_drain and self.draining \
                and not self.drain_killed:
            self.drain_killed = True
            self.crashed = True
            raise ReplicaCrash(f"{self.name}: killed mid-drain")
        i = self.flushes
        self.flushes += 1
        if self.faults.slow_ms > 0.0:
            self.sleep(self.faults.slow_ms / 1e3)
        if self.faults.crash_at_batch is not None \
                and i == self.faults.crash_at_batch:
            self.crashed = True
            raise ReplicaCrash(
                f"{self.name}: crashed at batch {i} (planned)")

    def heartbeat_delivered(self) -> bool:
        """One heartbeat tick: True if it reaches the router, False if the
        replica is crashed or the tick falls inside the blackhole."""
        i = self.heartbeat_ticks
        self.heartbeat_ticks += 1
        if self.crashed:
            return False
        after = self.faults.blackhole_after
        if after is not None and i >= after:
            until = self.faults.blackhole_until
            if until is None or i < until:
                return False
        return True

    def poison_state(self, state: dict) -> dict:
        """Applied to each refresh's candidate state before publish: on
        the planned refresh index every floating leaf (a torch tensor on
        the engine's device) becomes NaNs of the same shape, dtype and
        device. Structurally valid, so only the engine's finiteness check
        stands between it and serving."""
        i = self.refreshes
        self.refreshes += 1
        if self.faults.poison_swap_at is None \
                or i != self.faults.poison_swap_at:
            return state
        state = dict(state)
        leaves = flatten_with_paths(state)
        return unflatten_like(state, {
            p: torch.full_like(t, float("nan")) if t.is_floating_point()
            else t for p, t in leaves.items()})

    def restore(self) -> None:
        """Reset after a restart: the restarted incarnation serves clean,
        except that kill_during_drain stays armed until it has fired (the
        plan schedules it for the restarted incarnation's drain)."""
        self.crashed = False
        self.draining = False
        self.wrapped = {}
        self.faults = replace(
            self.faults, crash_at_batch=None, blackhole_after=None,
            blackhole_until=None, slow_ms=0.0, poison_swap_at=None)
