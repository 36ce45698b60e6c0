"""Fault-tolerant replica fleet of the port (counterpart of
repro.serving.fleet): health-checked consistent-hash routing, failover
with hedged retries, and supervised restart from epoch checkpoints.

On the card, N replicas are N ServingEngines on one device. Each has its
own CUDA stream and pipeline worker and, when the factory returns one,
its own RefreshLane (on a stream of its own) and CheckpointStore. Nothing
here waits on the whole device: a restart waits on the new engine's
batches and stream only, so the other replicas keep serving through it.
They share one CUDA context, though (serving/faults.py).

One ServingEngine is a single point of failure: a crash mid-stream
orphans every queued request, and a wedged replica silently blows the
50 ms budget for its whole bucket subset. The fleet layer runs N
replicas (each a full ServingEngine + optional RefreshLane built by a
caller-supplied factory) and routes shape buckets across them with a
consistent-hash ring, so each replica warms only its lattice subset
plus the subset it backs up — the no-recompile contract holds per
replica, and losing one replica moves only ~1/N of the keyspace.

Decision ladder, per request:

  1. route   — ring owners of the request's HOME bucket, walked in
               ring order, skipping non-routable (DEAD/RECOVERING)
               replicas;
  2. hedge   — primary is SUSPECT (stale heartbeat, lag EWMA over
               threshold, or a recent failure): the request is ALSO
               submitted to the next routable owner; first completion
               settles the fleet future (RankFuture first-wins), the
               loser's result is deduped by rid;
  3. failover— primary is DEAD or the attempt failed: re-route to the
               next candidate; the dead replica's queued-but-unflushed
               requests are evicted via engine.handoff_queued and
               re-routed the same way (in-flight batches retire
               normally — the pipeline owns them);
  4. restart — a DEAD replica is restarted under supervision with
               capped-exponential + deterministically-jittered backoff
               (health.backoff_s): fresh factory engine, predictor
               state restored onto its device from per-epoch
               checkpoints (CheckpointStore.load_predictor_epoch →
               last-good λ̂, never cold), bucket subset re-warmed, then
               mark_recovered. Each restart's host ms (factory,
               checkpoint reload, re-warm) is kept on the replica.

Threading contract (the one that matters): completion callbacks run on
replica pipeline-worker threads. A callback that resubmitted to
another engine could deadlock against that engine's backpressure
(worker blocked in our callback while the submission it is waiting on
blocks on the pipeline window). So callbacks only settle fleet
futures and push rids onto a retry deque; every engine call
(submit/flush/drain/restart) happens on the router caller's thread,
via _drain_retries from submit/poll/tick/drain.

Chaos: pass a faults.FaultPlan and every replica gets a FaultInjector
(crash-at-batch-k, heartbeat blackhole, slow-replica latency,
poisoned swap, partial-drain kill) — every failure mode above becomes
a replayable, seed-driven run.
"""

from __future__ import annotations

import hashlib
import threading
import time
from bisect import bisect_right
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np

from repro_torch.serving.buckets import Bucket
from repro_torch.serving.engine import RankRequest, Shed
from repro_torch.serving.faults import FaultInjector, FaultPlan, ReplicaCrash
from repro_torch.serving.health import (
    DEAD,
    SUSPECT,
    HealthConfig,
    ReplicaHealth,
    backoff_s,
)
from repro_torch.serving.lattice import Lattice
from repro_torch.serving.pipeline import RankFuture

__all__ = ["FleetRouter", "FleetMetrics", "Replica"]


def _ring_hash(key: str) -> int:
    # blake2b, not Python hash(): hash() is salted per process, and the
    # ring must assign the same owners in every replay of a chaos plan.
    return int.from_bytes(
        hashlib.blake2b(key.encode(), digest_size=8).digest(), "big")


@dataclass
class FleetMetrics:
    """Cross-replica accounting. `submitted == served + sheds + lost`
    when the stream drains cleanly — and `lost` plus
    `orphaned_futures()` are asserted == 0 by the chaos tests: every
    failure mode re-routes, none drops."""

    submitted: int = 0
    served: int = 0
    sheds: int = 0
    lost: int = 0                     # futures failed after max_attempts
    failovers: int = 0                # sends to a non-primary owner
    hedges: int = 0                   # SUSPECT-triggered duplicate sends
    hedge_wins: int = 0               # hedged requests settled by either copy
    duplicates_deduped: int = 0       # loser completions dropped by rid
    retries: int = 0                  # failed attempts re-queued
    crashes: int = 0                  # fatal replica failures observed
    restarts: int = 0                 # supervised restarts completed
    restart_failures: int = 0         # restarts that themselves failed
    heartbeats_delivered: int = 0
    heartbeats_missed: int = 0

    def as_dict(self) -> dict:
        return {k: int(getattr(self, k)) for k in (
            "submitted", "served", "sheds", "lost", "failovers", "hedges",
            "hedge_wins", "duplicates_deduped", "retries", "crashes",
            "restarts", "restart_failures", "heartbeats_delivered",
            "heartbeats_missed")}


@dataclass
class Replica:
    """One fleet member: the live engine (+ optional RefreshLane), its
    health machine, its chaos injector, and its restart bookkeeping."""

    name: str
    index: int
    engine: Any
    lane: Any = None
    health: ReplicaHealth = None
    injector: FaultInjector | None = None
    warm_buckets: set = field(default_factory=set)
    crashed: bool = False
    restart_attempts: int = 0
    next_restart_at: float | None = None
    # per-restart {tag: epoch} restored from checkpoints — the chaos
    # tests assert the first restart resumed at the last-good epoch.
    restore_history: list = field(default_factory=list)
    # EngineMetrics of engines retired by restarts, so fleet-level
    # aggregation stays cumulative across restarts.
    retired_metrics: list = field(default_factory=list)
    # per completed restart, its host ms: factory (a fresh engine with its
    # predictors on the device), reload (checkpoints restored and
    # swapped in), rewarm (the bucket subset and the fleet's lattice)
    restart_ms: list = field(default_factory=list)

    @property
    def store(self):
        """The checkpoint store restarts restore from (the lane's)."""
        return getattr(self.lane, "checkpoint", None)


@dataclass
class _Pending:
    """One fleet-level request in flight: the caller's future plus the
    routing state its retries need."""

    req: RankRequest
    fut: RankFuture
    owners: list                      # ring-ordered replica indices
    tried: list = field(default_factory=list)
    attempts: int = 0
    hedged: bool = False


class FleetRouter:
    """Consistent-hash router over N ServingEngine replicas (module doc
    has the decision ladder and threading contract).

    factory(name) -> engine, or (engine, lane) when the replica runs a
    RefreshLane; the lane's `checkpoint` store (if any) is what a
    supervised restart restores predictor epochs from. The factory is
    called again on every restart — replicas are cattle.

    clock: drives health deadlines and restart backoff ONLY (engines
    keep their own clocks) — inject a frozen/step clock to make every
    transition replayable. heartbeat_interval_s gates the implicit
    tick from submit/poll; pass float('inf') and call tick() yourself
    for fully deterministic heartbeat indices (what the chaos plan's
    blackhole windows count).

    The router duck-types the engine's serving surface — submit /
    submit_future / poll / drain / observe_submission_lag / close — so
    serving.traffic.serve_open_loop drives a fleet and
    a single engine identically.
    """

    def __init__(self, factory: Callable[[str], Any], n_replicas: int = 3, *,
                 names=None, clock: Callable[[], float] = time.perf_counter,
                 health: HealthConfig | None = None, vnodes: int = 16,
                 replication: int = 1, hedging: bool = True,
                 auto_restart: bool = True, max_attempts: int | None = None,
                 backoff_base_s: float = 0.05, backoff_cap_s: float = 2.0,
                 heartbeat_interval_s: float = 0.05, seed: int = 0,
                 fault_plan: FaultPlan | None = None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        if names is None:
            names = [f"r{i}" for i in range(n_replicas)]
        names = [str(n) for n in names]
        if len(names) != n_replicas or len(set(names)) != n_replicas:
            raise ValueError(f"need {n_replicas} distinct names, got {names}")
        self.factory = factory
        self.clock = clock
        self.health_config = health or HealthConfig()
        self.vnodes = int(vnodes)
        # how many ring successors ALSO warm each home bucket's group
        # (1 = primary + first backup): a hedge or failover lands on a
        # replica that already compiled the bucket, so failure paths
        # never trip the no-recompile contract.
        self.replication = max(0, min(int(replication), n_replicas - 1))
        self.hedging = bool(hedging)
        self.auto_restart = bool(auto_restart)
        self.max_attempts = (3 * n_replicas if max_attempts is None
                             else int(max_attempts))
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_cap_s = float(backoff_cap_s)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.seed = int(seed)
        self.fault_plan = fault_plan
        self.metrics = FleetMetrics()
        now = self.clock()
        self.replicas: list[Replica] = []
        for i, name in enumerate(names):
            rep = self._spawn(name, i, now)
            self.replicas.append(rep)
        # vnode ring: sorted (hash, replica_index)
        points = []
        for i, name in enumerate(names):
            for v in range(self.vnodes):
                points.append((_ring_hash(f"{name}#{v}"), i))
        points.sort()
        self._ring_keys = [h for h, _ in points]
        self._ring_vals = [i for _, i in points]
        self._owner_cache: dict[str, list[int]] = {}
        self._lock = threading.Lock()
        self._pending: dict[int, _Pending] = {}
        self._retry: deque = deque()
        self._done: list = []
        self._last_tick = now
        self._warmed = False
        # fleet-wide adaptive lattice (rewarm_lattice): replicas always
        # flip TOGETHER to a common pinned epoch — routing keys off
        # replica 0's bucket_of, so a replica on a different lattice
        # would receive requests for corners it never warmed. Restarted
        # replicas are restored to this lattice after their re-warm.
        self._lattice: Lattice | None = None
        self._lattice_epoch = 0

    # -- construction / ring -------------------------------------------------

    def _spawn(self, name: str, index: int, now: float) -> Replica:
        made = self.factory(name)
        engine, lane = made if isinstance(made, tuple) else (made, None)
        health = ReplicaHealth(name=name, config=self.health_config,
                               last_heartbeat=now)
        injector = None
        if self.fault_plan is not None:
            injector = FaultInjector(self.fault_plan.faults_for(name), name)
            if lane is not None:
                # poisoned-swap seam: the injector NaN-fills the state
                # the lane is about to publish on the planned refresh.
                lane.publish_filter = (
                    lambda tag, state, inj=injector: inj.poison_state(state))
        return Replica(name=name, index=index, engine=engine, lane=lane,
                       health=health, injector=injector)

    def _owners(self, bucket_name: str) -> list[int]:
        """All replica indices in ring order starting at the bucket's
        hash point — position 0 is the primary, the rest the failover
        chain."""
        cached = self._owner_cache.get(bucket_name)
        if cached is not None:
            return cached
        n = len(self.replicas)
        start = bisect_right(self._ring_keys, _ring_hash(bucket_name))
        owners, seen = [], set()
        for k in range(len(self._ring_vals)):
            i = self._ring_vals[(start + k) % len(self._ring_vals)]
            if i not in seen:
                seen.add(i)
                owners.append(i)
                if len(owners) == n:
                    break
        self._owner_cache[bucket_name] = owners
        return owners

    def warmup(self, sample) -> dict:
        """Assign each home bucket's group (home + every degradation
        rung) to its primary and `replication` ring successors, then
        warm each replica on exactly its subset. Injectors arm AFTER
        warmup — fault batch counters index live flushes only."""
        template = self.replicas[0].engine
        groups: dict = {}
        for r in sample:
            if isinstance(r, Bucket):
                groups.setdefault(r, set()).add(r)
            else:
                home = template.bucket_of(r)
                group = {bk for _, bk in template._rung_buckets(r, home)}
                groups.setdefault(home, set()).update(group)
        for home, group in groups.items():
            owners = self._owners(home.name)
            for i in owners[:1 + self.replication]:
                self.replicas[i].warm_buckets.update(group)
        reports = {}
        for rep in self.replicas:
            reports[rep.name] = rep.engine.warmup(sorted(rep.warm_buckets))
            if rep.injector is not None:
                rep.injector.wrap_engine(rep.engine)
        self._warmed = True
        return reports

    def rewarm_lattice(self, new_lattice: Lattice) -> dict:
        """Fleet-wide adaptive-lattice re-warm: shadow-warm EVERY
        replica off its dispatch path, then flip them all to a common
        pinned epoch.

        Bucket→replica assignment is stable across lattice epochs by
        construction — ring ownership is a pure function of the bucket
        NAME (`_owners`), so corners shared between the old and new
        lattice keep their owners and only genuinely new corners get
        (deterministically) placed. Each replica shadow-warms only its
        subset: the new corners whose primary-or-backup it is, plus
        whatever its OWN traffic histogram says it needs (failover
        routes by the same ring, so `replication` backups suffice
        exactly as they do for warmup()).

        All shadow warms complete before ANY replica flips; a compile
        failure on one replica aborts the whole epoch with zero flips —
        the fleet keeps serving the last-good lattice everywhere.
        Returns {replica: shadow-warm report} plus the common epoch.
        """
        new_lattice.validate()
        # union of every replica's observed reachable set on the new
        # lattice, assigned to primaries + backups by stable name hash
        union: set[Bucket] = set()
        for rep in self.replicas:
            union |= rep.engine._lattice_buckets(new_lattice)
        subsets: dict[str, set[Bucket]] = {r.name: set()
                                           for r in self.replicas}
        for bucket in union:
            owners = self._owners(bucket.name)
            for i in owners[:1 + self.replication]:
                subsets[self.replicas[i].name].add(bucket)
        reports: dict[str, Any] = {}
        for rep in self.replicas:
            # phase 1 everywhere first: nothing flips until every
            # replica holds a warmed copy of its new subset
            reports[rep.name] = rep.engine.shadow_warm_lattice(
                new_lattice, sample=sorted(subsets[rep.name]))
        epoch = max(r.engine.lattice_epoch() for r in self.replicas) + 1
        for rep in self.replicas:
            rep.engine.swap_lattice(
                new_lattice, epoch=epoch,
                warm_ms=reports[rep.name]["warm_ms"])
            rep.warm_buckets.update(subsets[rep.name])
        self._lattice = new_lattice
        self._lattice_epoch = epoch
        # per-epoch ring hygiene: drop memoized owner chains so the
        # epoch starts from a clean (re-derivable, identical for shared
        # corners) cache — new corners fault in lazily.
        self._owner_cache.clear()
        reports["epoch"] = epoch
        return reports

    def arm_faults(self) -> None:
        """(Re-)wrap every replica's engine with its injector — for
        callers that warm first, serve a fault-free prefix, then arm
        the chaos plan (so that a checkpointed epoch
        exists before the first crash)."""
        for rep in self.replicas:
            if rep.injector is not None:
                rep.injector.wrap_engine(rep.engine)

    # -- heartbeats / supervision -------------------------------------------

    def _maybe_tick(self, now: float) -> None:
        if now - self._last_tick >= self.heartbeat_interval_s:
            self.tick(now)

    def tick(self, now: float | None = None) -> None:
        """One heartbeat round: pull liveness from every replica
        (through its injector — a crashed or blackholed replica's
        heartbeat is simply not delivered), apply the health deadline
        rules, and fire any due supervised restarts."""
        now = self.clock() if now is None else now
        self._last_tick = now
        for rep in self.replicas:
            if rep.injector is not None:
                delivered = rep.injector.heartbeat_delivered()
            else:
                delivered = not rep.crashed
            if delivered:
                rep.health.heartbeat(now)
                self.metrics.heartbeats_delivered += 1
            else:
                self.metrics.heartbeats_missed += 1
            rep.health.evaluate(now)
        if self.auto_restart:
            for rep in self.replicas:
                if rep.health.state != DEAD:
                    continue
                if rep.next_restart_at is None:
                    rep.next_restart_at = now + backoff_s(
                        rep.restart_attempts, base_s=self.backoff_base_s,
                        cap_s=self.backoff_cap_s,
                        seed=self.seed * 1009 + rep.index)
                elif now >= rep.next_restart_at:
                    self.restart(rep.name, now=now)

    def restart(self, name: str, now: float | None = None) -> dict:
        """Supervised restart of one DEAD replica: close the old engine
        (its in-flight batches retire first — their futures already
        have callbacks), build a fresh one from the factory, restore
        every predictor tag from the newest loadable epoch checkpoint
        (engine.swap_predictor(epoch=...) pins the restored epoch so
        the replica resumes at last-good λ̂, not cold), re-warm its
        bucket subset, and mark it HEALTHY. Returns {tag: epoch}
        restored."""
        now = self.clock() if now is None else now
        rep = next(r for r in self.replicas if r.name == name)
        rep.health.begin_recovery(now)
        store = rep.store
        try:
            try:
                rep.engine.close()
            except BaseException:
                pass  # a crashed engine may refuse its final flush
            rep.retired_metrics.append(rep.engine.metrics)
            t0 = time.perf_counter()
            made = self.factory(rep.name)
            engine, lane = made if isinstance(made, tuple) else (made, None)
            t1 = time.perf_counter()
            restored: dict[str, int] = {}
            if store is not None:
                for tag in engine.predictor_tags():
                    try:
                        state, epoch = store.load_predictor_epoch(
                            tag, device=engine.device)
                    except FileNotFoundError:
                        continue  # nothing checkpointed yet: serve epoch 0
                    if epoch > engine.predictor_epoch(tag):
                        engine.swap_predictor(tag, state, epoch=epoch)
                        restored[tag] = epoch
            t2 = time.perf_counter()
            if rep.warm_buckets:
                engine.warmup(sorted(rep.warm_buckets))
            if self._lattice is not None:
                # resume the fleet's lattice generation: the subset was
                # just re-warmed above (warm_buckets accumulated the
                # adaptive corners at rewarm_lattice time), so the flip
                # is compile-free; pinning the epoch keeps result
                # labels consistent with the pre-crash incarnation.
                engine.swap_lattice(self._lattice,
                                    epoch=self._lattice_epoch)
            rep.engine, rep.lane = engine, lane
            rep.crashed = False
            if rep.injector is not None:
                rep.injector.restore()
                rep.injector.wrap_engine(engine)
                if lane is not None:
                    lane.publish_filter = (
                        lambda tag, state, inj=rep.injector:
                        inj.poison_state(state))
        except BaseException:
            rep.health.fail_recovery(now)
            rep.restart_attempts += 1
            rep.next_restart_at = None   # reschedule with bigger backoff
            self.metrics.restart_failures += 1
            raise
        rep.restart_attempts += 1
        rep.next_restart_at = None
        rep.restore_history.append(dict(restored))
        rep.restart_ms.append({"factory": (t1 - t0) * 1e3,
                               "reload": (t2 - t1) * 1e3,
                               "rewarm": (time.perf_counter() - t2) * 1e3})
        rep.health.mark_recovered(now)
        self.metrics.restarts += 1
        return restored

    def _force_restart(self, now: float) -> bool:
        """No routable candidate left for some request: restart the
        longest-dead replica NOW, ignoring its backoff schedule —
        progress beats politeness once the alternative is a lost
        request."""
        dead = [r for r in self.replicas if r.health.state == DEAD]
        if not dead:
            return False
        rep = min(dead, key=lambda r: (r.next_restart_at or 0.0, r.index))
        try:
            self.restart(rep.name, now=now)
        except BaseException:
            return False
        return True

    # -- failure handling ----------------------------------------------------

    def _replica_failed(self, rep: Replica, err: BaseException,
                        now: float) -> None:
        """An attempt on `rep` failed. Fatal (ReplicaCrash) marks it
        DEAD and evicts its queued requests — their futures fail, which
        funnels their rids into the retry deque via the same completion
        callbacks as the original failure. NEVER called while holding
        self._lock (handoff fires callbacks inline)."""
        fatal = isinstance(err, ReplicaCrash)
        rep.health.on_failure(now, fatal=fatal)
        if fatal and not rep.crashed:
            rep.crashed = True            # set BEFORE handoff: re-entrant
            self.metrics.crashes += 1     # callbacks must not recurse here
            try:
                rep.engine.handoff_queued(error=err)
            except BaseException:
                pass

    def _on_attempt_done(self, rep: Replica, rid: int, rfut, t0: float,
                         ) -> None:
        """Completion callback (runs on a replica pipeline worker, or
        inline for sync engines): settle the fleet future first-wins,
        or queue a retry. Only touches the lock briefly; never calls
        into an engine except the re-entrancy-guarded handoff."""
        now = self.clock()
        try:
            res = rfut.result(timeout=0)
        except BaseException as err:
            self._replica_failed(rep, err, now)
            with self._lock:
                if rid in self._pending:
                    self._retry.append(rid)
                    self.metrics.retries += 1
            return
        rep.health.observe_lag((now - t0) * 1e3)
        rep.health.on_success(now)
        with self._lock:
            entry = self._pending.pop(rid, None)
            if entry is None:
                # hedge loser (or late duplicate): deduped by rid.
                self.metrics.duplicates_deduped += 1
                return
            if isinstance(res, Shed):
                self.metrics.sheds += 1
            else:
                self.metrics.served += 1
            if entry.hedged:
                self.metrics.hedge_wins += 1
            self._done.append(res)
        entry.fut._resolve(res)

    # -- submission ----------------------------------------------------------

    def _bucket_key(self, req: RankRequest) -> str:
        return self.replicas[0].engine.bucket_of(req).name

    def _candidates(self, entry: _Pending) -> list[int]:
        order = entry.owners + [i for i in range(len(self.replicas))
                                if i not in entry.owners]
        cands = [i for i in order if i not in entry.tried
                 and self.replicas[i].health.routable]
        if not cands:
            # every routable replica already tried: let retries revisit
            # them (one may have recovered since).
            cands = [i for i in order if self.replicas[i].health.routable]
        return cands

    def _send(self, entry: _Pending, idx: int, now: float) -> None:
        rep = self.replicas[idx]
        if idx not in entry.tried:
            entry.tried.append(idx)
        entry.attempts += 1
        try:
            rfut = rep.engine.submit_future(entry.req)
        except BaseException as err:
            self._replica_failed(rep, err, self.clock())
            with self._lock:
                if entry.req.rid in self._pending:
                    self._retry.append(entry.req.rid)
                    self.metrics.retries += 1
            return
        rfut.add_done_callback(
            lambda f, rep=rep, rid=entry.req.rid, t0=now:
            self._on_attempt_done(rep, rid, f, t0))

    def _attempt(self, entry: _Pending, now: float) -> None:
        cands = self._candidates(entry)
        if not cands:
            if self._force_restart(now):
                cands = self._candidates(entry)
        if not cands:
            with self._lock:
                if entry.req.rid in self._pending:
                    self._retry.append(entry.req.rid)  # revisit next pass
            return
        primary = cands[0]
        if primary != entry.owners[0]:
            self.metrics.failovers += 1
        targets = [primary]
        if (self.hedging and len(cands) > 1
                and self.replicas[primary].health.state == SUSPECT
                and not entry.hedged):
            entry.hedged = True
            self.metrics.hedges += 1
            targets.append(cands[1])
        for idx in targets:
            self._send(entry, idx, now)

    def _drain_retries(self, now: float) -> None:
        """Re-route every queued retry — on the caller's thread, the
        only thread allowed to call into engines (see module doc)."""
        while True:
            with self._lock:
                if not self._retry:
                    return
                rid = self._retry.popleft()
                entry = self._pending.get(rid)
            if entry is None or entry.fut.done():
                continue
            if entry.attempts >= self.max_attempts:
                with self._lock:
                    self._pending.pop(rid, None)
                    self.metrics.lost += 1
                entry.fut._fail(RuntimeError(
                    f"request {rid}: exhausted {entry.attempts} attempts "
                    f"across the fleet"))
                continue
            self._attempt(entry, now)

    def submit_future(self, req: RankRequest,
                      now: float | None = None) -> RankFuture:
        """Route one request; returns a fleet-level RankFuture that
        settles exactly once (hedged duplicates dedupe by rid)."""
        now = self.clock() if now is None else now
        self._maybe_tick(now)
        bucket_name = self._bucket_key(req)
        fut = RankFuture(req.rid, bucket_name)
        entry = _Pending(req=req, fut=fut, owners=self._owners(bucket_name))
        with self._lock:
            if req.rid in self._pending:
                raise ValueError(f"rid {req.rid} already in flight")
            self._pending[req.rid] = entry
            self.metrics.submitted += 1
        self._attempt(entry, now)
        self._drain_retries(now)
        return fut

    def submit(self, req: RankRequest, now: float | None = None):
        """Enqueue; returns fleet results retired so far (engine-style
        serving surface)."""
        self.submit_future(req, now)
        return self._take_done()

    def poll(self, now: float | None = None):
        """Deadline-flush every live replica, re-route queued retries,
        and return results retired so far."""
        now = self.clock() if now is None else now
        self._maybe_tick(now)
        for rep in self.replicas:
            if rep.crashed or not rep.health.routable:
                continue
            try:
                rep.engine.poll()
            except BaseException as err:
                self._replica_failed(rep, err, self.clock())
        self._drain_retries(now)
        return self._take_done()

    def observe_submission_lag(self, lag_ms: float) -> None:
        for rep in self.replicas:
            if not rep.crashed:
                rep.engine.observe_submission_lag(lag_ms)

    def refresh(self, tag: str | None = None) -> dict:
        """Run one refresh pass on every live replica's lane (replicas
        refresh independently — each lane sees only the telemetry its
        replica served)."""
        reports = {}
        for rep in self.replicas:
            if rep.lane is None or rep.crashed or not rep.health.routable:
                continue
            reports[rep.name] = rep.lane.refresh(tag)
        return reports

    def drain(self, max_rounds: int = 256):
        """Fleet-wide stream-end barrier: keep ticking (so due restarts
        fire), re-routing retries, and draining live replicas until no
        fleet future is unsettled. A replica whose injector holds a
        partial-drain kill crashes HERE — its queued requests hand off
        and re-route, which is exactly what this loop exists to absorb."""
        for _ in range(max_rounds):
            now = self.clock()
            self.tick(now)
            self._drain_retries(now)
            for rep in self.replicas:
                if rep.crashed or not rep.health.routable:
                    continue
                if rep.injector is not None:
                    rep.injector.draining = True
                try:
                    rep.engine.drain()
                except BaseException as err:
                    self._replica_failed(rep, err, self.clock())
                finally:
                    if rep.injector is not None:
                        rep.injector.draining = False
            self._drain_retries(self.clock())
            with self._lock:
                settled = not self._pending and not self._retry
            if settled:
                return self._take_done()
            time.sleep(0.001)  # crashed replicas' in-flight batches retire
        with self._lock:                   # on their worker threads
            stuck = sorted(self._pending)
        raise RuntimeError(f"fleet drain did not converge; rids still "
                           f"pending: {stuck[:16]}{'...' if len(stuck) > 16 else ''}")

    def serve_stream(self, requests, *, warmup: bool = True,
                     tick_every: int = 1):
        """Convenience loop: warm (unless already), then submit the
        stream with an explicit heartbeat tick every `tick_every`
        requests (deterministic tick indices for blackhole windows),
        and drain. Returns every result."""
        requests = list(requests)
        if warmup and not self._warmed:
            self.warmup(requests)
        results = []
        for i, req in enumerate(requests):
            results += self.submit(req)
            results += self.poll()
            if tick_every and i % tick_every == 0:
                self.tick()
        results += self.drain()
        return results

    def close(self) -> None:
        for rep in self.replicas:
            try:
                rep.engine.close()
            except BaseException:
                pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _take_done(self) -> list:
        with self._lock:
            out, self._done = self._done, []
        return out

    # -- accounting ----------------------------------------------------------

    def orphaned_futures(self) -> int:
        """Fleet futures minted but never settled — asserted == 0 after
        every chaos drain (nothing leaks, nothing hangs)."""
        with self._lock:
            return sum(1 for e in self._pending.values()
                       if not e.fut.done())

    def fleet_summary(self) -> dict:
        """FleetMetrics + per-replica health/engine rollup, cumulative
        across restarts (retired engines' metrics are kept)."""
        replicas = {}
        lat: list[float] = []
        for rep in self.replicas:
            metrics = rep.retired_metrics + [rep.engine.metrics]
            lat.extend(x for m in metrics for x in m.latencies_ms)
            replicas[rep.name] = {
                "state": rep.health.state,
                "transitions": len(rep.health.transitions),
                "restarts": len(rep.restore_history),
                "restored_epochs": (rep.restore_history[-1]
                                    if rep.restore_history else {}),
                "requests": sum(m.requests for m in metrics),
                "results": sum(m.results for m in metrics),
                "batches": sum(m.batches for m in metrics),
                "sheds": sum(m.sheds for m in metrics),
                "compiles_post_warmup": sum(m.compiles_post_warmup
                                            for m in metrics),
                "swaps": sum(m.swaps for m in metrics),
                "refresh_failures": sum(m.refresh_failures for m in metrics),
            }
        out = {**self.metrics.as_dict(),
               "orphaned_futures": self.orphaned_futures(),
               "replicas": replicas}
        if lat:
            arr = np.asarray(lat)
            out["latency_ms"] = {"p50": float(np.percentile(arr, 50)),
                                 "p99": float(np.percentile(arr, 99)),
                                 "count": int(arr.size)}
        return out
