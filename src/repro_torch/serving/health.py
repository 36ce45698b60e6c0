"""Per-replica health state machines for the port's serving fleet
(counterpart of repro.serving.health; pure host code, the same states,
thresholds and transitions).

A fleet router cannot ask a wedged replica whether it is wedged — it
has to infer health from the signals that keep flowing on the healthy
path anyway: heartbeats (delivered by FleetRouter's tick, suppressed
when the replica is crashed or its heartbeat channel is blackholed),
the per-replica service-latency EWMA the router measures on every
completed attempt, and the consecutive-failure counter its submission
attempts feed. Those three signals drive a four-state machine:

    HEALTHY ──(heartbeat stale ≥ suspect_after_s,
               or lag EWMA ≥ lag_suspect_ms,
               or a non-fatal failure)──────────────▶ SUSPECT
    SUSPECT ──(fresh heartbeat AND lag below the
               hysteresis threshold AND no recent
               failure)────────────────────────────▶ HEALTHY
    SUSPECT ──(heartbeat stale ≥ dead_after_s, or
               consecutive failures ≥ threshold)───▶ DEAD
    HEALTHY ──(fatal failure, e.g. ReplicaCrash)───▶ DEAD
    DEAD ────(supervised restart begins)───────────▶ RECOVERING
    RECOVERING ──(restart completed: checkpoint
               restored + bucket subset re-warmed)─▶ HEALTHY

DEAD is absorbing until the supervisor (FleetRouter) begins a restart:
a replica that stopped heartbeating does not resurrect itself just
because a late heartbeat straggles in — the router owns the
DEAD → RECOVERING → HEALTHY path, so routing decisions and restart
side effects (checkpoint restore, re-warm) can never disagree about
who is serving.

Asymmetric thresholds are the anti-flap design: entering SUSPECT is
cheap (a hedge costs one duplicate micro-batch row), so the suspect
deadline is short; entering DEAD triggers a restart (checkpoint
restore + re-warm), so it takes a much staler heartbeat or repeated
hard failures. Leaving SUSPECT requires the lag EWMA to fall below
`lag_hysteresis * lag_suspect_ms`, not merely below the entry
threshold — a replica hovering at the threshold hedges continuously
rather than toggling.

Everything is driven by an injected clock (`now` parameters), so a
frozen clock replays every transition deterministically.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

__all__ = [
    "HEALTHY", "SUSPECT", "DEAD", "RECOVERING",
    "HealthConfig", "ReplicaHealth", "backoff_s",
]

HEALTHY = "healthy"
SUSPECT = "suspect"
DEAD = "dead"
RECOVERING = "recovering"


@dataclass(frozen=True)
class HealthConfig:
    """Thresholds for one replica's health machine.

    suspect_after_s   heartbeat staleness that makes a replica SUSPECT
                      (hedging starts).
    dead_after_s      heartbeat staleness that makes it DEAD (restart
                      + failover). Must exceed suspect_after_s.
    lag_suspect_ms    service-latency EWMA at which a live replica is
                      SUSPECT anyway — a wedged-but-heartbeating
                      replica (the slow-replica fault) is as useless
                      as a dead one for deadline traffic.
    lag_hysteresis    SUSPECT clears only once the lag EWMA falls
                      below lag_hysteresis * lag_suspect_ms.
    lag_alpha         EWMA smoothing for observe_lag.
    fail_threshold    consecutive non-fatal failures that escalate to
                      DEAD (a single fatal failure — ReplicaCrash —
                      goes straight there).
    """

    suspect_after_s: float = 0.15
    dead_after_s: float = 0.50
    lag_suspect_ms: float = 250.0
    lag_hysteresis: float = 0.5
    lag_alpha: float = 0.3
    fail_threshold: int = 3

    def __post_init__(self):
        if self.dead_after_s <= self.suspect_after_s:
            raise ValueError(
                f"dead_after_s ({self.dead_after_s}) must exceed "
                f"suspect_after_s ({self.suspect_after_s})")
        if not 0.0 < self.lag_hysteresis <= 1.0:
            raise ValueError(
                f"lag_hysteresis must be in (0, 1], got {self.lag_hysteresis}")


@dataclass
class ReplicaHealth:
    """One replica's health state machine (see module doc for the
    transition diagram). The router feeds it heartbeats, per-attempt
    latency samples, and success/failure outcomes; `evaluate(now)`
    applies the deadline rules and returns the current state."""

    name: str
    config: HealthConfig = field(default_factory=HealthConfig)
    state: str = HEALTHY
    last_heartbeat: float = 0.0
    lag_ewma_ms: float = 0.0
    consecutive_failures: int = 0
    # audit trail of (t, from_state, to_state, reason) — what the
    # chaos tests replay against the fault plan.
    transitions: list = field(default_factory=list)

    def _move(self, now: float, to: str, reason: str) -> None:
        if to != self.state:
            self.transitions.append((now, self.state, to, reason))
            self.state = to

    # -- signals -------------------------------------------------------------

    def heartbeat(self, now: float) -> None:
        """A heartbeat was DELIVERED (the router's tick got a liveness
        ack; a blackholed or crashed replica never reaches here)."""
        self.last_heartbeat = now

    def observe_lag(self, lag_ms: float) -> None:
        """One completed attempt's submit→result latency on this
        replica — the wedged-replica signal."""
        a = self.config.lag_alpha
        self.lag_ewma_ms = (1.0 - a) * self.lag_ewma_ms + a * max(
            0.0, float(lag_ms))

    def on_success(self, now: float) -> None:
        self.consecutive_failures = 0

    def on_failure(self, now: float, *, fatal: bool = False) -> None:
        """A submission attempt on this replica failed. `fatal` (a
        ReplicaCrash — the process is gone) goes straight to DEAD;
        non-fatal failures escalate through SUSPECT to DEAD at the
        consecutive-failure threshold."""
        self.consecutive_failures += 1
        if self.state in (DEAD, RECOVERING):
            return
        if fatal:
            self._move(now, DEAD, "fatal-failure")
        elif self.consecutive_failures >= self.config.fail_threshold:
            self._move(now, DEAD,
                       f"{self.consecutive_failures}-consecutive-failures")
        else:
            self._move(now, SUSPECT, "failure")

    # -- state machine -------------------------------------------------------

    def evaluate(self, now: float) -> str:
        """Apply the heartbeat-deadline and lag-threshold rules and
        return the current state. DEAD and RECOVERING are untouched —
        only the supervisor's begin_recovery/mark_recovered move them."""
        cfg = self.config
        if self.state in (DEAD, RECOVERING):
            return self.state
        stale = now - self.last_heartbeat
        if stale >= cfg.dead_after_s:
            self._move(now, DEAD, f"heartbeat-stale-{stale:.3f}s")
        elif self.state == HEALTHY:
            if stale >= cfg.suspect_after_s:
                self._move(now, SUSPECT, f"heartbeat-stale-{stale:.3f}s")
            elif self.lag_ewma_ms >= cfg.lag_suspect_ms:
                self._move(now, SUSPECT,
                           f"lag-ewma-{self.lag_ewma_ms:.1f}ms")
        elif self.state == SUSPECT:
            fresh = stale < cfg.suspect_after_s
            calm = self.lag_ewma_ms < cfg.lag_hysteresis * cfg.lag_suspect_ms
            if fresh and calm and self.consecutive_failures == 0:
                self._move(now, HEALTHY, "recovered-signals")
        return self.state

    def begin_recovery(self, now: float) -> None:
        """The supervisor started a restart: DEAD → RECOVERING. The
        replica takes no routed traffic until mark_recovered."""
        if self.state != DEAD:
            raise RuntimeError(
                f"replica {self.name!r}: begin_recovery from {self.state} "
                f"(only DEAD replicas restart)")
        self._move(now, RECOVERING, "restart-begun")

    def mark_recovered(self, now: float) -> None:
        """Restart completed (state restored, bucket subset re-warmed):
        RECOVERING → HEALTHY with fresh signals."""
        if self.state != RECOVERING:
            raise RuntimeError(
                f"replica {self.name!r}: mark_recovered from {self.state}")
        self.consecutive_failures = 0
        self.lag_ewma_ms = 0.0
        self.last_heartbeat = now
        self._move(now, HEALTHY, "restart-completed")

    def fail_recovery(self, now: float) -> None:
        """The restart itself failed: RECOVERING → DEAD, so the
        supervisor's backoff schedule gets another attempt."""
        if self.state != RECOVERING:
            raise RuntimeError(
                f"replica {self.name!r}: fail_recovery from {self.state}")
        self._move(now, DEAD, "restart-failed")

    @property
    def routable(self) -> bool:
        """May the router send this replica traffic at all? (SUSPECT is
        routable — it just gets hedged.)"""
        return self.state in (HEALTHY, SUSPECT)


def backoff_s(attempt: int, *, base_s: float = 0.05, cap_s: float = 2.0,
              seed: int = 0) -> float:
    """Capped exponential backoff with deterministic jitter for restart
    attempt `attempt` (0-based): min(cap, base * 2^attempt) scaled by a
    jitter factor in [0.5, 1.0] derived by hashing (seed, attempt) —
    the decorrelation real jitter buys, replayable because the chaos
    harness replays everything."""
    if attempt < 0:
        raise ValueError(f"attempt must be >= 0, got {attempt}")
    raw = min(float(cap_s), float(base_s) * (2.0 ** attempt))
    digest = hashlib.blake2b(f"{seed}:{attempt}".encode(),
                             digest_size=8).digest()
    u = int.from_bytes(digest, "big") / float(2 ** 64)    # [0, 1)
    return raw * (0.5 + 0.5 * u)
