"""Online lambda-refresh lane of the port (counterpart of
repro.serving.refresh): predictor updates from serving telemetry,
published into a live ServingEngine through its epoch fence.

For each served request the rank kernel already audits the exposure
against the thresholds, and b - exposure is the subgradient of the dual
objective at the served lambda-hat. One projected subgradient step a
request,

    lambda_target = max(0, lambda_hat_served + eta * (b - exposure)),

gives a fresh (X, lambda_target) pair at no extra device cost: the audit
outputs and lambda-hat come home with every batch anyway. The engine's
_build_result feeds them to `observe`; `refresh` folds them into the
tag's state, family by family, and publishes the new generation through
`engine.swap_predictor`:

  KNN      ring-write the newest (X, lambda_target) rows over the oldest
           db rows (`knn_ring_update`): n_train is frozen, eviction
           strictly oldest-first. The db is cloned on its own device and
           the rows written with index_copy_, so the 1M-row db never
           comes to the host. A packed db repacks only the slabs the
           write touched (core.predictors.repack_knn_slabs), each with a
           fresh scale: bitwise a full repack of the new db.
  linear   anchored ridge re-solve (`ridge_refresh`): the live (W, c) is
           the prior anchor of a (d+1) x (d+1) solve.
  mean     running intercept (`running_mean_update`).
  mlp      warm-start re-fit: MLPLambdaPredictor.fit(init_params=live,
           num_steps=small) on the engine's device.

The pure update rules other than the ring write are numpy on the host,
as in the JAX package, and give its bits.

On the card the lane's device work (the ring write, the repack, the
re-fit, the swap's checks) runs on a stream of its own; the engine's
stream waits for it at the flip. Swap safety is the engine's: new state
is checked before the (state, epoch) pair flips under the lock every
flush reads it under, a refused (poisoned) generation leaves serving on
last-good with `refresh_failures` counted, and `rollback` re-publishes
the state live before the most recent successful swap.

Stationarity gate (two-sided): a refresh publishes only when the
drained telemetry shows dual pressure in either direction:
under-exposure shortfall (clip(b - exposure, 0)) or over-satisfaction
on rows served with lambda-hat > 0 (clip(exposure - b, 0), which the
symmetric step relaxes toward 0). Without either the lane never swaps,
and serving stays bitwise what it is without a lane.

`refresh()` runs synchronously (every N requests) or on a background
thread (`start(interval_s)`) that contains crashes: an exception inside
its loop counts a refresh failure and the loop keeps running.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.predictors import (
    KNNLambdaPredictor,
    LinearLambdaPredictor,
    MeanLambdaPredictor,
    MLPLambdaPredictor,
    repack_knn_slabs,
)
from repro_torch.device import resolve_device

__all__ = [
    "RefreshLane",
    "dual_refresh_targets",
    "knn_ring_update",
    "ridge_refresh",
    "running_mean_update",
]


def _host(x) -> np.ndarray:
    """x as a host numpy array (a tensor on any device is copied home)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Update rules
# ---------------------------------------------------------------------------

def dual_refresh_targets(lam, b, exposure, *, eta: float) -> np.ndarray:
    """Projected dual-subgradient targets: one step of size `eta` along
    b - exposure (the dual subgradient at the served lambda-hat),
    projected onto lambda >= 0. Under-exposed constraints push lambda
    up, over-exposed ones relax it, exactly-met ones keep it."""
    lam = np.asarray(_host(lam), np.float32)
    step = (np.asarray(_host(b), np.float32)
            - np.asarray(_host(exposure), np.float32))
    return np.maximum(lam + np.float32(eta) * step, 0.0).astype(np.float32)


def knn_ring_update(X_db, lam_db, X_new, lam_new, cursor: int, *,
                    return_written: bool = False, device=None):
    """Append-with-evict for a frozen-shape KNN db: write the new rows
    over the oldest ones at `cursor` (wrapping) and return the updated
    (X_db, lam_db) and the advanced cursor. The db is cloned on
    `device` (None = the db's own device when it is a tensor, else the
    card) and the rows written there with index_copy_: the inputs are
    left as they are, and the result is bitwise the JAX package's host
    copy. When more new rows arrive than the db holds, only the newest
    n_train survive. With `return_written`, a fourth element carries the
    sorted unique row indices written (int64, on the db's device): a
    packed db repacks exactly those rows' slabs."""
    if device is None and isinstance(X_db, torch.Tensor):
        dev = X_db.device
    else:
        dev = resolve_device(device)
    X_db = torch.as_tensor(X_db, device=dev).clone()
    lam_db = torch.as_tensor(lam_db, device=dev).clone()
    X_new = torch.as_tensor(X_new, dtype=X_db.dtype).to(dev)
    lam_new = torch.as_tensor(lam_new, dtype=lam_db.dtype).to(dev)
    n_train = X_db.shape[0]
    n = X_new.shape[0]
    if n == 0:
        idx = torch.zeros((0,), dtype=torch.int64, device=dev)
        return ((X_db, lam_db, cursor, idx) if return_written
                else (X_db, lam_db, cursor))
    if n > n_train:                         # only the newest rows survive
        X_new, lam_new = X_new[n - n_train:], lam_new[n - n_train:]
        cursor, n = (cursor + (n - n_train)) % n_train, n_train
    idx = (cursor + torch.arange(n, device=dev)) % n_train
    X_db.index_copy_(0, idx, X_new)
    lam_db.index_copy_(0, idx, lam_new)
    cursor = int((cursor + n) % n_train)
    if return_written:
        return X_db, lam_db, cursor, torch.unique(idx)
    return X_db, lam_db, cursor


def ridge_refresh(W, c, X_new, targets, *, mu: float = 32.0
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Anchored ridge re-solve on the augmented design x~ = [x; 1]:
    argmin_W~ sum |y - W~ x~|^2 + mu |W~ - W~_0|_F^2 with W~_0 = [W | c]
    the live weights, in closed form (a (d+1) x (d+1) solve in float64
    on the host). As mu grows the update vanishes: the anchor carries
    history across refreshes."""
    W = np.asarray(_host(W), np.float64)
    c = np.asarray(_host(c), np.float64)
    X_new = np.asarray(_host(X_new), np.float64)
    Y = np.asarray(_host(targets), np.float64)
    d = W.shape[1]
    Xa = np.concatenate([X_new, np.ones((X_new.shape[0], 1))], axis=1)
    G = mu * np.eye(d + 1) + Xa.T @ Xa                    # (d+1, d+1)
    W0a = np.concatenate([W, c[:, None]], axis=1)         # (K, d+1)
    rhs = mu * W0a.T + Xa.T @ Y                           # (d+1, K)
    Wa = np.linalg.solve(G, rhs).T                        # (K, d+1)
    return Wa[:, :d].astype(np.float32), Wa[:, d].astype(np.float32)


def running_mean_update(mean_lam, weight: float, targets
                        ) -> tuple[np.ndarray, float]:
    """Running intercept: the live mean counts as `weight` prior
    observations and the target rows average in. Returns (new mean,
    new weight)."""
    mean_lam = np.asarray(_host(mean_lam), np.float64)
    Y = np.asarray(_host(targets), np.float64)
    n = Y.shape[0]
    new = (weight * mean_lam + Y.sum(axis=0)) / (weight + n)
    return new.astype(np.float32), float(weight + n)


# ---------------------------------------------------------------------------
# The lane
# ---------------------------------------------------------------------------

@dataclass
class _TagBuffer:
    """Telemetry rows accumulated for one predictor tag since its last
    refresh. Bounded: only the newest `capacity` rows are kept."""

    X: list = field(default_factory=list)
    lam: list = field(default_factory=list)
    exposure: list = field(default_factory=list)
    b: list = field(default_factory=list)

    def trim(self, capacity: int) -> None:
        if len(self.X) > capacity:
            for rows in (self.X, self.lam, self.exposure, self.b):
                del rows[:len(rows) - capacity]


class RefreshLane:
    """Refresh lane for one ServingEngine (see the module docstring); it
    runs on the engine's device.

    eta             dual-subgradient step size.
    capacity        most telemetry rows buffered a tag (newest win).
    min_samples     rows required before a refresh publishes.
    min_shortfall   stationarity gate: publish only if some buffered
                    row's exposure shortfall sum, or its over-satisfaction
                    sum on rows served with lambda-hat > 0, exceeds this.
    mu              ridge anchor weight (linear family).
    mean_weight     prior weight of the live mean (mean family).
    mlp_steps/lr    warm-start re-fit budget (mlp family).
    checkpoint      optional checkpoint.CheckpointStore: every published
                    generation is also written as a per-(tag, epoch)
                    checkpoint (save_predictor_epoch), what a restarted
                    replica resumes from. A failed write never
                    un-publishes the swap (the report's `checkpointed`).
    publish_filter  optional hook (tag, state) -> state applied to the
                    candidate just before the swap: the seam through which
                    a poisoned state reaches the engine's refusal path.

    Each report of a swap carries `ms`: the host times of its drain and
    update (with the lane's device work synchronised), its swap (checks
    and flip, metrics.swap_validate_ms / swap_flip_ms split them) and,
    with a store, its checkpoint write.
    """

    def __init__(self, engine, *, eta: float = 0.5, capacity: int = 4096,
                 min_samples: int = 8, min_shortfall: float = 0.0,
                 mu: float = 32.0, mean_weight: float = 32.0,
                 mlp_steps: int = 50, mlp_lr: float = 1e-2,
                 checkpoint=None, publish_filter=None):
        self.engine = engine
        self.device = engine.device
        self.eta = float(eta)
        self.capacity = int(capacity)
        self.min_samples = int(min_samples)
        self.min_shortfall = float(min_shortfall)
        self.mu = float(mu)
        self.mlp_steps = int(mlp_steps)
        self.mlp_lr = float(mlp_lr)
        self.checkpoint = checkpoint
        self.publish_filter = publish_filter
        # the lane's device work goes to its own stream: the engine's
        # batches keep their stream to themselves
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        # _lock guards the telemetry buffers (observe runs on the
        # engine's consumer threads). _refresh_lock serializes whole
        # refresh passes: the background loop, a synchronous refresh()
        # and stop()'s final refresh must never interleave, or two
        # passes would build on one live state and publish one
        # telemetry window twice (racing _knn_cursor / _mean_weight).
        self._lock = threading.Lock()
        self._refresh_lock = threading.Lock()
        self._buf: dict[str, _TagBuffer] = {}
        self._mean_weight: dict[str, float] = {}
        self._default_mean_weight = float(mean_weight)
        self._knn_cursor: dict[str, int] = {}
        # the state live before the most recent successful swap, per
        # tag: what rollback() re-publishes
        self._last_good: dict[str, dict] = {}
        self._thread: threading.Thread | None = None
        self._stop_evt = threading.Event()
        engine.attach_refresh(self)

    # -- telemetry ingest (called by engine._build_result) -------------------

    def observe(self, tag: str, *, X, lam, exposure, b) -> None:
        """One served request's telemetry row: covariates, the
        lambda-hat its batch served, and the audited exposure against
        the thresholds, all at the tag's predictor width, all host
        numpy."""
        with self._lock:
            buf = self._buf.setdefault(tag, _TagBuffer())
            buf.X.append(np.asarray(X, np.float32))
            buf.lam.append(np.asarray(lam, np.float32))
            buf.exposure.append(np.asarray(exposure, np.float32))
            buf.b.append(np.asarray(b, np.float32))
            buf.trim(self.capacity)

    def pending(self, tag: str) -> int:
        """Telemetry rows buffered for `tag` since its last refresh."""
        with self._lock:
            buf = self._buf.get(tag)
            return 0 if buf is None else len(buf.X)

    # -- refresh -------------------------------------------------------------

    def refresh(self, tag: str | None = None) -> dict:
        """Drain the buffered telemetry and, where it warrants one,
        publish a new predictor generation. Never raises on a failed
        publish: the engine refuses bad state, `refresh_failures`
        counts it, serving stays on last-good, and the report says what
        happened. Returns {tag: report} (one tag when given). Whole
        passes are serialized (`_refresh_lock`)."""
        with self._refresh_lock:
            tags = [tag] if tag is not None else sorted(self._buf)
            return {t: self._refresh_tag(t) for t in tags}

    def _drain(self, tag: str):
        with self._lock:
            buf = self._buf.pop(tag, None)
        if buf is None or not buf.X:
            return None
        return (np.stack(buf.X), np.stack(buf.lam),
                np.stack(buf.exposure), np.stack(buf.b))

    def _on_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        # the live state may have been written on the caller's stream
        self._stream.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self._stream)

    def _sync(self) -> None:
        if self._stream is not None:
            self._stream.synchronize()

    def _refresh_tag(self, tag: str) -> dict:
        report = {"swapped": False, "epoch": None, "n": 0,
                  "max_shortfall": 0.0, "max_decay": 0.0, "reason": None}
        t0 = time.perf_counter()
        drained = self._drain(tag)
        if drained is None:
            report["reason"] = "no-telemetry"
            return report
        X, lam, exposure, b = drained
        report["n"] = int(X.shape[0])
        if X.shape[0] < self.min_samples:
            report["reason"] = "below-min-samples"
            return report
        shortfall = np.clip(b - exposure, 0.0, None).sum(axis=1)
        # decay pressure: over-satisfied constraints still carrying a
        # positive served lambda-hat
        decay = (np.clip(exposure - b, 0.0, None)
                 * (lam > 0.0)).sum(axis=1)
        report["max_shortfall"] = float(shortfall.max())
        report["max_decay"] = float(decay.max())
        if (report["max_shortfall"] <= self.min_shortfall
                and report["max_decay"] <= self.min_shortfall):
            # stationarity gate: no dual pressure either way teaches
            # nothing, and publishing would still move KNN neighbourhoods
            report["reason"] = "no-pressure"
            return report
        targets = dual_refresh_targets(lam, b, exposure, eta=self.eta)
        try:
            with self._on_stream():
                new_state = self._updated_state(tag, X, targets)
                self._sync()
                t1 = time.perf_counter()
                if self.publish_filter is not None:
                    new_state = self.publish_filter(tag, new_state)
                prev = self.engine.predictor_state_of(tag)
                epoch = self.engine.swap_predictor(tag, new_state)
            t2 = time.perf_counter()
        except Exception as e:            # noqa: BLE001 - lane must survive
            self.engine.metrics.on_refresh_failure(tag)
            report["reason"] = f"refused: {e}"
            return report
        self._last_good[tag] = prev
        report["swapped"] = True
        report["epoch"] = epoch
        report["ms"] = {"drain_update": (t1 - t0) * 1e3,
                        "swap": (t2 - t1) * 1e3}
        if self.checkpoint is not None:
            # persist the published generation for a restart. The swap
            # already flipped: a failed write costs restartability, never
            # liveness, so it only marks the report (and counts a
            # refresh failure)
            try:
                self.checkpoint.save_predictor_epoch(tag, epoch, new_state)
                report["checkpointed"] = True
            except Exception:             # noqa: BLE001
                self.engine.metrics.on_refresh_failure(tag)
                report["checkpointed"] = False
            report["ms"]["checkpoint"] = (time.perf_counter() - t2) * 1e3
        return report

    def _updated_state(self, tag: str, X: np.ndarray,
                       targets: np.ndarray) -> dict:
        """The tag's next-generation state dict, built on the live one
        (which stays untouched), per family, shapes frozen."""
        template = self.engine.predictor_template(tag)
        state = self.engine.predictor_state_of(tag)
        dev = self.device
        if isinstance(template, KNNLambdaPredictor):
            cursor = self._knn_cursor.get(tag, 0)
            X_db, lam_db, cursor, written = knn_ring_update(
                state["X_db"], state["lam_db"], X, targets, cursor,
                return_written=True, device=dev)
            self._knn_cursor[tag] = cursor
            if template.X_q is None:
                return {"X_db": X_db, "lam_db": lam_db}
            # a packed db: repack only the slabs the write touched, each
            # with a fresh scale from its rows after the write, so a swap
            # never serves a scale older than its slab's rows
            slab = (state["X_q"].shape[0]
                    // max(state["q_scale"].shape[0], 1))
            X_q, q_scale, y2_q = repack_knn_slabs(
                X_db, state["X_q"], state["q_scale"], state["y2_q"],
                written, mode=template.quant, slab=slab)
            return {"X_db": X_db, "lam_db": lam_db, "X_q": X_q,
                    "q_scale": q_scale, "y2_q": y2_q}
        if isinstance(template, LinearLambdaPredictor):
            W, c = ridge_refresh(state["W"], state["c"], X, targets,
                                 mu=self.mu)
            return {"W": torch.from_numpy(W).to(dev),
                    "c": torch.from_numpy(c).to(dev)}
        if isinstance(template, MeanLambdaPredictor):
            weight = self._mean_weight.get(tag, self._default_mean_weight)
            mean, weight = running_mean_update(
                state["mean_lam"], weight, targets)
            self._mean_weight[tag] = weight
            return {"mean_lam": torch.from_numpy(mean).to(dev)}
        if isinstance(template, MLPLambdaPredictor):
            refit = MLPLambdaPredictor.fit(
                X, targets, init_params=state["params"],
                num_steps=self.mlp_steps, lr=self.mlp_lr, device=dev)
            return {"params": refit.params}
        raise TypeError(f"no refresh rule for {type(template).__name__}")

    def rollback(self, tag: str) -> int:
        """Re-publish the generation live before the most recent
        successful swap, as a new epoch (the fence still applies:
        in-flight batches finish on what they were dispatched against).
        Raises KeyError if this lane never swapped `tag`."""
        prev = self._last_good.get(tag)
        if prev is None:
            raise KeyError(f"no pre-swap state recorded for {tag!r}")
        return self.engine.swap_predictor(tag, prev)

    # -- background thread ---------------------------------------------------

    def start(self, interval_s: float) -> None:
        """Run `refresh()` every `interval_s` on a daemon thread. An
        exception inside the loop (refresh() raises only on a fault of
        the lane itself, never on a refused swap) counts one refresh
        failure and the loop goes on: the lane never takes serving
        down."""
        if self._thread is not None:
            raise RuntimeError("refresh lane already started")
        self._stop_evt.clear()

        def loop():
            while not self._stop_evt.wait(interval_s):
                try:
                    self.refresh()
                except Exception:         # noqa: BLE001 - contain crashes
                    self.engine.metrics.on_refresh_failure("_lane")
        self._thread = threading.Thread(
            target=loop, name="refresh-lane", daemon=True)
        self._thread.start()

    def stop(self, *, final_refresh: bool = False) -> None:
        """Stop the background thread (idempotent). With
        `final_refresh`, drain the remaining telemetry through one last
        synchronous refresh after the thread has exited. The thread is
        joined until it has exited, never abandoned on a timeout: a
        final refresh beside a pass still in flight would publish one
        telemetry window twice (refresh() is serialized on
        `_refresh_lock` besides)."""
        self._stop_evt.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            while thread.is_alive():
                thread.join(timeout=1.0)
        if final_refresh:
            self.refresh()
