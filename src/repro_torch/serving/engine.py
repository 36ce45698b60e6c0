"""Streaming serving engine of the port (counterpart of
repro.serving.ServingEngine): shape-bucketed micro-batching over the
online stage, with async double-buffered execution on a CUDA stream.

The unit of work is one RankRequest: one user's candidate utilities,
constraint attributes and thresholds, slot count, and either shadow
prices (lam) or the covariates X of a registered lambda predictor. The
engine

  1. maps each request to a shape Bucket, runs admission (deadline,
     degradation ladder, shed), mints its RankFuture and appends it to
     the bucket's queue;
  2. flushes a queue when it reaches the bucket's capacity, when its
     oldest request has waited max_wait_ms (`poll`), or on `drain`;
  3. SUBMISSION SIDE (the caller's thread): packs the flushed batch into
     a recycled StagingRing slot (page-locked host memory on the card),
     then on the engine's own CUDA stream copies it to the slot's device
     set without blocking, makes ONE dispatcher call into kernels.ops
     (the bucket's tag fixes the route: `rank_audited` for lambda-given
     requests, `knn_rank_audited` or its quantized twin for a KNN
     predictor, `linear_rank_audited` for a mean or linear predictor,
     whose W and c the engine pads to the bucket's K once, and the MLP's
     lambda-hat as torch ops before `rank_audited`; above m2 = 128 the
     sort route's torch ops, on the same stream), copies the five
     outputs into the slot's page-locked output set without blocking,
     and records an event after them;
  4. COMPLETION SIDE (the pipeline worker): waits on batch N's event
     while the card runs batch N+1, copies the outputs out of the slot,
     stamps completion, feeds admission, recycles the slot and marks the
     futures done. Unpadding runs lazily on the consuming thread.

With executor="xla" (JAX's default) the dispatcher call of step 3
becomes JAX's two-stage body as torch ops with no kernel launch: the
predictor's own `predict`, then core.ranking.rank_given_lambda. With
executor="dist" and a launch.mesh.Mesh the dispatcher call of
step 3 becomes lambda-hat, then core.serving_dist.rank_distributed over
the mesh (the candidate axis split over 'model', each shard's top m2
merged on the engine's device), as JAX's `dist` executor does; the
copies, the event, the pins and the ring are the same.

`pipeline_depth` bounds the in-flight window: 1 (the default) is double
buffering; 0 retires every batch inline on the calling thread, through
the same slots and copies, with bitwise the same results. On the CPU
(`device="cpu"`) the same ring runs without page-locking or events, and
the worker thread still retires the batches.

Predictor generations (the refresh lane's seam, serving/refresh.py):
each tag serves a state dict (core.predictors.predictor_state) with a
monotone epoch. `swap_predictor` checks a new state against the live
one (keys, structure, shapes, dtypes, and finiteness on the device with
one sync), makes the engine's stream wait for the stream that wrote it,
then flips (state, epoch) under the lock every flush reads it under: a
batch is dispatched against exactly one generation and stamps its
epoch. The generation stays pinned until the batch has passed its event,
and a superseded one is let go only when no batch pins it.

The bucket lattice (serving/lattice.py's seam): the live Lattice routes
every bucket_of; `shape_histogram` counts each request's real geometry
at enqueue. A corner is warm once its StagingRing is allocated on the
engine's stream, an affine predictor's W and c are padded to its K and a
phantom batch has run there; `_exec` maps each warm bucket to its call
(what a fault injector wraps). `shadow_warm_lattice` warms a proposed
lattice's corners on the calling thread (a LatticeLane's) and installs
each under the swap lock; `swap_lattice` refuses a lattice whose
observed buckets are not warm and flips (lattice, epoch) under the lock
every flush stamps its batch under. A ring allocated on the dispatch
path after warmup counts in `metrics.compiles_post_warmup` (the JAX
engine's name for a compile there): the contract is that it stays 0.
Nothing in the engine waits on the whole device: warmup and shadow warm
wait on their batches' events and the engine's own stream, so replicas
and lanes that share the card do not stall one another.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.checkpoint.store import flatten_with_paths, unflatten_like
from repro_torch.core.predictors import (
    LinearLambdaPredictor,
    MLPLambdaPredictor,
    predictor_state,
    with_state,
)
from repro_torch.core.ranking import RankingOutput, rank_given_lambda
from repro_torch.core.serving_dist import (
    dist_kernel_launches,
    rank_distributed,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import build, ops, ref
from repro_torch.serving.admission import SHED_RUNG, AdmissionController
from repro_torch.serving.buckets import (
    Bucket,
    fill_staging,
    fill_stats,
    unpad_result,
)
from repro_torch.serving.lattice import Lattice, ShapeHistogram
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.pipeline import (
    ExecutionPipeline,
    PendingBatch,
    RankFuture,
    StagingRing,
)

LAM_TAG = "_lam"   # requests that carry shadow prices directly

# Default per-request latency budget: the paper's 50 ms.
DEFAULT_BUDGET_S = 0.050


@dataclass
class RankRequest:
    """One user's ranking problem; arrays are host (numpy) payloads.

    `deadline` is absolute (in the engine's clock); `budget_s` is
    relative to enqueue. With neither, the request's surface budget (or
    the engine's default_budget_s) applies; with both, `deadline` wins."""

    rid: int
    u: np.ndarray                     # (m1,) candidate utilities
    a: np.ndarray                     # (K, m1) constraint attributes
    b: np.ndarray                     # (K,) exposure thresholds
    m2: int                           # slots to fill (m2 <= m1)
    lam: np.ndarray | None = None     # (K,) shadow prices, if given
    X: np.ndarray | None = None       # (d,) covariates for the predictor
    tag: str = LAM_TAG                # predictor tag
    gamma: np.ndarray | None = None   # (m2,) slot discounts; default DCG
    deadline: float | None = None     # absolute deadline (engine clock)
    budget_s: float | None = None     # relative budget (enqueue + budget_s)
    surface: str = "default"          # budget class (surface_budgets)

    def __post_init__(self):
        if self.lam is None and self.X is None:
            raise ValueError(f"request {self.rid}: need lam or X")
        if self.m2 > self.u.shape[0]:
            raise ValueError(f"request {self.rid}: m2 > m1")


@dataclass
class RankResult:
    rid: int
    perm: np.ndarray                  # (m2,) item indices by slot
    utility: float
    exposure: np.ndarray              # (K,)
    compliant: bool
    bucket: str
    latency_ms: float                 # enqueue -> result materialized
    wait_ms: float                    # enqueue -> batch launch
    deadline_hit: bool | None = None  # materialized before the deadline?
    rung: int = 0                     # degradation rung served (0 = own)
    epoch: int = 0                    # predictor generation that served it
    lattice_epoch: int = 0            # bucket-lattice generation at dispatch


@dataclass
class Shed:
    """Typed admission-shed outcome: the request's RankFuture resolves
    with this (not an exception) when every rung of its ladder was
    predicted to miss the deadline. `predicted_ms` is the cheapest
    rung's prediction against `budget_ms`."""

    rid: int
    bucket: str                       # the request's home bucket
    predicted_ms: float
    budget_ms: float
    reason: str = "predicted-miss-at-every-rung"
    rung: int = SHED_RUNG


@dataclass
class _QueueEntry:
    """One admitted request in (or flushed from) a bucket queue."""

    req: RankRequest
    t_enq: float
    fut: Any                          # RankFuture
    deadline: float                   # absolute, engine clock
    rung: int                         # degradation rung being served


class ServingEngine:
    """Shape-bucketed micro-batching over the online stage.

    device: None means the card (RuntimeError without CUDA); the tests
    pass "cpu" to run the plain PyTorch path. pipeline_depth: batches
    the submission side may run ahead of the one retiring (0 = inline).
    admission: None admits everything (results still carry
    `deadline_hit`); True or an AdmissionController checks every submit
    against its deadline: admit on rung 0, degrade down the tag's ladder
    (`set_degradation_ladder`), or shed. surface_budgets: default budget
    (s) per RankRequest.surface; others get default_budget_s. lattice:
    the boot bucket lattice (None = the static power-of-two one). clock:
    the engine's time source, injectable so tests can freeze it.

    executor: 'fused' (the port's default: on the card the kernels
    are the main path) makes one dispatcher call into kernels.ops a
    batch; 'xla' (JAX's default, its two-stage body) launches no kernel:
    lambda-hat (given, or the predictor's own `predict` in f32
    zero-padded to the bucket's K), then core.ranking.rank_given_lambda
    (einsum score, stable sort, audit) as torch ops; 'dist' ranks each
    batch with core.serving_dist.rank_distributed over `mesh` (a
    launch.mesh.Mesh that holds the engine's device: the candidate axis
    split over its 'model' axis, the batch over 'pod' and 'data'), after
    lambda-hat (`ops.lambda_hat`: given; KNN by the knn_lambda kernel;
    affine by the linear kernel's prologue arithmetic on the bucket's
    padded W and c; the MLP's predict) zero-padded to the bucket's K.
    """

    def __init__(self, *, max_batch: int = 32, max_wait_ms: float = 2.0,
                 eps: float = 1e-4, executor: str = "fused", mesh=None,
                 pipeline_depth: int = 1,
                 admission: AdmissionController | bool | None = None,
                 default_budget_s: float = DEFAULT_BUDGET_S,
                 surface_budgets: dict[str, float] | None = None,
                 lattice: Lattice | None = None,
                 clock: Callable[[], float] = time.perf_counter,
                 device=None):
        if executor not in ("xla", "fused", "dist"):
            raise ValueError(f"unknown executor {executor!r}")
        if executor == "dist" and mesh is None:
            raise ValueError("executor='dist' needs a mesh")
        if pipeline_depth < 0:
            raise ValueError(f"pipeline_depth must be >= 0, got "
                             f"{pipeline_depth}")
        self.device = resolve_device(device)
        if mesh is not None and self.device not in mesh.physical_devices:
            raise ValueError(f"the mesh's devices {mesh.physical_devices} "
                             f"do not hold the engine's {self.device}")
        self.executor = executor
        self.mesh = mesh
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.eps = float(eps)
        self.pipeline_depth = int(pipeline_depth)
        if admission is True:
            admission = AdmissionController()
        elif admission is False:
            admission = None
        self.admission: AdmissionController | None = admission
        self.default_budget_s = float(default_budget_s)
        self.surface_budgets = {str(k): float(v)
                                for k, v in (surface_budgets or {}).items()}
        lattice = Lattice() if lattice is None else lattice
        lattice.validate()
        self._lattice: Lattice = lattice
        self._lattice_epoch: int = 0
        self.shape_histogram = ShapeHistogram()
        self._lattice_lane = None
        self.clock = clock
        self.metrics = EngineMetrics()
        # every batch's copies and launches go to this one stream: the
        # legacy default stream would serialise with all other work
        self._stream = (torch.cuda.Stream(device=self.device)
                        if self.device.type == "cuda" else None)
        # per tag: the registered predictor (the template whose family
        # and non-array fields pick the route) and its live generation,
        # the state dict the dispatcher serves with and a monotone epoch.
        # A superseded generation waits in _old_states until no batch
        # pins it (_inflight_gens counts the batches dispatched against
        # each (tag, epoch) and not yet past their event).
        self._predictors: dict = {}
        self._pred_state: dict[str, dict] = {}
        self._pred_epoch: dict[str, int] = {}
        self._old_states: dict[str, dict[int, dict]] = {}
        self._inflight_gens: dict[tuple[str, int], int] = {}
        self._swap_lock = threading.Lock()
        self._refresh = None              # attached RefreshLane, if any
        self._d_cov: dict[str, int] = {}
        self._ladders: dict[str, tuple[str, ...]] = {}
        # bucket -> (W, c, relu) of an affine predictor padded to the
        # bucket's K, and the epoch it was built for: once a generation.
        # _affine, _rings, _launches, _exec and _warmed change only under
        # _swap_lock: a shadow warm installs corners from another thread.
        self._affine: dict[Bucket, tuple] = {}
        self._affine_epoch: dict[Bucket, int] = {}
        self._queues: dict[Bucket, list] = {}
        self._rings: dict[Bucket, StagingRing] = {}
        self._launches: dict[Bucket, int] = {}
        self._exec: dict[Bucket, Callable] = {}
        self._warmed: set[Bucket] = set()
        self._in_warmup = False
        self._uncollected_sheds: list[Shed] = []
        self._retired_sync: list[PendingBatch] = []
        self._pipeline = (ExecutionPipeline(depth=self.pipeline_depth)
                          if self.pipeline_depth > 0 else None)
        self._closed = False

    # -- predictors ---------------------------------------------------------

    def register_predictor(self, tag: str, predictor, *, d_cov: int) -> None:
        """Attach a fitted KNN (f32 or quantized), linear, mean or MLP
        predictor under `tag`. Its tensors, a KNN pack included, move to
        the engine's device once, here, and stay there; it prices
        `predictor.num_constraints` constraints. Its state is published
        as the tag's generation 0."""
        if tag == LAM_TAG:
            raise ValueError(f"{LAM_TAG!r} is reserved for raw-lam requests")
        if predictor is None:
            raise ValueError("register_predictor needs a fitted predictor")
        if ops.route_of(predictor) == "knn":   # raises for a non-predictor
            d_pred = predictor.X_db.shape[1]
        elif isinstance(predictor, LinearLambdaPredictor):
            d_pred = predictor.W.shape[1]
        elif isinstance(predictor, MLPLambdaPredictor):
            d_pred = predictor.params["w1"].shape[0]
        else:
            d_pred = d_cov          # the mean family ignores covariates
        if d_pred != d_cov:
            raise ValueError(f"predictor takes d={d_pred} covariates, not "
                             f"d_cov={d_cov}")
        if predictor.device != self.device:
            predictor = predictor.to(self.device)
        if self._stream is not None:
            # the move ran on the caller's stream; the engine's reads after
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._predictors[tag] = predictor
        self._d_cov[tag] = int(d_cov)
        with self._swap_lock:
            self._pred_state[tag] = predictor_state(predictor)
            self._pred_epoch[tag] = 0

    def set_degradation_ladder(self, tag: str, fallbacks) -> None:
        """Register `tag`'s degradation ladder: when admission predicts
        that rung 0 (the tag's own predictor) would miss a deadline,
        requests go to fallbacks[0], then fallbacks[1], ... before they
        are shed. Every fallback must be registered, take the same
        covariates and price at least as many constraints as `tag`."""
        if tag not in self._predictors:
            raise KeyError(f"no predictor registered for tag {tag!r}")
        fallbacks = tuple(fallbacks)
        K = self._predictors[tag].num_constraints
        for fb in fallbacks:
            if fb not in self._predictors:
                raise KeyError(f"ladder fallback {fb!r} is not a "
                               f"registered predictor")
            if self._d_cov[fb] != self._d_cov[tag]:
                raise ValueError(
                    f"ladder fallback {fb!r}: d_cov {self._d_cov[fb]} != "
                    f"{self._d_cov[tag]} of {tag!r}")
            K_fb = self._predictors[fb].num_constraints
            if K_fb < K:
                raise ValueError(
                    f"ladder fallback {fb!r} emits {K_fb} shadow prices "
                    f"< the {K} that {tag!r} serves")
        self._ladders[tag] = fallbacks

    # -- predictor hot swap (serving/refresh.py's engine seam) ---------------

    def attach_refresh(self, lane) -> None:
        """Attach a refresh lane: every predictor-served result's
        (X, lambda-hat, exposure, b) row goes to `lane.observe` when the
        result is built, from the outputs already on the host."""
        self._refresh = lane

    def predictor_epoch(self, tag: str) -> int:
        """The tag's current predictor generation (0 = as registered)."""
        return self._pred_epoch[tag]

    def predictor_tags(self) -> tuple[str, ...]:
        """Registered predictor tags (what a restarted replica restores
        from epoch checkpoints)."""
        return tuple(self._predictors)

    def predictor_state_of(self, tag: str) -> dict:
        """The tag's live state dict (tensors on the engine's device):
        what the next flush dispatches against. The refresh lane builds
        its updates on it and never writes into it."""
        with self._swap_lock:
            return self._pred_state[tag]

    def predictor_template(self, tag: str):
        """The registered predictor (its family and non-array fields
        pick the route; its arrays are generation 0's, not necessarily
        the live ones)."""
        return self._predictors[tag]

    def swap_predictor(self, tag: str, new, *, epoch: int | None = None
                       ) -> int:
        """Epoch-fenced two-phase swap of `tag`'s predictor state.

        `new` is a state dict (core.predictors.predictor_state; tensors
        on any device, or numpy) or a predictor to take the state from.
        Phase 1 (publish) checks keys, structure, shapes and dtypes
        against the live generation (shapes are frozen: the warmed
        buckets and their rings were built for them) and raises
        ValueError on a mismatch, moves the leaves to the engine's
        device, and checks every float leaf finite there, with one sync
        for all of them: a poisoned state is refused and serving stays
        on the live generation. Phase 2 (flip) makes the engine's stream
        wait for the stream that wrote the new state, then swaps the
        (state, epoch) pair under the lock every flush reads it under,
        so a batch is dispatched against exactly one generation. The
        superseded generation is let go once no batch pins it.

        Returns the new epoch. `epoch` pins the published generation's
        number instead of current + 1 (a restored replica resumes its
        checkpoint's epoch); epochs are monotone, so a pinned epoch at
        or below the live one raises."""
        if tag not in self._predictors:
            raise KeyError(f"no predictor registered for tag {tag!r}")
        t0 = time.perf_counter()
        state = dict(new) if isinstance(new, dict) else predictor_state(new)
        cur = self.predictor_state_of(tag)
        if not cur:
            raise ValueError(
                f"swap {tag!r}: predictor family has no registered "
                f"refreshable state (core.predictors.STATE_FIELDS)")
        if set(state) != set(cur):
            raise ValueError(
                f"swap {tag!r}: state keys {sorted(state)} != "
                f"{sorted(cur)} of the live generation")
        cur_leaves = flatten_with_paths(cur)
        new_leaves = flatten_with_paths(state)
        if list(new_leaves) != list(cur_leaves):
            raise ValueError(
                f"swap {tag!r}: state tree structure differs from the "
                f"live generation (the warmed buckets serve its layout)")
        moved = {}
        for path, leaf in new_leaves.items():
            live = cur_leaves[path]
            leaf = torch.as_tensor(leaf)
            if leaf.shape != live.shape or leaf.dtype != live.dtype:
                raise ValueError(
                    f"swap {tag!r}: leaf {path} is {tuple(leaf.shape)}/"
                    f"{leaf.dtype}, live generation has "
                    f"{tuple(live.shape)}/{live.dtype} — shapes are "
                    f"frozen (the no-recompile contract)")
            moved[path] = leaf.to(self.device)
        # finiteness on the device: one flag a float leaf, one sync (the
        # 1M-row KNN db never comes to the host)
        floats = [p for p, t in moved.items() if t.is_floating_point()]
        if floats:
            finite = torch.stack([torch.isfinite(moved[p]).all()
                                  for p in floats]).cpu()
            if not bool(finite.all()):
                bad = floats[int(torch.nonzero(~finite)[0, 0])]
                raise ValueError(
                    f"swap {tag!r}: non-finite values in leaf {bad} — "
                    f"poisoned state refused, serving stays on the live "
                    f"generation")
        state = unflatten_like(state, moved)
        t1 = time.perf_counter()
        if self._stream is not None:
            # the new state was written on the caller's (or the lane's)
            # stream; every batch dispatched after the flip reads it
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        with self._swap_lock:             # phase 2: flip at a batch boundary
            old_epoch = self._pred_epoch[tag]
            new_epoch = old_epoch + 1 if epoch is None else int(epoch)
            if new_epoch <= old_epoch:
                raise ValueError(
                    f"swap {tag!r}: pinned epoch {new_epoch} <= live epoch "
                    f"{old_epoch} — epochs are monotone (restore resumes, "
                    f"never rewinds)")
            self._old_states.setdefault(tag, {})[old_epoch] = \
                self._pred_state[tag]
            self._pred_state[tag] = state
            self._pred_epoch[tag] = new_epoch
            self._retire_unpinned(tag)
        self.metrics.on_swap(tag, validate_ms=(t1 - t0) * 1e3,
                             flip_ms=(time.perf_counter() - t1) * 1e3)
        return new_epoch

    def _current_gen(self, tag: str) -> tuple[dict, int]:
        """The (state, epoch) pair a flush dispatches against, read
        atomically and pinned: the other half of the swap fence."""
        with self._swap_lock:
            epoch = self._pred_epoch[tag]
            self._inflight_gens[(tag, epoch)] = (
                self._inflight_gens.get((tag, epoch), 0) + 1)
            return self._pred_state[tag], epoch

    def _release_gen(self, tag: str, epoch: int) -> None:
        """A batch dispatched against (tag, epoch) has passed its event:
        unpin the generation and let it go if it is superseded and no
        other batch still holds it."""
        key = (tag, epoch)
        with self._swap_lock:
            n = self._inflight_gens.get(key, 1) - 1
            if n <= 0:
                self._inflight_gens.pop(key, None)
            else:
                self._inflight_gens[key] = n
            self._retire_unpinned(tag)

    def _retire_unpinned(self, tag: str) -> None:
        # caller holds _swap_lock. Why the pins, on the card: a
        # superseded generation's tensors were allocated on another
        # stream (the caller's or the lane's), while batches on the
        # engine's stream read them. Were its last reference dropped
        # while such a batch is in flight, the caching allocator could
        # hand the memory to a new allocation on the writer's stream,
        # and a refresh could overwrite rows the batch still reads. So a
        # generation stays referenced until every batch that pinned it
        # has passed its event. record_stream is not used besides: when
        # the pins let a generation go, no work that reads it is pending
        # on the engine's stream, so there is nothing left for the
        # allocator to wait for.
        old = self._old_states.get(tag)
        if not old:
            return
        cur = self._pred_epoch[tag]
        for e in [e for e in old
                  if e < cur and (tag, e) not in self._inflight_gens]:
            del old[e]
            self.metrics.on_state_retired(tag)

    # -- bucketing ----------------------------------------------------------

    def bucket_of(self, req: RankRequest,
                  lattice: Lattice | None = None) -> Bucket:
        """Route a request to its bucket on the live lattice (or on
        `lattice`: a shadow warm routes against a proposal before it
        flips)."""
        lattice = self._lattice if lattice is None else lattice
        tag = LAM_TAG if req.lam is not None else req.tag
        K = req.a.shape[0]
        if tag != LAM_TAG:
            if tag not in self._predictors:
                raise KeyError(f"no predictor registered for tag {tag!r}")
            K_pred = self._predictors[tag].num_constraints
            if K > K_pred:
                raise ValueError(
                    f"request {req.rid}: {K} constraints but predictor "
                    f"{tag!r} emits only {K_pred} shadow prices")
            K = K_pred
        return lattice.bucket_for(m1=req.u.shape[0], m2=req.m2, K=K,
                                  tag=tag, batch=self.max_batch)

    def _rung_buckets(self, req: RankRequest, home: Bucket,
                      lattice: Lattice | None = None
                      ) -> list[tuple[int, Bucket]]:
        """The request's degradation ladder as (rung, bucket) pairs, rung
        0 (its own bucket) first. Raw-lam requests have no ladder."""
        lattice = self._lattice if lattice is None else lattice
        rungs = [(0, home)]
        if req.X is None or home.tag == LAM_TAG:
            return rungs
        K_req = req.a.shape[0]
        for i, fb in enumerate(self._ladders.get(req.tag, ()), start=1):
            K_fb = self._predictors[fb].num_constraints
            if K_fb < K_req:         # cannot price this request's system
                continue
            rungs.append((i, lattice.bucket_for(
                m1=req.u.shape[0], m2=req.m2, K=K_fb, tag=fb,
                batch=self.max_batch)))
        return rungs

    # -- adaptive lattice: telemetry, shadow warm, epoch-fenced swap --------

    def attach_lattice_lane(self, lane) -> None:
        """Attach a LatticeLane: the engine feeds its trough detector
        arrival times at enqueue and lag samples through
        observe_submission_lag."""
        self._lattice_lane = lane

    def lattice(self) -> Lattice:
        """The live bucket lattice (what bucket_of routes on)."""
        return self._lattice

    def lattice_epoch(self) -> int:
        """The live lattice generation (0 = the boot lattice)."""
        return self._lattice_epoch

    def _lattice_buckets(self, lattice: Lattice,
                         sample=None) -> set[Bucket]:
        """Every bucket the observed traffic (the shape histogram, plus
        an optional sample of RankRequests or Buckets) reaches on
        `lattice`, ladder rungs included: what a shadow warm must warm
        so the flipped lattice allocates nothing on the dispatch path
        for traffic shaped like what was seen."""
        buckets: set[Bucket] = set()
        for tag, _, m1, m2, K, _, _ in self.shape_histogram.shapes():
            if tag != LAM_TAG and tag not in self._predictors:
                continue                      # tag gone since observed
            K_route = K
            if tag != LAM_TAG:
                K_pred = self._predictors[tag].num_constraints
                if K > K_pred:
                    continue                  # bucket_of would refuse it
                K_route = K_pred
            buckets.add(lattice.bucket_for(m1=m1, m2=m2, K=K_route,
                                           tag=tag, batch=self.max_batch))
            # ladder rungs, as _rung_buckets picks them from the
            # request's real constraint count
            if tag != LAM_TAG:
                for fb in self._ladders.get(tag, ()):
                    if self._predictors[fb].num_constraints < K:
                        continue
                    buckets.add(lattice.bucket_for(
                        m1=m1, m2=m2, K=self._predictors[fb].num_constraints,
                        tag=fb, batch=self.max_batch))
        for r in sample or ():
            if isinstance(r, Bucket):
                buckets.add(r)
                continue
            home = self.bucket_of(r, lattice)
            for _, bk in self._rung_buckets(r, home, lattice):
                buckets.add(bk)
        return buckets

    def shadow_warm_lattice(self, new_lattice: Lattice,
                            sample=None) -> dict:
        """Warm `new_lattice`'s corners off the dispatch path, on the
        calling thread (a LatticeLane's in production): for every bucket
        the observed traffic reaches there that is not warm yet, allocate
        its StagingRing on the engine's stream, run one phantom batch
        through it (which pads an affine predictor's W and c to the
        corner's K) and, with admission, a second, timed one, waiting on
        each batch's event only. Each corner is then installed under the
        swap lock. Routing still uses the live lattice until swap_lattice
        flips, so this only grows the warm set (metrics.shadow_compiles).

        Raises on any failure; nothing has flipped then, and the engine
        keeps serving the last-good lattice."""
        new_lattice.validate()
        t0 = self.clock()
        compiled = []
        buckets = self._lattice_buckets(new_lattice, sample)
        for bucket in sorted(buckets):
            if bucket in self._warmed:
                continue
            corner = self._build_executor(bucket)
            ring, _, fn = corner
            self._phantom(bucket, ring, fn)
            if self.admission is not None:
                t0b = self.clock()
                self._phantom(bucket, ring, fn)
                self.admission.observe_service(
                    bucket.name, (self.clock() - t0b) * 1e3)
            with self._swap_lock:
                if bucket not in self._exec:     # else the dispatch path's
                    self._install(bucket, *corner)
                self._warmed.add(bucket)
            self.metrics.on_shadow_compile()
            compiled.append(bucket.name)
        return {"buckets": sorted(b.name for b in buckets),
                "compiled": compiled,
                "warm_ms": (self.clock() - t0) * 1e3}

    def swap_lattice(self, new_lattice: Lattice, *,
                     epoch: int | None = None,
                     warm_ms: float = 0.0) -> int:
        """Epoch-fenced flip of the live lattice: check that every bucket
        the observed traffic reaches on `new_lattice` is warm (an unwarmed
        corner would allocate its ring on the dispatch path), then swap
        (lattice, epoch) under the lock every flush stamps its batch
        under. Old corners stay warm, so work routed before the flip
        drains without allocating. Epochs are monotone; `epoch` pins the
        generation number (a restarted replica resumes its fleet's)."""
        new_lattice.validate()
        missing = [b.name for b in sorted(self._lattice_buckets(new_lattice))
                   if b not in self._warmed]
        if missing:
            raise ValueError(
                f"swap_lattice: observed traffic reaches unwarmed buckets "
                f"{missing} — run shadow_warm_lattice first (a cold corner "
                f"would allocate its ring on the dispatch path)")
        with self._swap_lock:
            old_epoch = self._lattice_epoch
            new_epoch = old_epoch + 1 if epoch is None else int(epoch)
            if new_epoch <= old_epoch:
                raise ValueError(
                    f"swap_lattice: pinned epoch {new_epoch} <= live epoch "
                    f"{old_epoch} — epochs are monotone")
            self._lattice = new_lattice
            self._lattice_epoch = new_epoch
        self.metrics.on_lattice_swap(new_epoch, warm_ms=warm_ms)
        return new_epoch

    def rewarm_lattice(self, new_lattice: Lattice, sample=None) -> dict:
        """shadow_warm_lattice, then swap_lattice: what a LatticeLane
        calls in a trough. A failure raises before the flip, so the
        caller's rollback is a no-op."""
        report = self.shadow_warm_lattice(new_lattice, sample)
        report["epoch"] = self.swap_lattice(new_lattice,
                                            warm_ms=report["warm_ms"])
        return report

    # -- the card path ------------------------------------------------------

    def _on_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    def _build_executor(self, bucket: Bucket) -> tuple:
        """A corner's parts, built but not installed: its StagingRing,
        allocated on the engine's stream (its memory then belongs to the
        stream that reads it) with one slot more than the in-flight
        window (depth queued + 1 retiring), so assembly of the next batch
        never waits for a slot; its launch count; and its call."""
        with self._on_stream():
            ring = StagingRing(bucket, d_cov=self._d_cov.get(bucket.tag),
                               depth=self.pipeline_depth + 2,
                               device=self.device)
        pred = self._predictors.get(bucket.tag)
        if self.executor == "xla":
            launches = 0
        elif self.executor == "dist":
            launches = sum(dist_kernel_launches(
                pred, bucket.m2, mesh=self.mesh, device=self.device).values())
        else:
            launches = ops.kernel_launch_count(pred, bucket.m2,
                                               device=self.device)
        return ring, launches, functools.partial(self._launch, bucket)

    def _install(self, bucket: Bucket, ring: StagingRing, launches: int,
                 fn: Callable) -> None:
        # caller holds _swap_lock
        self._rings[bucket] = ring
        self._launches[bucket] = launches
        self._exec[bucket] = fn

    def _executor_for(self, bucket: Bucket) -> Callable:
        """The bucket's call, its corner built and installed on first use.
        A corner built here after warmup was built on the dispatch path:
        metrics.compiles_post_warmup counts it."""
        fn = self._exec.get(bucket)
        if fn is not None:
            return fn
        corner = self._build_executor(bucket)
        with self._swap_lock:
            fn = self._exec.get(bucket)
            if fn is not None:           # installed meanwhile: keep that
                return fn
            self._install(bucket, *corner)
        self.metrics.on_compile(in_warmup=self._in_warmup)
        return corner[2]

    def _affine_for(self, bucket: Bucket, template, state: dict,
                    epoch: int):
        """An affine generation's W and c padded to the bucket's K, built
        on the engine's stream once a (bucket, epoch). The previous
        generation's pair was allocated on this stream too, so the
        allocator reuses its memory only for work queued after the
        batches that read it."""
        with self._swap_lock:
            if self._affine_epoch.get(bucket) == epoch:
                return self._affine[bucket]
        affine = ref.affine_params(with_state(template, state),
                                   self._d_cov[bucket.tag], bucket.K)
        with self._swap_lock:
            self._affine[bucket] = affine
            self._affine_epoch[bucket] = epoch
        return affine

    def _pin(self, bucket: Bucket) -> tuple[dict | None, int]:
        """The generation a batch of `bucket` dispatches against,
        pinned; (None, 0) for lambda-given batches."""
        if bucket.tag == LAM_TAG:
            return None, 0
        return self._current_gen(bucket.tag)

    def _unpin(self, bucket: Bucket, epoch: int) -> None:
        if bucket.tag != LAM_TAG:
            self._release_gen(bucket.tag, epoch)

    def _dispatch(self, bucket: Bucket, ring: StagingRing, staged: dict,
                  fn: Callable | None = None):
        """One batch on the engine's stream through the bucket's call
        (`fn`, else the installed `_exec[bucket]`: `_launch`, or a fault
        injector's wrapper around it): inputs to the slot's device set,
        ONE dispatcher call, outputs into the slot's host set, then the
        slot's event. The epoch fence: the whole batch is dispatched
        against the one generation read (and pinned) here; the caller
        unpins it once the batch has passed the event. Returns (event,
        epoch); the event is None on the CPU. Nothing here waits for the
        card."""
        slot = ring.slot(staged)
        fn = self._exec[bucket] if fn is None else fn
        state, epoch = self._pin(bucket)
        try:
            fn(slot, state, epoch)
        except BaseException:  # noqa: BLE001 - re-raised: nothing ran
            self._unpin(bucket, epoch)
            raise
        return slot.event, epoch

    def _launch(self, bucket: Bucket, slot, state: dict | None,
                epoch: int) -> None:
        with self._on_stream():
            t = slot.inputs
            for k, host in slot.host.items():
                t[k].copy_(host, non_blocking=True)
            if self.executor == "dist":
                out = self._launch_dist(bucket, t, state, epoch)
            elif self.executor == "xla":
                out = self._launch_xla(bucket, t, state)
            elif bucket.tag == LAM_TAG:
                out = ops.predict_rank_audited(
                    t["lam"], None, t["u"], t["a"], t["b"], t["gamma"],
                    m2=bucket.m2, eps=self.eps, device=self.device)
            else:
                template = self._predictors[bucket.tag]
                affine = (self._affine_for(bucket, template, state, epoch)
                          if ops.route_of(template) == "affine" else None)
                out = ops.predict_rank_audited_stateful(
                    state, template, t["X"], t["u"], t["a"], t["b"],
                    t["gamma"], m2=bucket.m2, eps=self.eps, affine=affine,
                    device=self.device)
            for k, dst in slot.output_views.items():
                dst.copy_(getattr(out, k), non_blocking=True)
            if slot.event is not None:
                slot.event.record(self._stream)

    def _launch_xla(self, bucket: Bucket, t: dict,
                    state: dict | None) -> RankingOutput:
        """The `xla` executor's batch, JAX's two-stage body with no
        kernel launch: lambda-hat (given, or the predictor's own
        `predict` in f32, zero-padded to the bucket's K), then
        rank_given_lambda."""
        if bucket.tag == LAM_TAG:
            lam = t["lam"]
        else:
            template = self._predictors[bucket.tag]
            lam = with_state(template, state).predict(t["X"]).to(
                torch.float32)
            ref.check_pred_width(lam.shape[-1], bucket.K)
            lam = torch.nn.functional.pad(lam, (0, bucket.K - lam.shape[-1]))
        return rank_given_lambda(t["u"], t["a"], t["b"], lam, t["gamma"],
                                 m2=bucket.m2, eps=self.eps)

    def _launch_dist(self, bucket: Bucket, t: dict, state: dict | None,
                     epoch: int) -> RankingOutput:
        """The `dist` executor's batch: ops.lambda_hat (the bucket's
        padded W and c for an affine tag), then rank_distributed over
        the mesh."""
        if bucket.tag == LAM_TAG:
            lam = t["lam"]
        else:
            template = self._predictors[bucket.tag]
            affine = (self._affine_for(bucket, template, state, epoch)
                      if ops.route_of(template) == "affine" else None)
            lam = ops.lambda_hat(t["X"], with_state(template, state),
                                 bucket.K, affine=affine, device=self.device)
        return rank_distributed(self.mesh, t["u"], t["a"], t["b"], lam,
                                t["gamma"], m2=bucket.m2, eps=self.eps)

    def _wait(self, event) -> None:
        """Block until a batch's event has completed (the GIL is
        released while waiting)."""
        if event is not None:
            with torch.cuda.device(self.device):
                event.synchronize()

    def _phantom(self, bucket: Bucket, ring: StagingRing,
                 fn: Callable) -> None:
        """One all-padding batch of `bucket` there and back, waiting on
        its event only."""
        staged = fill_staging(ring.acquire(), [], bucket)
        try:
            event, epoch = self._dispatch(bucket, ring, staged, fn)
            try:
                self._wait(event)
            finally:
                self._unpin(bucket, epoch)
        finally:
            ring.release(staged)

    def warmup(self, sample) -> dict:
        """Build the kernels and warm every bucket that `sample`
        (RankRequests or Buckets) reaches on the live lattice, every rung
        of each request's degradation ladder included: its ring, then one
        phantom batch. With admission attached, a second, timed phantom
        batch per bucket seeds the controller's service-time EWMAs. Waits
        on the batches' events and the engine's own stream, never on the
        whole device."""
        buckets = set()
        for r in sample:
            if isinstance(r, Bucket):
                buckets.add(r)
                continue
            buckets.update(bk for _, bk in self._rung_buckets(
                r, self.bucket_of(r)))
        if self._stream is not None:
            build.build_all()
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._in_warmup = True
        try:
            for bucket in sorted(buckets):
                fn = self._executor_for(bucket)
                ring = self._rings[bucket]
                self._phantom(bucket, ring, fn)
                if self.admission is not None:
                    t0 = self.clock()
                    self._phantom(bucket, ring, fn)
                    self.admission.observe_service(
                        bucket.name, (self.clock() - t0) * 1e3)
                with self._swap_lock:
                    self._warmed.add(bucket)
        finally:
            self._in_warmup = False
        if self._stream is not None:
            self._stream.synchronize()
        self.metrics.warmed = True
        return {"buckets": [b.name for b in sorted(buckets)],
                "compiles": self.metrics.compiles}

    # -- submission side ----------------------------------------------------

    def submit(self, req: RankRequest, now: float | None = None) -> list:
        """Enqueue; returns the results retired so far (at depth >= 1 a
        capacity-flushed batch retires later: collect it from a later
        submit/poll or from `drain`)."""
        self._enqueue(req, now)
        return self._collect()

    def submit_future(self, req: RankRequest,
                      now: float | None = None) -> RankFuture:
        """Enqueue and return the request's RankFuture: it resolves when
        its batch retires, or at once with a typed `Shed` when admission
        sheds it. Results also flow through submit/poll/drain."""
        return self._enqueue(req, now)

    def observe_submission_lag(self, lag_ms: float) -> None:
        """Feed the open-loop load generator's queueing lag to the admission
        controller and the lattice lane's trough detector as their
        saturation signal (no-op without either)."""
        if self.admission is not None:
            self.admission.observe_lag(lag_ms)
        if self._lattice_lane is not None:
            self._lattice_lane.observe_lag(lag_ms)

    def _deadline_of(self, req: RankRequest, now: float) -> float:
        if req.deadline is not None:
            return float(req.deadline)
        if req.budget_s is not None:
            budget = req.budget_s
        else:
            budget = self.surface_budgets.get(req.surface,
                                              self.default_budget_s)
        return now + float(budget)

    def _enqueue(self, req: RankRequest, now: float | None) -> RankFuture:
        if self._closed:
            raise RuntimeError("engine is closed")
        now = self.clock() if now is None else now
        bucket = self.bucket_of(req)
        self.metrics.on_submit(bucket, known=bucket in self._warmed)
        # the request's real geometry (before padding and K widening):
        # what the lattice optimizer learns corners from
        self.shape_histogram.observe(
            tag=bucket.tag, m1=req.u.shape[0], m2=req.m2, K=req.a.shape[0],
            d_cov=None if req.X is None else req.X.shape[-1],
            surface=req.surface)
        if self._lattice_lane is not None:
            self._lattice_lane.observe_arrival(now)
        fut = RankFuture(req.rid, bucket.name)
        deadline = self._deadline_of(req, now)
        rung = 0
        if self.admission is not None:
            rungs = self._rung_buckets(req, bucket)
            inflight = (self._pipeline.inflight()
                        if self._pipeline is not None else 0)
            preds = [(r, self.admission.predict_ms(
                          bk.name,
                          queue_len=len(self._queues.get(bk, ())),
                          batch_cap=bk.batch, inflight=inflight,
                          max_wait_ms=self.max_wait_ms))
                     for r, bk in rungs]
            decision = self.admission.decide(
                budget_ms=(deadline - now) * 1e3, rung_predictions=preds)
            if not decision.admitted:
                self.metrics.on_shed(bucket, surface=req.surface)
                shed = Shed(rid=req.rid, bucket=bucket.name,
                            predicted_ms=decision.predicted_ms,
                            budget_ms=decision.budget_ms)
                fut._resolve(shed)
                self._uncollected_sheds.append(shed)
                return fut
            if decision.rung > 0:
                rung = decision.rung
                bucket = dict(rungs)[rung]
                self.metrics.on_degrade(rung, surface=req.surface)
        q = self._queues.setdefault(bucket, [])
        q.append(_QueueEntry(req=req, t_enq=now, fut=fut,
                             deadline=deadline, rung=rung))
        if len(q) >= bucket.batch:
            self._flush_bucket(bucket, trigger="capacity")
        return fut

    def poll(self, now: float | None = None) -> list:
        """Flush every queue whose oldest request has waited max_wait_ms;
        returns the results retired so far."""
        now = self.clock() if now is None else now
        for bucket, q in list(self._queues.items()):
            if q and (now - q[0].t_enq) * 1e3 >= self.max_wait_ms:
                self._flush_bucket(bucket, trigger="deadline")
        return self._collect()

    def drain(self) -> list:
        """Flush every queue and wait for every in-flight batch to
        retire; returns every result (and Shed) not yet collected."""
        for bucket, q in list(self._queues.items()):
            if q:
                self._flush_bucket(bucket, trigger="drain")
        if self._pipeline is not None:
            results = self._take_sheds()
            for pending in self._pipeline.flush():
                results += pending.results()
            return results
        return self._collect()

    def handoff_queued(self, error: BaseException | None = None) -> list:
        """Evict every queued (not yet flushed) request: each one's
        future fails with `error` and the requests are returned for
        resubmission elsewhere. In-flight batches retire normally."""
        if error is None:
            error = RuntimeError("request evicted for handoff")
        evicted = []
        for bucket in list(self._queues):
            entries, self._queues[bucket] = self._queues[bucket], []
            for e in entries:
                evicted.append(e.req)
                e.fut._fail(error)
        return evicted

    def close(self) -> None:
        """Flush what is queued and retire what is in flight (so every
        future resolves), stop the pipeline worker and refuse further
        submissions. Idempotent. When the final drain raises (a crashed
        replica's flush), the worker is stopped all the same, every
        request still queued fails with that error, and the error
        re-raises."""
        if self._closed:
            return
        try:
            self.drain()
        except BaseException as e:
            self.handoff_queued(e)
            raise
        finally:
            if self._pipeline is not None:
                self._pipeline.close()
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _take_sheds(self) -> list:
        sheds, self._uncollected_sheds = self._uncollected_sheds, []
        return sheds

    def _collect(self) -> list:
        """Results of every batch retired since the last call, and the
        Sheds since then, built on the caller's thread."""
        if self._pipeline is not None:
            batches = self._pipeline.collect()
        else:
            batches, self._retired_sync = self._retired_sync, []
        results = self._take_sheds()
        for pending in batches:
            results += pending.results()
        return results

    def _flush_bucket(self, bucket: Bucket, *, trigger: str) -> None:
        entries, self._queues[bucket] = self._queues[bucket], []
        reqs = [e.req for e in entries]
        self._executor_for(bucket)
        ring = self._rings[bucket]
        t0 = self.clock()
        staged = fill_staging(ring.acquire(), reqs, bucket)
        # the lattice fence: the epoch is read under the swap lock, so a
        # concurrent swap_lattice lands before or after this batch
        with self._swap_lock:
            lattice_epoch = self._lattice_epoch
        t_launch = self.clock()
        try:
            event, epoch = self._dispatch(bucket, ring, staged)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            # every future still resolves exactly once, and the slot
            # goes back: a leaked slot would deadlock acquire() later
            for entry in entries:
                entry.fut._fail(e)
            ring.release(staged)
            raise
        t1 = self.clock()
        self.metrics.on_executable_call(self._launches[bucket])
        pending = PendingBatch(
            bucket=bucket, entries=entries,
            futures=[e.fut for e in entries], out=None, staged=staged,
            ring=ring, t_launch=t_launch, trigger=trigger,
            materialize=self._materialize_batch, build=self._build_result,
            assembly_ms=(t_launch - t0) * 1e3,
            dispatch_ms=(t1 - t_launch) * 1e3,
            fill=fill_stats(reqs, bucket), epoch=epoch, event=event,
            lattice_epoch=lattice_epoch)
        if self._pipeline is not None:
            self._pipeline.submit(pending)      # may block: backpressure
        else:
            pending.finish()
            self._retired_sync.append(pending)
        self.metrics.on_dispatch(
            trigger, pending.fill, assembly_ms=pending.assembly_ms,
            dispatch_ms=pending.dispatch_ms,
            depth=pending.depth_at_dispatch, t_now=t_launch)

    # -- completion side ----------------------------------------------------

    def _materialize_batch(self, pending: PendingBatch) -> None:
        """Wait for one batch's event, take its outputs out of the slot,
        stamp completion, feed admission, recycle the slot and unpin the
        batch's generation. Runs on the pipeline worker (depth >= 1) or
        inline (depth 0); it touches the card only through the event."""
        self._wait(pending.event)
        slot = pending.ring.slot(pending.staged)
        # copies: the slot's outputs are rewritten by its next batch
        pending.out = RankingOutput(**{k: np.array(v)
                                       for k, v in slot.outputs.items()})
        pending.t_done = self.clock()
        exec_ms = (pending.t_done - pending.t_launch) * 1e3
        self.metrics.on_retire(exec_ms, pending.t_done)
        if self.admission is not None:
            self.admission.observe_service(pending.bucket.name, exec_ms)
        pending.ring.release(pending.staged)
        pending.staged = None
        # only now, past the event, may the generation be let go
        self._unpin(pending.bucket, pending.epoch)

    def _build_result(self, pending: PendingBatch, i: int) -> RankResult:
        """Unpad row `i` into its RankResult, once per row, on whichever
        consumer thread asks first."""
        entry = pending.entries[i]
        req, t_enq = entry.req, entry.t_enq
        perm, utility, exposure, compliant = unpad_result(pending.out, i, req)
        deadline_hit = pending.t_done <= entry.deadline
        shortfall = float(np.clip(req.b - exposure, 0.0, None).sum())
        latency_ms = (pending.t_done - t_enq) * 1e3
        wait_ms = (pending.t_launch - t_enq) * 1e3
        self.metrics.on_result(latency_ms, wait_ms, compliant,
                               deadline_hit=deadline_hit, rung=entry.rung,
                               shortfall=shortfall, surface=req.surface)
        if self.admission is not None:
            self.admission.observe_result(
                latency_ms, (entry.deadline - t_enq) * 1e3)
        if self._refresh is not None and pending.bucket.tag != LAM_TAG:
            # the refresh lane's dual-subgradient row, at the served
            # tag's predictor width: covariates, the lambda-hat the batch
            # served, exposure and b zero-padded past the request's K
            K_pred = self._predictors[pending.bucket.tag].num_constraints
            K_req = req.b.shape[0]
            expo_row = np.zeros(K_pred, np.float32)
            expo_row[:K_req] = exposure[:K_pred][:K_req]
            b_row = np.zeros(K_pred, np.float32)
            b_row[:K_req] = req.b[:K_pred][:K_req]
            self._refresh.observe(
                pending.bucket.tag, X=req.X,
                lam=np.asarray(pending.out.lam[i, :K_pred], np.float32),
                exposure=expo_row, b=b_row)
        return RankResult(rid=req.rid, perm=perm, utility=utility,
                          exposure=exposure, compliant=compliant,
                          bucket=pending.bucket.name, latency_ms=latency_ms,
                          wait_ms=wait_ms, deadline_hit=deadline_hit,
                          rung=entry.rung, epoch=pending.epoch,
                          lattice_epoch=pending.lattice_epoch)

    def serve_stream(self, requests, *, warmup: bool = True) -> list:
        """Submit each request in arrival order, honouring max_wait_ms
        between arrivals, and drain at the end. Results (and Sheds) come
        in retirement order."""
        requests = list(requests)
        if warmup and not self.metrics.warmed:
            self.warmup(requests)
        results = []
        for req in requests:
            results += self.submit(req)
            results += self.poll()
        results += self.drain()
        return results
