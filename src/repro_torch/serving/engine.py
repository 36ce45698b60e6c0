"""Synchronous streaming serving engine of the port (counterpart of
repro.serving.ServingEngine at pipeline_depth=0).

Each RankRequest is routed to a shape Bucket and queued; a queue flushes
at the bucket's capacity, when its oldest request has waited
max_wait_ms (`poll`), or on `drain`. A flush packs the batch into the
bucket's host staging arrays, copies them to the device, and makes ONE
dispatcher call into kernels.ops, whose route the bucket's tag fixes:
the rank+audit kernel for lambda-carrying requests, the KNN kernel for
a registered KNN predictor (its quantized twin when the predictor
carries an int8 or bf16 pack), the affine kernel (`linear_rank_audited`)
for a mean or linear predictor, whose W and c the engine pads to the
bucket's K once, when the bucket's staging is allocated. The batch's
outputs come home in one copy per output and the futures resolve
inline.

Not in this slice: the async pipeline worker, admission control, the
adaptive lattice, lambda refresh and predictor swaps, the replica fleet
and the autotune table (ROADMAP Queue 1 items 7-8).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch.core.predictors import LinearLambdaPredictor
from repro_torch.core.ranking import RankingOutput
from repro_torch.device import resolve_device
from repro_torch.kernels import build, ops, ref
from repro_torch.serving.buckets import (
    Bucket,
    alloc_staging,
    bucket_for,
    fill_staging,
    fill_stats,
    unpad_result,
)
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.pipeline import PendingBatch, RankFuture

LAM_TAG = "_lam"   # requests that carry shadow prices directly


@dataclass
class RankRequest:
    """One user's ranking problem; arrays are host (numpy) payloads."""

    rid: int
    u: np.ndarray                     # (m1,) candidate utilities
    a: np.ndarray                     # (K, m1) constraint attributes
    b: np.ndarray                     # (K,) exposure thresholds
    m2: int                           # slots to fill (m2 <= m1)
    lam: np.ndarray | None = None     # (K,) shadow prices, if given
    X: np.ndarray | None = None       # (d,) covariates for the predictor
    tag: str = LAM_TAG                # predictor tag
    gamma: np.ndarray | None = None   # (m2,) slot discounts; default DCG

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


class ServingEngine:
    """Shape-bucketed micro-batching over the online stage.

    device: None means the card (RuntimeError without CUDA); the tests
    pass "cpu" to run the plain PyTorch path. clock: the engine's time
    source, injectable so tests can freeze it.
    """

    def __init__(self, *, max_batch: int = 32, max_wait_ms: float = 2.0,
                 eps: float = 1e-4,
                 clock: Callable[[], float] = time.perf_counter,
                 device=None):
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.max_wait_ms = float(max_wait_ms)
        self.eps = float(eps)
        self.clock = clock
        self.metrics = EngineMetrics()
        self._predictors: dict = {}
        self._d_cov: dict[str, int] = {}
        self._affine: dict[Bucket, tuple] = {}
        self._queues: dict[Bucket, list] = {}
        self._staging: dict[Bucket, dict] = {}
        self._launches: dict[Bucket, int] = {}
        self._warmed: set[Bucket] = set()
        self._retired: list[PendingBatch] = []
        self._closed = False

    # -- predictors ---------------------------------------------------------

    def register_predictor(self, tag: str, predictor, *, d_cov: int) -> None:
        """Attach a fitted KNN (f32 or quantized), linear or mean
        predictor under `tag`. Its tensors, a KNN pack included, move to
        the engine's device once, here, and stay there; it prices
        `predictor.num_constraints` constraints."""
        if tag == LAM_TAG:
            raise ValueError(f"{LAM_TAG!r} is reserved for raw-lam requests")
        if predictor is None:
            raise ValueError("register_predictor needs a fitted predictor")
        if ops.route_of(predictor) == "knn":   # raises for an unported one
            d_pred = predictor.X_db.shape[1]
        elif isinstance(predictor, LinearLambdaPredictor):
            d_pred = predictor.W.shape[1]
        else:
            d_pred = d_cov          # the mean family ignores covariates
        if d_pred != d_cov:
            raise ValueError(f"predictor takes d={d_pred} covariates, not "
                             f"d_cov={d_cov}")
        if predictor.device != self.device:
            predictor = predictor.to(self.device)
        self._predictors[tag] = predictor
        self._d_cov[tag] = int(d_cov)

    # -- bucketing ----------------------------------------------------------

    def bucket_of(self, req: RankRequest) -> Bucket:
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
        return bucket_for(m1=req.u.shape[0], m2=req.m2, K=K, tag=tag,
                          batch=self.max_batch)

    def _staging_for(self, bucket: Bucket) -> dict:
        """The bucket's host staging arrays, allocated on first use, with
        the bucket's launch count and, for an affine predictor, its W and
        c padded to the bucket's K (on the engine's device, where the
        predictor lies)."""
        staged = self._staging.get(bucket)
        if staged is None:
            staged = self._staging[bucket] = alloc_staging(
                bucket, d_cov=self._d_cov.get(bucket.tag))
            predictor = self._predictors.get(bucket.tag)
            self._launches[bucket] = ops.kernel_launch_count(
                predictor, bucket.m2, device=self.device)
            if ops.route_of(predictor) == "affine":
                self._affine[bucket] = ref.affine_params(
                    predictor, self._d_cov[bucket.tag], bucket.K)
        return staged

    def _call(self, bucket: Bucket, staged: dict) -> RankingOutput:
        """One dispatcher call on a packed batch (inputs copied to the
        device; the predictor's tensors are already there)."""
        dev = self.device
        # a copy even on the CPU: the staging arrays are refilled per batch
        t = {k: torch.tensor(v, device=dev) for k, v in staged.items()}
        if bucket.tag == LAM_TAG:
            X, predictor = t["lam"], None
        else:
            X, predictor = t["X"], self._predictors[bucket.tag]
        return ops.predict_rank_audited(
            X, predictor, t["u"], t["a"], t["b"], t["gamma"],
            m2=bucket.m2, eps=self.eps, affine=self._affine.get(bucket),
            device=dev)

    def warmup(self, sample) -> dict:
        """Build the kernels and run one phantom batch per bucket that
        `sample` (RankRequests or Buckets) reaches."""
        buckets = {r if isinstance(r, Bucket) else self.bucket_of(r)
                   for r in sample}
        if self.device.type == "cuda":
            build.build_all()
        for bucket in sorted(buckets):
            staged = fill_staging(self._staging_for(bucket), [], bucket)
            self._call(bucket, staged)
            self._warmed.add(bucket)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.metrics.warmed = True
        return {"buckets": [b.name for b in sorted(buckets)]}

    # -- submission ---------------------------------------------------------

    def submit(self, req: RankRequest, now: float | None = None) -> list:
        """Enqueue; returns the results retired so far (a capacity flush
        retires its batch before this returns)."""
        self._enqueue(req, now)
        return self._collect()

    def _enqueue(self, req: RankRequest, now: float | None) -> None:
        if self._closed:
            raise RuntimeError("engine is closed")
        now = self.clock() if now is None else now
        bucket = self.bucket_of(req)
        self.metrics.on_submit(bucket, known=bucket in self._warmed)
        fut = RankFuture(req.rid, bucket.name)
        q = self._queues.setdefault(bucket, [])
        q.append((req, now, fut))
        if len(q) >= bucket.batch:
            self._flush_bucket(bucket, trigger="capacity")

    def poll(self, now: float | None = None) -> list:
        """Flush every queue whose oldest request has waited max_wait_ms;
        returns the results retired so far."""
        now = self.clock() if now is None else now
        for bucket, q in list(self._queues.items()):
            if q and (now - q[0][1]) * 1e3 >= self.max_wait_ms:
                self._flush_bucket(bucket, trigger="deadline")
        return self._collect()

    def drain(self) -> list:
        """Flush every queue; returns every result not yet collected."""
        for bucket, q in list(self._queues.items()):
            if q:
                self._flush_bucket(bucket, trigger="drain")
        return self._collect()

    def close(self) -> None:
        """Flush what is queued (so every future resolves) and refuse
        further submissions."""
        self.drain()
        self._closed = True

    def _collect(self) -> list:
        batches, self._retired = self._retired, []
        results = []
        for pending in batches:
            results += pending.results()
        return results

    def _flush_bucket(self, bucket: Bucket, *, trigger: str) -> None:
        entries, self._queues[bucket] = self._queues[bucket], []
        reqs = [e[0] for e in entries]
        t0 = self.clock()
        staged = fill_staging(self._staging_for(bucket), reqs, bucket)
        t_launch = self.clock()
        assembly_ms = (t_launch - t0) * 1e3
        try:
            out = self._call(bucket, staged)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            # every future still resolves exactly once
            for _, _, fut in entries:
                fut._fail(e)
            raise
        self.metrics.on_executable_call(self._launches[bucket])
        pending = PendingBatch(
            bucket=bucket, entries=[e[:2] for e in entries],
            futures=[e[2] for e in entries], out=out, t_launch=t_launch,
            materialize=self._materialize_batch, build=self._build_result)
        pending.finish()
        self._retired.append(pending)
        self.metrics.on_dispatch(trigger, fill_stats(reqs, bucket),
                                 assembly_ms=assembly_ms)

    # -- completion ---------------------------------------------------------

    def _materialize_batch(self, pending: PendingBatch) -> None:
        """Copy one batch's outputs to the host (this waits for the
        device), one copy per output."""
        out = pending.out
        pending.out = RankingOutput(
            perm=out.perm.cpu().numpy(), utility=out.utility.cpu().numpy(),
            exposure=out.exposure.cpu().numpy(),
            compliant=out.compliant.cpu().numpy(), lam=out.lam.cpu().numpy())
        pending.t_done = self.clock()
        self.metrics.on_retire((pending.t_done - pending.t_launch) * 1e3)

    def _build_result(self, pending: PendingBatch, i: int) -> RankResult:
        req, t_enq = pending.entries[i]
        perm, utility, exposure, compliant = unpad_result(pending.out, i, req)
        latency_ms = (pending.t_done - t_enq) * 1e3
        wait_ms = (pending.t_launch - t_enq) * 1e3
        self.metrics.on_result(latency_ms, wait_ms, compliant)
        return RankResult(rid=req.rid, perm=perm, utility=utility,
                          exposure=exposure, compliant=compliant,
                          bucket=pending.bucket.name, latency_ms=latency_ms,
                          wait_ms=wait_ms)

    def serve_stream(self, requests, *, warmup: bool = True) -> list:
        """Submit each request in arrival order, honouring max_wait_ms
        between arrivals, and drain at the end. Results come in
        retirement order."""
        requests = list(requests)
        if warmup and not self.metrics.warmed:
            self.warmup(requests)
        results = []
        for req in requests:
            results += self.submit(req)
            results += self.poll()
        results += self.drain()
        return results
