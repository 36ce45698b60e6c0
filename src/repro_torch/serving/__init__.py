"""Streaming serving engine of the port: shape-bucketed micro-batching
with async double-buffered execution on a CUDA stream, deadlines and
admission, open-loop traffic, the online lambda-refresh lane that
hot-swaps predictor generations, the adaptive bucket lattice, the
fault-tolerant replica fleet, and the per-geometry autotune table's file
and lookup, kept so one table loads in either package (see engine.py,
pipeline.py, refresh.py, lattice.py, fleet.py and buckets.py)."""

from repro_torch.serving.admission import (
    SHED_RUNG,
    AdmissionController,
    AdmissionDecision,
)
from repro_torch.serving.buckets import (
    AUTOTUNE_KEYS,
    DEFAULT_AUTOTUNE_PATH,
    K_TIERS,
    MIN_M1,
    MIN_M2,
    NEG_FILL,
    Bucket,
    alloc_staging,
    assemble_batch,
    bucket_for,
    ceil_pow2,
    fill_staging,
    geometry_key,
    k_tier,
    load_autotune_table,
    resolve_autotune,
    save_autotune_table,
    unpad_result,
)
from repro_torch.serving.engine import (
    DEFAULT_BUDGET_S,
    LAM_TAG,
    RankRequest,
    RankResult,
    ServingEngine,
    Shed,
)
from repro_torch.serving.faults import (
    FaultInjector,
    FaultPlan,
    ReplicaCrash,
    ReplicaFaults,
)
from repro_torch.serving.fleet import FleetMetrics, FleetRouter, Replica
from repro_torch.serving.health import (
    DEAD,
    HEALTHY,
    RECOVERING,
    SUSPECT,
    HealthConfig,
    ReplicaHealth,
    backoff_s,
)
from repro_torch.serving.lattice import (
    DEFAULT_HISTOGRAM_PATH,
    Lattice,
    LatticeLane,
    ShapeHistogram,
    TroughDetector,
    optimize_lattice,
    padding_waste,
)
from repro_torch.serving.metrics import EngineMetrics
from repro_torch.serving.pipeline import (
    ExecutionPipeline,
    PendingBatch,
    RankFuture,
    StagingRing,
)
from repro_torch.serving.refresh import (
    RefreshLane,
    dual_refresh_targets,
    knn_ring_update,
    ridge_refresh,
    running_mean_update,
)
from repro_torch.serving.traffic import (
    DEFAULT_MIX,
    Scenario,
    make_drift_stream,
    make_request,
    make_stream,
    poisson_arrivals,
    serve_open_loop,
)

__all__ = [
    "Bucket", "K_TIERS", "MIN_M1", "MIN_M2", "NEG_FILL",
    "alloc_staging", "assemble_batch", "bucket_for", "ceil_pow2",
    "fill_staging", "k_tier", "resolve_autotune", "unpad_result",
    "DEFAULT_HISTOGRAM_PATH", "Lattice", "LatticeLane",
    "ShapeHistogram", "TroughDetector", "optimize_lattice",
    "padding_waste",
    "SHED_RUNG", "AdmissionController", "AdmissionDecision",
    "DEFAULT_BUDGET_S", "LAM_TAG", "RankRequest", "RankResult",
    "ServingEngine", "Shed",
    "FaultInjector", "FaultPlan", "ReplicaCrash", "ReplicaFaults",
    "FleetMetrics", "FleetRouter", "Replica",
    "DEAD", "HEALTHY", "RECOVERING", "SUSPECT",
    "HealthConfig", "ReplicaHealth", "backoff_s",
    "EngineMetrics",
    "ExecutionPipeline", "PendingBatch", "RankFuture", "StagingRing",
    "DEFAULT_MIX", "Scenario", "make_drift_stream", "make_request",
    "make_stream", "poisson_arrivals", "serve_open_loop",
    "RefreshLane", "dual_refresh_targets", "knn_ring_update",
    "ridge_refresh", "running_mean_update",
]
