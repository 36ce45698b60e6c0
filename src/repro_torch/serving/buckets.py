"""Shape-bucket geometry and host-side batch assembly (counterpart of
repro.serving.buckets, without the autotune table).

Requests carry their own (m1, m2, K); the engine pads each to a bucket
so a bounded set of shapes reaches the kernels. Padding does not change
the answer:

  candidates m1 -> m1p : u filled with NEG_FILL (finite, so 0-discount
      slots contribute exactly 0.0), attribute columns with 0;
  slots m2 -> m2p      : gamma zero-extended, so phantom slots add 0;
  constraints K -> Kp  : zero rows in a, zero thresholds, zero lambda;
  batch n -> capacity  : whole phantom rows, sliced off before results
      leave the engine.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.constraints import dcg_discount
from repro_torch.device import resolve_device

# Finite "minus infinity" for padded candidate utilities: keeps padded
# candidates out of every top-m2 while 0.0 * NEG_FILL == 0.0 exactly.
NEG_FILL = -1.0e30

MIN_M1 = 128       # floor of the candidate axis
MIN_M2 = 8         # floor of the slot axis
K_TIERS = (4, 8, 16, 32)


def ceil_pow2(n: int, floor: int = 1) -> int:
    """Smallest power of two >= max(n, floor)."""
    n = max(int(n), int(floor))
    return 1 << (n - 1).bit_length()


def k_tier(K: int, tiers=K_TIERS) -> int:
    """Smallest tier >= K; an oversize K falls back to its pow2 ceiling."""
    for t in tiers:
        if K <= t:
            return t
    return ceil_pow2(K)


@dataclass(frozen=True, order=True)
class Bucket:
    """One padded-shape equivalence class."""

    tag: str      # predictor tag ('_lam' = the request carries lambda)
    m1: int       # padded candidate count
    m2: int       # padded slot count
    K: int        # padded constraint count
    batch: int    # micro-batch capacity

    @property
    def name(self) -> str:
        return f"{self.tag}/m1={self.m1}/m2={self.m2}/K={self.K}/B={self.batch}"


def bucket_for(*, m1: int, m2: int, K: int, tag: str, batch: int) -> Bucket:
    """Map a request geometry to its bucket; m2p is clamped to m1p."""
    if m2 > m1:
        raise ValueError(f"request needs m2 <= m1, got m2={m2} > m1={m1}")
    m1p = ceil_pow2(m1, MIN_M1)
    m2p = min(ceil_pow2(m2, MIN_M2), m1p)
    return Bucket(tag=tag, m1=m1p, m2=m2p, K=k_tier(K), batch=int(batch))


def host_empty(shape, dtype: torch.dtype, device: torch.device) -> np.ndarray:
    """An uninitialised host array for batches bound to `device`: for a
    CUDA device the numpy view of a page-locked torch tensor (the view
    keeps the tensor alive), which a non-blocking copy moves without
    blocking the host; torch raises if the memory cannot be pinned. A
    plain numpy array for the CPU."""
    if device.type == "cuda":
        return torch.empty(shape, dtype=dtype, pin_memory=True).numpy()
    return torch.empty(shape, dtype=dtype).numpy()


def alloc_staging(bucket: Bucket, *, d_cov: int | None = None,
                  device=None) -> dict:
    """Host staging arrays for one batch of `bucket`: u (B, m1),
    a (B, K, m1), b (B, K), gamma (B, m2) and either lam (B, K)
    (d_cov None) or X (B, d_cov). Pinned when `device` (None = the
    card) is CUDA (`host_empty`)."""
    dev = resolve_device(device)
    B, m1p, m2p, Kp = bucket.batch, bucket.m1, bucket.m2, bucket.K
    shapes = {"u": (B, m1p), "a": (B, Kp, m1p), "b": (B, Kp),
              "gamma": (B, m2p)}
    if d_cov is None:
        shapes["lam"] = (B, Kp)
    else:
        shapes["X"] = (B, d_cov)
    return {k: host_empty(s, torch.float32, dev) for k, s in shapes.items()}


def fill_staging(staged: dict, requests, bucket: Bucket) -> dict:
    """Reset `staged` to the padding identity and pack `requests` in,
    in place; every entry is overwritten, phantom rows included."""
    n = len(requests)
    if n > bucket.batch:
        raise ValueError(f"{n} requests > bucket capacity {bucket.batch}")
    staged["u"].fill(NEG_FILL)
    staged["a"].fill(0.0)
    staged["b"].fill(0.0)
    staged["gamma"].fill(0.0)
    staged["lam" if "lam" in staged else "X"].fill(0.0)
    for i, r in enumerate(requests):
        m1, K, m2 = r.u.shape[0], r.a.shape[0], r.m2
        staged["u"][i, :m1] = r.u
        staged["a"][i, :K, :m1] = r.a
        staged["b"][i, :K] = r.b
        g = r.gamma if r.gamma is not None else dcg_discount(m2).numpy()
        staged["gamma"][i, :m2] = np.asarray(g, np.float32)
        if r.lam is not None:
            staged["lam"][i, :K] = r.lam
        if "X" in staged:
            staged["X"][i] = r.X
    return staged


def assemble_batch(requests, bucket: Bucket, *, d_cov: int | None = None,
                   device=None):
    """Pack up to `bucket.batch` requests into fresh padded arrays."""
    return fill_staging(alloc_staging(bucket, d_cov=d_cov, device=device),
                        requests, bucket)


def unpad_result(out, i: int, request):
    """Row `i` of a batched RankingOutput of host arrays, cut back to
    the request's geometry: (perm (m2,), utility, exposure (K,),
    compliant). perm and exposure are copies, so a result never aliases
    the batch's output buffers, which the engine recycles."""
    m2, K = request.m2, request.a.shape[0]
    perm = np.array(out.perm[i, :m2])
    utility = float(out.utility[i])
    exposure = np.array(out.exposure[i, :K])
    compliant = bool(out.compliant[i])
    return perm, utility, exposure, compliant


def fill_stats(requests, bucket: Bucket) -> dict:
    """Padding overhead of a micro-batch: real vs padded (batch x m1)
    cells and real vs padded sweep work (rank m1*m2 + audit K*m1 per
    request)."""
    real = real_flops = 0
    for r in requests:
        m1, K, m2 = int(r.u.shape[0]), int(r.a.shape[0]), int(r.m2)
        real += m1
        real_flops += m1 * m2 + K * m1
    padded = bucket.batch * bucket.m1
    padded_flops = bucket.batch * (bucket.m1 * bucket.m2
                                   + bucket.K * bucket.m1)
    return {"real_cells": real, "padded_cells": padded,
            "real_flops": real_flops, "padded_flops": padded_flops}
