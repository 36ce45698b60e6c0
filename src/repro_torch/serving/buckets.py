"""Shape-bucket geometry, the per-geometry autotune table and host-side
batch assembly (counterpart of repro.serving.buckets).

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

import json
import os
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


# ---------------------------------------------------------------------------
# Per-geometry autotune table
# ---------------------------------------------------------------------------
# The JAX package's key format, lookup chain and JSON layout, so that one
# table file loads in either package. An entry maps knob names to values;
# the JAX engine applies its Pallas tiles (AUTOTUNE_KEYS) when it builds
# a bucket. The CUDA kernels take none of those tiles, and their launch
# parameters (the rank kernels' cluster split, the KNN sweep's db chunk)
# are picked by their wrappers from the launch's own shape, so nothing
# in the port applies an entry: the table is here for the file and the
# lookup.

DEFAULT_AUTOTUNE_PATH = "experiments/bench/autotune_table.json"

# the JAX engine's tile knobs
AUTOTUNE_KEYS = ("tile_b", "tile_m", "tile_n", "quant")


def geometry_key(bucket: Bucket, *, d_cov: int | None = None) -> str:
    """The autotune-table key for a bucket: its padded kernel geometry,
    without the tag, a pure function of the actual (m1, m2, K, B[, d])
    numbers and never of the bucket's place in a lattice, so tuned knobs
    survive a lattice swap."""
    key = f"m1={bucket.m1}/m2={bucket.m2}/K={bucket.K}/B={bucket.batch}"
    if d_cov is not None:
        key += f"/d={int(d_cov)}"
    return key


def resolve_autotune(table: dict, bucket: Bucket, *,
                     d_cov: int | None = None) -> dict:
    """`bucket`'s entry of an autotune table, by JAX's lookup chain:

      1. the exact geometry key with the covariate width (".../d=16");
      2. the key without it;
      3. the nearest tuned geometry that covers this bucket (same batch,
         m1, m2 and K all >=; the least m1*m2 + K*m1), tile_b clamped
         to B and tile_m to m1.

    Returns {} when nothing applies (the engine serves on defaults)."""
    if not table:
        return {}
    if d_cov is not None:
        hit = table.get(geometry_key(bucket, d_cov=d_cov))
        if hit:
            return dict(hit)
    hit = table.get(geometry_key(bucket))
    if hit:
        return dict(hit)
    best, best_cost = None, None
    for key, entry in table.items():
        dims = {}
        for part in key.split("/"):
            name, _, val = part.partition("=")
            if val:
                try:
                    dims[name] = int(val)
                except ValueError:
                    pass
        if not {"m1", "m2", "K", "B"} <= dims.keys():
            continue
        if dims["B"] != bucket.batch:
            continue
        if (dims["m1"] < bucket.m1 or dims["m2"] < bucket.m2
                or dims["K"] < bucket.K):
            continue
        cost = dims["m1"] * dims["m2"] + dims["K"] * dims["m1"]
        if best_cost is None or cost < best_cost:
            best, best_cost = entry, cost
    if best is None:
        return {}
    out = dict(best)
    if "tile_b" in out:
        out["tile_b"] = min(int(out["tile_b"]), bucket.batch)
    if "tile_m" in out:
        out["tile_m"] = min(int(out["tile_m"]), bucket.m1)
    return out


def save_autotune_table(table: dict, path: str = DEFAULT_AUTOTUNE_PATH
                        ) -> str:
    """Write {geometry_key: {knob: value, ...}} as JSON in the JAX
    package's layout ({"version": 1, "table": ...}); round-trips through
    load_autotune_table."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump({"version": 1, "table": table}, f, indent=1, sort_keys=True)
    return path


def load_autotune_table(path: str = DEFAULT_AUTOTUNE_PATH) -> dict:
    """A saved autotune table; {} when the file is absent."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        payload = json.load(f)
    return payload.get("table", {})


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


class Staging(dict):
    """One batch's host staging arrays (name -> array), with `written`:
    the (m1, K, m2) extent of each row that the last `fill_staging`
    packed, or None while the arrays may hold anything. Everything
    outside those extents holds the padding identity."""

    __slots__ = ("written",)

    def __init__(self, arrays):
        super().__init__(arrays)
        self.written = None


def alloc_staging(bucket: Bucket, *, d_cov: int | None = None,
                  device=None) -> Staging:
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
    return Staging({k: host_empty(s, torch.float32, dev)
                    for k, s in shapes.items()})


def fill_staging(staged: dict, requests, bucket: Bucket) -> dict:
    """Reset `staged` to the padding identity and pack `requests` in,
    in place; every entry is overwritten, phantom rows included. A
    `Staging` that an earlier fill packed has only that fill's row
    extents reset, so a batch of n requests costs what n rows cost,
    not the whole padded bucket; anything else is reset whole."""
    n = len(requests)
    if n > bucket.batch:
        raise ValueError(f"{n} requests > bucket capacity {bucket.batch}")
    y = "lam" if "lam" in staged else "X"
    written = getattr(staged, "written", None)
    if written is None:
        staged["u"].fill(NEG_FILL)
        staged["a"].fill(0.0)
        staged["b"].fill(0.0)
        staged["gamma"].fill(0.0)
        staged[y].fill(0.0)
    else:
        staged.written = None       # until this fill has packed every row
        for i, (m1, K, m2) in enumerate(written):
            staged["u"][i, :m1] = NEG_FILL
            staged["a"][i, :K, :m1] = 0.0
            staged["b"][i, :K] = 0.0
            staged["gamma"][i, :m2] = 0.0
            staged[y][i] = 0.0
    extents = []
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
        extents.append((m1, K, m2))
    if isinstance(staged, Staging):
        staged.written = extents
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
