"""Constants and argument checks shared by the CUDA kernel wrappers.

The TPU kernels' LANE/SUBLANE/TILE_B/TILE_M/DB_SLAB were vreg shapes;
nothing here copies them. The GPU geometry is chosen for Hopper: a
256-thread block per ranked row, a shared-memory bitonic sort of at
most SORT_MAX (score, index) pairs, and a KNN sweep that gives each
block KNN_QTILE queries and KNN_CHUNK database rows.
"""

from __future__ import annotations

import torch

# Finite "minus infinity" for padded candidate utilities: padded
# candidates never enter a top-m2, yet 0.0 * NEG_INF == 0.0 exactly.
NEG_INF = float(-1e30)

SORT_MAX = 2048      # (score, index) pairs one bitonic sort holds
MAX_KERNEL_K = 32    # constraint rows a kernel takes (the largest K tier)
KNN_QTILE = 32       # queries per block of the KNN distance sweep
KNN_CHUNK = 2048     # database rows per block of the KNN distance sweep
KNN_MAX_K = 16       # neighbours a KNN kernel keeps per query
KNN_MAX_D = 128      # covariate width the KNN sweep's shared tiles hold


def check_tensor(name: str, t: torch.Tensor, shape: tuple,
                 dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless `t` is a contiguous tensor of this shape, dtype and
    device: the kernels index raw pointers and trust all four."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
