"""Initialisers shared by the port's models (counterpart of the part of
repro.models.layers that the paper's recommender uses)."""

from __future__ import annotations

import math

import torch


def dense_init(gen: torch.Generator, shape, dtype=torch.float32,
               scale: float | None = None) -> torch.Tensor:
    """Normal weights scaled by `scale` (default 1/sqrt(fan-in)), drawn
    from `gen` on its device."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return (torch.randn(shape, generator=gen, device=gen.device)
            * s).to(dtype)
