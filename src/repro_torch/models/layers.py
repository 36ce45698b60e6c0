"""Building blocks shared by the port's models (counterpart of the parts
of repro.models.layers that the paper's recommender and the recsys
backbones use): the dense initialiser and RMSNorm."""

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


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x / rms(x) * (1 + w) over the last axis, in f32, cast back to x's
    type. The JAX body's rsqrt comes from XLA, whose CPU rsqrt need not
    round as torch.rsqrt does: the two agree to a few ulp, not bitwise."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.to(torch.float32))).to(x.dtype)

