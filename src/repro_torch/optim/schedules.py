"""Learning-rate schedules as step -> lr functions (counterpart of
repro.optim.schedules): the step may be an int or a tensor, the lr comes
back as an f32 tensor, computed in f32 as the JAX ones are."""

from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1.0 - final_frac) * cos)

    return f


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    def f(step):
        s = _f32(step)
        warm = s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1.0 - final_frac) * 0.5 * (
            1.0 + torch.cos(math.pi * t))
        return lr * torch.where(s < warmup_steps, warm, cos)

    return f
