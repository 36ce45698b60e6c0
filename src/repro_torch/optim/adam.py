"""Adam over dicts of tensors (counterpart of repro.optim.adam).

The update repeats the JAX one's order of rounded operations: m*b1 +
(1-b1)*g, v*b2 + (1-b2)*g*g, then (m/bc1) / (sqrt(v/bc2) + eps), the
bias corrections bc = 1 - b**t in f32. torch.optim.Adam divides
sqrt(v)/sqrt(bc2) + eps and folds 1/bc1 into the step, which rounds
differently; the recommender's slates and the MLP's lambda-hat inherit
that drift, so the port keeps this transcription instead. Moments may be
kept in a narrower type (moment_dtype); the update runs in f32 and the
parameters keep their own type.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class AdamState:
    step: torch.Tensor   # () int32, on the parameters' device
    mu: dict             # name -> first moment
    nu: dict             # name -> second moment


def adam_init(params: dict, moment_dtype=torch.float32,
              device=None) -> AdamState:
    """Zero moments for each tensor of `params` on `device` (None = the
    card), where the parameters must lie."""
    dev = resolve_device(device)
    for name, p in params.items():
        if p.device != dev:
            raise ValueError(f"parameter {name!r} lies on {p.device}, not "
                             f"{dev}")
    zeros = {k: torch.zeros(p.shape, dtype=moment_dtype, device=dev)
             for k, p in params.items()}
    return AdamState(step=torch.zeros((), dtype=torch.int32, device=dev),
                     mu=zeros,
                     nu={k: z.clone() for k, z in zeros.items()})


@torch.no_grad()
def adam_update(grads: dict, state: AdamState, params: dict, *, lr,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0) -> tuple[dict, AdamState]:
    """One Adam step: returns (new params, new state); the inputs are
    left as they are. Runs where the tensors lie."""
    step = state.step + 1
    t = step.to(torch.float32)
    # b ** t from the step on its device: a tensor made from b here
    # would cost a host-to-device copy every step
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].to(torch.float32)
        m, v = state.mu[k], state.nu[k]
        m32 = m.to(torch.float32) * b1 + (1.0 - b1) * g32
        v32 = v.to(torch.float32) * b2 + (1.0 - b2) * g32 * g32
        u = (m32 / bc1) / (torch.sqrt(v32 / bc2) + eps)
        if weight_decay:
            u = u + weight_decay * p.to(torch.float32)
        new_p[k] = (p.to(torch.float32) - lr * u).to(p.dtype)
        new_m[k] = m32.to(m.dtype)
        new_v[k] = v32.to(v.dtype)
    return new_p, AdamState(step=step, mu=new_m, nu=new_v)
