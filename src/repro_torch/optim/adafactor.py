"""Factored second-moment Adam, Adafactor-style (counterpart of
repro.optim.adafactor), over dicts of tensors as the port's Adam is.

For a parameter of two or more axes the second moment is a rank-1
outer product of row and column statistics (its last two axes), in f32;
a 1-D or scalar parameter keeps a dense f32 nu and a (1,) placeholder
column. The first moment stays dense in `moment_dtype`. The update is
Adam's otherwise (both bias corrections), in the JAX body's order of
rounded operations.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class FactoredState:
    step: torch.Tensor   # () int32
    mu: dict             # name -> dense first moment
    nu_row: dict         # name -> (..., n) row stats, or the dense nu
    nu_col: dict         # name -> (..., m) column stats, or (1,)


def _is_factored(p: torch.Tensor) -> bool:
    return p.dim() >= 2


def adafactor_init(params: dict, moment_dtype=torch.bfloat16,
                   device=None) -> FactoredState:
    """Zero state for each tensor of `params` on `device` (None = the
    card), where the parameters must lie."""
    dev = resolve_device(device)
    f32 = dict(dtype=torch.float32, device=dev)
    mu, row, col = {}, {}, {}
    for k, p in params.items():
        if p.device != dev:
            raise ValueError(f"parameter {k!r} lies on {p.device}, not {dev}")
        mu[k] = torch.zeros(p.shape, dtype=moment_dtype, device=dev)
        if _is_factored(p):
            row[k] = torch.zeros(p.shape[:-1], **f32)
            col[k] = torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)
        else:
            row[k] = torch.zeros(p.shape, **f32)
            col[k] = torch.zeros((1,), **f32)
    return FactoredState(step=torch.zeros((), dtype=torch.int32, device=dev),
                         mu=mu, nu_row=row, nu_col=col)


@torch.no_grad()
def adafactor_update(grads: dict, state: FactoredState, params: dict, *,
                     lr, b1: float = 0.9, b2: float = 0.999,
                     eps: float = 1e-30, eps_scale: float = 1e-8
                     ) -> tuple[dict, FactoredState]:
    """One step: returns (new params, new state); the inputs are left as
    they are."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)
    new_p, new_m, new_r, new_c = {}, {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].to(torch.float32)
        m = state.mu[k]
        vr, vc = state.nu_row[k], state.nu_col[k]
        m32 = m.to(torch.float32) * b1 + (1.0 - b1) * g32
        g2 = g32 * g32 + eps
        if _is_factored(p):
            vr32 = vr * b2 + (1.0 - b2) * g2.mean(dim=-1)
            vc32 = vc * b2 + (1.0 - b2) * g2.mean(dim=-2)
            # rank-1 reconstruction: v ~ vr vc / mean(vr)
            denom = vr32.mean(dim=-1, keepdim=True) + eps
            v_hat = (vr32[..., None] * vc32[..., None, :]) / denom[..., None]
        else:
            vr32 = vr * b2 + (1.0 - b2) * g2
            vc32 = vc
            v_hat = vr32
        u = (m32 / bc1) / (torch.sqrt(v_hat / bc2) + eps_scale)
        new_p[k] = (p.to(torch.float32) - lr * u).to(p.dtype)
        new_m[k] = m32.to(m.dtype)
        new_r[k], new_c[k] = vr32, vc32
    return new_p, FactoredState(step=step, mu=new_m, nu_row=new_r,
                                nu_col=new_c)


def state_bytes(params: dict, *, factored: bool) -> int:
    """Optimizer-state bytes for the fit math: a bf16 first moment, and
    a dense f32 nu or, `factored`, its f32 row and column stats. Reads
    shapes only (meta tensors will do)."""
    total = 0
    for p in params.values():
        shape = tuple(p.shape)
        size = 1
        for n in shape:
            size *= n
        total += size * 2
        if factored and len(shape) >= 2:
            rows = cols = 1
            for n in shape[:-1]:
                rows *= n
            for n in shape[:-2] + shape[-1:]:
                cols *= n
            total += (rows + cols) * 4
        else:
            total += size * 4
    return total
