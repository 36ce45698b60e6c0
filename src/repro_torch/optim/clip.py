"""Global-norm gradient clipping (counterpart of repro.optim.clip).

A tree is nested dicts and lists of tensors, as a JAX parameter tree.
The norm sums the leaves' squared sums in jax.tree.leaves' order (dict
keys sorted, list items by position: `blocks[0].ln1` before
`blocks[0].w1`, `mlp.b0` before `mlp.w0`), one f32 add at a time from
0, as the JAX body's Python `sum` does: another order would round the
norm, and so the clipped step, apart from JAX's.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint.store import flatten_with_paths, unflatten_like


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of sum(leaf^2), in f32."""
    total = 0
    for leaf in flatten_with_paths(tree).values():
        total = total + torch.sum(leaf.to(torch.float32) ** 2)
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-12)), norm): each
    leaf scaled in f32 and cast back to its own type."""
    gn = global_norm(grads)
    scale = torch.clamp_max(max_norm / (gn + 1e-12), 1.0)
    flat = {k: (g.to(torch.float32) * scale).to(g.dtype)
            for k, g in flatten_with_paths(grads).items()}
    return unflatten_like(grads, flat), gn
