"""Sort-based optimal assignment (counterpart of
repro.core.assignment.rank_by_sort)."""

from __future__ import annotations

import torch


def rank_by_sort(s: torch.Tensor, m2: int | None = None) -> torch.Tensor:
    """Optimal assignment for fixed-discounting S = s @ gamma^T: the
    indices of the m2 largest entries of s along the last axis, best
    first, as int32.

    Ties go to the lower index, as `lax.top_k` does. `torch.topk` does
    not promise that, so this is a stable ascending sort of -s.
    """
    m1 = s.shape[-1]
    if m2 is None:
        m2 = m1
    order = torch.sort(-s, dim=-1, stable=True).indices
    return order[..., :m2].to(torch.int32)
