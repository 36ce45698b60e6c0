"""Rank discounts for fixed-discounting exposure constraints
(counterpart of repro.core.constraints)."""

from __future__ import annotations

import torch


def dcg_discount(m2: int, dtype=torch.float32) -> torch.Tensor:
    """gamma_j = 1 / log2(j + 1), j in 1..m2 (descending, positive)."""
    j = torch.arange(1, m2 + 1, dtype=dtype)
    return 1.0 / torch.log2(j + 1.0)
