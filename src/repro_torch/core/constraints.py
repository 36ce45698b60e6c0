"""Constraint sets and rank discounts for fixed-discounting exposure
constraints (counterpart of repro.core.constraints).

Every constraint is normalised to the >= form: a <= row has its (a_k,
b_k) negated, so the dual shadow prices are lambda_k >= 0 against >=
constraints.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device


def dcg_discount(m2: int, dtype=torch.float32) -> torch.Tensor:
    """gamma_j = 1 / log2(j + 1), j in 1..m2 (descending, positive)."""
    j = torch.arange(1, m2 + 1, dtype=dtype)
    return 1.0 / torch.log2(j + 1.0)


@dataclass(frozen=True)
class ConstraintSet:
    """K fixed-discounting constraints in the >= form.

    a: (K, m1) per-item attribute rows (already sign-flipped for <=).
    b: (K,) thresholds in absolute exposure units (sign-flipped for <=).
    """

    a: torch.Tensor
    b: torch.Tensor

    @property
    def num_constraints(self) -> int:
        return int(self.a.shape[0])


def make_constraints(a_list, b_list, signs, device=None) -> ConstraintSet:
    """A ConstraintSet from raw (a_k, b_k, sign_k) triples: sign +1 means
    tr(A^T P) >= b, -1 means <=, which is flipped to >=. The rows are
    host arrays; the set lands on `device` (None = the card)."""
    dev = resolve_device(device)
    a = torch.as_tensor(np.stack([np.asarray(x, np.float32) for x in a_list]),
                        device=dev)
    b = torch.as_tensor(np.asarray(b_list, np.float32), device=dev)
    s = torch.as_tensor(np.asarray(signs, np.float32), device=dev)
    return ConstraintSet(a=a * s[:, None], b=b * s)
