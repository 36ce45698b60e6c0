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


def geometric_discount(m2: int, d: float = 0.9,
                       dtype=torch.float32) -> torch.Tensor:
    """gamma_j = d^j, j in 1..m2: the 'simple discounting' alternative of
    the paper's footnote 2."""
    j = torch.arange(1, m2 + 1, dtype=dtype)
    return torch.tensor(d, dtype=dtype) ** j


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

    def exposure(self, perm, gamma) -> torch.Tensor:
        """tr(A_k^T P) for every k given a ranking perm (m2,): (K,), the
        sum over slots j of a[:, perm[j]] * gamma[j]."""
        cols = self.a[:, torch.as_tensor(perm, device=self.a.device).long()]
        return torch.einsum("kj,j->k", cols, gamma.to(self.a.device))

    def violations(self, perm, gamma) -> torch.Tensor:
        """Positive part of b - exposure: 0 where a constraint holds."""
        return torch.clamp_min(self.b - self.exposure(perm, gamma), 0.0)

    def is_compliant(self, perm, gamma, atol: float = 1e-6) -> bool:
        return bool(torch.all(self.exposure(perm, gamma) >= self.b - atol))


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


def exposure_quota_constraints(topic_indicators, quota_fracs, signs, gamma,
                               device=None) -> ConstraintSet:
    """Table-1-style constraints: topic k's exposure >= (sign +1) or <=
    (sign -1) quota_fracs[k] of the total exposure sum_j gamma_j.
    topic_indicators (K, m1) binary."""
    total = float(torch.sum(torch.as_tensor(gamma, dtype=torch.float32)))
    b = np.asarray(quota_fracs, np.float32) * np.float32(total)
    return make_constraints(list(_host(topic_indicators)), list(b),
                            list(_host(signs)), device=device)


def movielens_style_constraints(topic_indicators, release_year_delta,
                                quota_frac: float, gamma,
                                device=None) -> ConstraintSet:
    """The MovieLens set of Table 1a: each of the topic rows (4, m1) at
    exposure >= quota_frac of the total, and the exposure-weighted
    release-year delta (m1,), (year - 1990) / 100, >= 0."""
    total = float(torch.sum(torch.as_tensor(gamma, dtype=torch.float32)))
    rows = _host(topic_indicators)
    a_rows = [rows[i] for i in range(rows.shape[0])]
    # the quota times the f32 total, rounded in f32, as the JAX set does
    b_rows = [np.float32(quota_frac) * np.float32(total)] * len(a_rows)
    a_rows.append(_host(release_year_delta))
    b_rows.append(0.0)
    return make_constraints(a_rows, b_rows, [1.0] * len(a_rows),
                            device=device)


def _host(x) -> np.ndarray:
    """x as a host f32 array (a tensor on any device, or array-like)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
    return np.asarray(x, np.float32)
