"""(Inverse) Monge structure checks (counterpart of repro.core.monge).

S is *inverse Monge* iff for all i1 < i2, j1 < j2:
    S[i1,j1] + S[i2,j2] >= S[i1,j2] + S[i2,j1],
equivalently the adjacent condition
    S[i,j] + S[i+1,j+1] >= S[i,j+1] + S[i+1,j]   for all i, j.
For inverse Monge S the identity permutation is an optimal assignment;
S = s gamma^T with s, gamma non-increasing is inverse Monge. S is
*permuted inverse Monge* if sorting its rows by the first column makes
it inverse Monge: the paper's O(m log m) ranking is that sort plus the
identity permutation. Each check runs where S lies.
"""

from __future__ import annotations

import torch


def is_inverse_monge(S: torch.Tensor, atol: float = 1e-6) -> torch.Tensor:
    """Adjacent 2x2 minor check; returns a scalar bool tensor."""
    lhs = S[:-1, :-1] + S[1:, 1:]
    rhs = S[:-1, 1:] + S[1:, :-1]
    return torch.all(lhs + atol >= rhs)


def is_permuted_inverse_monge(S: torch.Tensor,
                              atol: float = 1e-6) -> torch.Tensor:
    """True if sorting the rows by the first column, descending (a
    stable sort, as jnp.argsort's), yields inverse Monge."""
    order = torch.sort(-S[:, 0], stable=True).indices
    return is_inverse_monge(S[order], atol=atol)


def monge_defect(S: torch.Tensor) -> torch.Tensor:
    """Largest violation of the adjacent inverse-Monge condition (0 =
    Monge): what decides between the sort route and the general auction
    route (paper Sec. 3.2.2)."""
    lhs = S[:-1, :-1] + S[1:, 1:]
    rhs = S[:-1, 1:] + S[1:, :-1]
    return torch.clamp_min(torch.max(rhs - lhs), 0.0)
