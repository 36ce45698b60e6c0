"""The online stage's rank + audit oracle (counterpart of the online
half of repro.core.ranking)."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.assignment import rank_by_sort

# Compliance slack: exposure >= b - AUDIT_TOL counts as satisfied. Shared by
# every audit path (this oracle, the plain kernel versions, the kernels).
AUDIT_TOL = 1e-6


@dataclass(frozen=True)
class RankingOutput:
    """Batched serving result."""

    perm: torch.Tensor        # (n, m2) int32 item index per rank
    utility: torch.Tensor     # (n,) tr(U^T P)
    exposure: torch.Tensor    # (n, K)
    compliant: torch.Tensor   # (n,) bool
    lam: torch.Tensor         # (n, K) shadow prices used


def audit_selected(u_sel, a_sel, gamma, b, *, tol: float = AUDIT_TOL):
    """Utility, per-constraint exposure and compliance of already
    selected slots: u_sel (n, m2), a_sel (n, K, m2), gamma (n, m2),
    b (n, K).

    The sums run slot by slot, each product and each addition rounded
    on its own, because that is the order the CUDA rank+audit kernel
    accumulates in: the plain path and the kernel then agree bitwise,
    so `compliant` never flips between them at the threshold.
    """
    utility = torch.zeros(u_sel.shape[:-1], dtype=u_sel.dtype,
                          device=u_sel.device)
    exposure = torch.zeros(a_sel.shape[:-1], dtype=a_sel.dtype,
                           device=a_sel.device)
    for j in range(u_sel.shape[-1]):
        g = gamma[..., j]
        utility = utility + u_sel[..., j] * g
        exposure = exposure + a_sel[..., j] * g[..., None]
    compliant = torch.all(exposure >= b - tol, dim=-1)
    return utility, exposure, compliant


def rank_given_lambda(u, a, b, lam, gamma, *, m2: int,
                      eps: float = 1e-4) -> RankingOutput:
    """s = u + (1+eps) lam @ a; top-m2 by s; audit the selection.

    The oracle body of repro.core.ranking.rank_given_lambda(backend=
    'xla'): `a` may be (n, K, m1) or shared (K, m1), `b` (n, K) or (K,),
    `gamma` (n, m2) or (m2,). Runs wherever its tensors lie.
    """
    n = u.shape[0]
    if a.dim() == 2:
        a = a.expand((n,) + tuple(a.shape))
    if b.dim() == 1:
        b = b.expand(n, b.shape[0])
    if gamma.dim() == 1:
        gamma = gamma.expand(n, gamma.shape[0])
    s = u + (1.0 + eps) * torch.einsum("nk,nkm->nm", lam, a)
    perm = rank_by_sort(s, m2)
    idx = perm.long()
    u_sel = torch.gather(u, 1, idx)
    a_sel = torch.gather(a, 2, idx[:, None, :].expand(-1, a.shape[1], -1))
    utility, exposure, compliant = audit_selected(u_sel, a_sel, gamma, b)
    return RankingOutput(perm=perm, utility=utility, exposure=exposure,
                         compliant=compliant, lam=lam)
