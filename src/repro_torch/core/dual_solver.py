"""Batched dual solver for ranking under constraints (counterpart of
repro.core.dual_solver): the paper's offline stage.

Under fixed discounting the Lagrangian dual of each user's LP is a
K-dimensional piecewise-linear convex minimisation,

    g(lambda) = sum_{j<=m2} s_(j) gamma_j - lambda^T b,
    s = u + sum_k lambda_k a_k,

whose subgradient exposure(P*(lambda)) - b needs only the unconstrained
top-m2 (a sort). It is solved by projected subgradient descent with
AdaGrad steps, then rounded by the best of three candidate iterates and
a short multiplicative feasibility polish.

The JAX package vmaps a per-user scan; here every step runs on (n, ...)
tensors at once, one Python loop over iterations, wherever the inputs
lie (the card for the offline stage). The body repeats the JAX one step
by step; `solve_dual` is the batch of one. The JAX package computes this
in XLA outside any Pallas kernel, so it is plain PyTorch here too.

The iterates live near the kinks of g, where one ulp in s can swap a
top-m2 member and part two trajectories. The port cannot repeat the
reference's arithmetic bit for bit: XLA's CPU code contracts a*b + c
into fused multiply-adds and computes 1/sqrt with an approximate
reciprocal square root, so the AdaGrad step may differ in its last ulp.
That drift stays within the tests' tolerance unless it decides an exact
tie. The known case: the first step moves a price by exactly lr in the
[0, 1] units, so an item at u_n = 0 with a_k = 1 ties the item at
u_n = 1, and the last ulp of the step decides it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.assignment import rank_by_sort
from repro_torch.core.constraints import ConstraintSet


@dataclass(frozen=True)
class DualSolution:
    """Per-user results; every field has the batch axis first."""

    lam: torch.Tensor           # (n, K) shadow prices, original units
    dual_value: torch.Tensor    # (n,) g(lam): upper bound on the optimum
    primal_value: torch.Tensor  # (n,) utility of the rounded ranking
    exposure: torch.Tensor      # (n, K) exposure of the rounded ranking
    compliant: torch.Tensor     # (n,) bool
    gap: torch.Tensor           # (n,) dual_value - primal_value
    iters: int


def _lam_dot_a(lam, a):
    """sum_k lam_k a_k for lam (n, K), a (n, K, m1) -> (n, m1): the
    product over K taken constraint by constraint."""
    acc = lam[:, 0, None] * a[:, 0]
    for k in range(1, a.shape[1]):
        acc = acc + lam[:, k, None] * a[:, k]
    return acc


def _exposure(a, idx, gamma):
    """sum_j a[:, :, idx_j] gamma_j (n, K) of the selected items."""
    sel = torch.gather(a, 2, idx[:, None, :].expand(-1, a.shape[1], -1))
    return (sel * gamma[:, None, :]).sum(-1)


def _seq_sum(x):
    """Sum over the last (small) axis, element by element from 0."""
    acc = x[..., 0]
    for k in range(1, x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _top(s, m2):
    """Indices (int64) of the m2 largest s per row, ties to the lower
    index, as lax.top_k."""
    return rank_by_sort(s, m2).long()


def _dual_eval(lam, u, a, b, gamma, m2: int):
    """g(lambda) (n,), its subgradient (n, K) and the top-m2 (n, m2)."""
    s = u + _lam_dot_a(lam, a)
    idx = _top(s, m2)
    top_s = torch.gather(s, 1, idx)
    g = (top_s * gamma).sum(-1) - (lam * b).sum(-1)
    return g, _exposure(a, idx, gamma) - b, idx


def _round_stats(lam, u, a, b, gamma, m2: int, eps_boost: float):
    """Rank with lam (tie-break boost eps_boost): (violation (n,),
    utility (n,), exposure (n, K))."""
    idx = _top(u + (1.0 + eps_boost) * _lam_dot_a(lam, a), m2)
    expo = _exposure(a, idx, gamma)
    viol = _seq_sum(torch.clamp_min(b - expo, 0.0))
    util = (torch.gather(u, 1, idx) * gamma).sum(-1)
    return viol, util, expo


def _better(viol, util, best_v, best_u):
    """Lexicographic (violation, -utility) improvement, as the JAX body
    decides it."""
    return (viol < best_v - 1e-9) | ((viol <= best_v + 1e-9) &
                                     (util > best_u))


def solve_dual_batch(u_batch, a_batch, b_batch, gamma, *, m2: int,
                     num_iters: int = 300, lr: float = 1.0,
                     max_lambda: float = 1e4,
                     eps_boost: float = 1e-4) -> DualSolution:
    """One dual per user, all users at once: u (n, m1), a (n, K, m1) or
    shared (K, m1), b (n, K) or (K,), gamma (m2,). Tensors, f32, on one
    device; the solve runs there."""
    u = u_batch.to(torch.float32)
    n = u.shape[0]
    a, b = a_batch, b_batch
    if a.dim() == 2:
        a = a.expand((n,) + tuple(a.shape))
    if b.dim() == 1:
        b = b.expand(n, b.shape[0])
    K = a.shape[1]
    g_rows = gamma.expand(n, gamma.shape[-1])
    dev, f32 = u.device, torch.float32

    # normalise u to [0, 1]; lambda is rescaled by sigma at the end
    u_lo = u.amin(-1, keepdim=True)
    u_hi = u.amax(-1, keepdim=True)
    sigma = torch.clamp_min(u_hi - u_lo, 1e-9)
    u_n = (u - u_lo) / sigma

    half = num_iters // 2
    inf = torch.full((n,), float("inf"), dtype=f32, device=dev)
    lam = torch.zeros((n, K), dtype=f32, device=dev)
    gsq = torch.zeros_like(lam)
    best_lam, best_g = lam, inf
    r_lam, r_viol, r_util = lam, inf, -inf
    avg = lam
    for it in range(num_iters):
        g, sub, idx = _dual_eval(lam, u_n, a, b, g_rows, m2)
        improved = g < best_g
        best_lam = torch.where(improved[:, None], lam, best_lam)
        best_g = torch.minimum(g, best_g)
        viol = _seq_sum(torch.clamp_min(-sub, 0.0))
        util = (torch.gather(u_n, 1, idx) * g_rows).sum(-1)
        better = _better(viol, util, r_viol, r_util)
        r_lam = torch.where(better[:, None], lam, r_lam)
        r_viol = torch.where(better, viol, r_viol)
        r_util = torch.where(better, util, r_util)
        if it >= half:
            avg = avg + lam / (num_iters - half)
        gsq = gsq + sub * sub
        step = lr / torch.sqrt(gsq + 1e-12)
        lam = torch.clamp(lam - step * sub, 0.0, max_lambda)
    g_fin, _, _ = _dual_eval(lam, u_n, a, b, g_rows, m2)
    use_fin = g_fin < best_g
    best_lam = torch.where(use_fin[:, None], lam, best_lam)
    best_g = torch.where(use_fin, g_fin, best_g)

    # the rounding lambda: best of three candidates by (viol, -util)
    cands = (r_lam, avg, best_lam)
    stats = [_round_stats(c, u_n, a, b, g_rows, m2, eps_boost)
             for c in cands]
    viols = torch.stack([st[0] for st in stats], dim=-1)       # (n, 3)
    utils = torch.stack([st[1] for st in stats], dim=-1)
    score = viols - 1e-6 * utils / (
        utils.abs().amax(-1, keepdim=True) + 1e-9)
    pick = torch.argmin(score, dim=-1)            # first minimum on ties
    lam_round = torch.gather(torch.stack(cands, dim=1), 1,
                             pick[:, None, None].expand(-1, 1, K))[:, 0]

    # feasibility polish: bump violated prices, relax slack ones
    lam_c, best_v, best_u = lam_round, inf, -inf
    for _ in range(40):
        viol, util, expo = _round_stats(lam_c, u_n, a, b, g_rows, m2,
                                        eps_boost)
        better = _better(viol, util, best_v, best_u)
        lam_round = torch.where(better[:, None], lam_c, lam_round)
        best_v = torch.where(better, viol, best_v)
        best_u = torch.where(better, util, best_u)
        bump = torch.clamp_min(b - expo, 0.0) > 1e-9
        lam_c = torch.where(bump, lam_c * 1.3 + 0.02, lam_c)
        relax = (expo - b > 0.1 * b.abs() + 1e-3) & ~bump
        lam_c = torch.clamp(torch.where(relax, lam_c * 0.97, lam_c), 0.0,
                            max_lambda)

    idx = _top(u_n + (1.0 + eps_boost) * _lam_dot_a(lam_round, a), m2)
    primal = (torch.gather(u, 1, idx) * g_rows).sum(-1)
    exposure = _exposure(a, idx, g_rows)
    compliant = torch.all(exposure >= b - 1e-6, dim=-1)
    dual = best_g * sigma[:, 0] + u_lo[:, 0] * gamma.sum()
    return DualSolution(lam=lam_round * sigma, dual_value=dual,
                        primal_value=primal, exposure=exposure,
                        compliant=compliant, gap=dual - primal,
                        iters=num_iters)


def solve_dual(u, cons: ConstraintSet, gamma, *, m2: int,
               num_iters: int = 300, lr: float = 1.0,
               max_lambda: float = 1e4,
               eps_boost: float = 1e-4) -> DualSolution:
    """One user's dual: u (m1,), cons.a (K, m1), cons.b (K,). The batch
    of one; fields lose the batch axis."""
    sol = solve_dual_batch(u[None], cons.a[None], cons.b[None], gamma,
                           m2=m2, num_iters=num_iters, lr=lr,
                           max_lambda=max_lambda, eps_boost=eps_boost)
    return DualSolution(lam=sol.lam[0], dual_value=sol.dual_value[0],
                        primal_value=sol.primal_value[0],
                        exposure=sol.exposure[0], compliant=sol.compliant[0],
                        gap=sol.gap[0], iters=sol.iters)


def serve_rank(u, a, lam, gamma, *, m2: int, eps_boost: float = 1e-4):
    """Online stage without the audit: perm (.., m2) of s = u + (1+eps)
    lam @ a and its utility. u (m1,) or (n, m1), a (K, m1) or
    (n, K, m1), lam (K,) or (n, K)."""
    squeeze = u.dim() == 1
    u2 = u[None] if squeeze else u
    lam2 = lam[None] if lam.dim() == 1 else lam
    a3 = a.expand((u2.shape[0],) + tuple(a.shape)) if a.dim() == 2 else a
    s = u2 + (1.0 + eps_boost) * _lam_dot_a(lam2, a3)
    perm = rank_by_sort(s, m2)
    utility = (torch.gather(u2, 1, perm.long()) * gamma).sum(-1)
    return (perm[0], utility[0]) if squeeze else (perm, utility)
