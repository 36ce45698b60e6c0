"""Assignment (weighted bipartite matching) algorithms (counterpart of
repro.core.assignment).

  * ``rank_by_sort``       — O(m log m) sort-based optimal assignment for
                             fixed-discounting / (permuted) inverse-Monge
                             S (the rearrangement inequality).
  * ``greedy_half_approx`` — O(m1·m2) greedy 1/2-approximation for
                             general S.
  * ``auction``            — Bertsekas' auction: exact (up to eps)
                             max-weight matching for general S.
  * ``brute_force``        — O(m!) oracle for tests (numpy, m <= 8).

All routines take the unbalanced case (m1 items -> m2 <= m1 rank
positions; every rank holds one item, items may stay unassigned). A
ranking is ``perm`` (m2,): perm[j] = the item at rank j (rank 0 = top).
The tensor routines run wherever their tensors lie; argmax and top-2
tie to the lowest index, as JAX's do.
"""

from __future__ import annotations

import itertools

import numpy as np
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


def assignment_value(s: torch.Tensor, gamma: torch.Tensor,
                     perm: torch.Tensor) -> torch.Tensor:
    """tr(S^T P) for S = s gamma^T and the ranking ``perm``."""
    return torch.sum(s[..., perm.long()] * gamma, dim=-1)


def assignment_value_dense(S: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """tr(S^T P) for a dense (m1, m2) score matrix."""
    cols = torch.arange(perm.shape[-1], device=S.device)
    return torch.sum(S[perm.long(), cols], dim=-1)


def perm_to_matrix(perm: torch.Tensor, m1: int) -> torch.Tensor:
    """Ranking -> (m1, m2) permutation (selection) matrix P, f32."""
    m2 = perm.shape[-1]
    P = torch.zeros((m1, m2), dtype=torch.float32, device=perm.device)
    P[perm.long(), torch.arange(m2, device=perm.device)] = 1.0
    return P


def greedy_half_approx(S: torch.Tensor) -> torch.Tensor:
    """Greedy max-weight matching: m2 rounds, each takes the largest
    remaining entry of S (the first in row-major order on a tie) and
    retires its row (item) and column (rank). A 1/2-approximation in the
    worst case. Returns perm (m2,) int32."""
    m1, m2 = S.shape
    Sm = S.clone()
    perm = torch.zeros((m2,), dtype=torch.int32, device=S.device)
    for _ in range(m2):
        flat = int(torch.argmax(Sm))
        i, j = flat // m2, flat % m2
        Sm[i, :] = -torch.inf
        Sm[:, j] = -torch.inf
        perm[j] = i
    return perm


def auction(S: torch.Tensor, eps: float = 1e-3,
            max_iters: int = 50_000) -> torch.Tensor:
    """Gauss-Seidel auction in f32, JAX's loop: while a rank is
    unassigned (and fewer than max_iters bids), the lowest-index
    unassigned rank bids for its best item at current prices, raising
    that item's price by the best-minus-second value plus eps and
    evicting its owner. Returns perm (m2,) int32 (-1 where max_iters ran
    out first). Runs where S lies."""
    S = torch.as_tensor(S, dtype=torch.float32)
    m1, m2 = S.shape
    owner = torch.full((m2,), -1, dtype=torch.int32, device=S.device)
    prices = torch.zeros((m1,), dtype=torch.float32, device=S.device)
    for _ in range(max_iters):
        free = owner < 0
        if not bool(free.any()):
            break
        j = int(torch.argmax(free.to(torch.int8)))
        values = S[:, j] - prices
        top2 = torch.sort(values, descending=True, stable=True)
        i = top2.indices[0]
        prices[i] += top2.values[0] - top2.values[1] + eps
        owner[owner == i] = -1
        owner[j] = i
    return owner


def brute_force(S: np.ndarray) -> np.ndarray:
    """Exact max-weight assignment by enumeration. m1 <= 8. Returns perm."""
    S = np.asarray(S)
    m1, m2 = S.shape
    best_val, best_perm = -np.inf, None
    cols = np.arange(m2)
    for items in itertools.permutations(range(m1), m2):
        val = S[list(items), cols].sum()
        if val > best_val:
            best_val, best_perm = val, np.array(items)
    return best_perm


def brute_force_constrained(
    U: np.ndarray, A: np.ndarray, b: np.ndarray, signs: np.ndarray
) -> tuple[np.ndarray | None, float]:
    """Exact *constrained* max-utility assignment by enumeration (tests only).

    U: (m1, m2) utility; A: (K, m1, m2) constraint matrices; b: (K,);
    signs: (K,) +1 for >=, -1 for <=. Returns (perm, value) over feasible
    permutations, or (None, -inf) if infeasible.
    """
    U = np.asarray(U)
    m1, m2 = U.shape
    K = len(b)
    best_val, best_perm = -np.inf, None
    cols = np.arange(m2)
    for items in itertools.permutations(range(m1), m2):
        items_l = list(items)
        ok = True
        for k in range(K):
            v = A[k][items_l, cols].sum()
            if signs[k] > 0 and v < b[k] - 1e-9:
                ok = False
                break
            if signs[k] < 0 and v > b[k] + 1e-9:
                ok = False
                break
        if not ok:
            continue
        val = U[items_l, cols].sum()
        if val > best_val:
            best_val, best_perm = val, np.array(items)
    return best_perm, best_val
