"""Birkhoff-von Neumann decomposition, the paper's primal rounding
(counterpart of repro.core.bvn).

The primal program relaxes P to a doubly-stochastic matrix; a fractional
solution is served by decomposing it into a convex combination of
permutation matrices and sampling rankings from the mixture. Greedy
heuristic (Dufossé & Uçar 2016): repeatedly extract a permutation on
the positive entries (the auction solver's), subtract it scaled by its
smallest entry. At most (m-1)^2 + 1 terms.

`sinkhorn_project` computes in float32. JAX's is spelt float64, but the
repository runs JAX with jax_enable_x64 off, so the reference computes
in float32 too, and the port computes what it computes, in the order
XLA's CPU fusion of JAX's scan body computes it: the row sums r and the
column sums c of M / r, each added one element after another, then
one division, M / (r c^T), where JAX's source writes two. Two
divisions round apart from it by up to ~1e-6 relative over 400
iterations; this order gives its bits.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.assignment import auction
from repro_torch.device import resolve_device


def is_doubly_stochastic(P, atol: float = 1e-5) -> bool:
    P = np.asarray(P)
    return bool(
        (P >= -atol).all()
        and np.allclose(P.sum(0), 1.0, atol=atol)
        and np.allclose(P.sum(1), 1.0, atol=atol))


def bvn_decompose(P, *, max_terms: int | None = None, tol: float = 1e-6,
                  device=None):
    """Doubly-stochastic (m, m) -> (coeffs (T,), perms (T, m)), numpy.

    perms[t][j] = item placed at rank j. sum(coeffs) == 1 (up to tol);
    sum_t coeffs[t] * perm_matrix(perms[t]) == P (up to tol). The
    bookkeeping is numpy float64; each permutation comes from `auction`
    on `device` (None = the card).
    """
    dev = resolve_device(device)
    P = np.array(P, dtype=np.float64)
    m = P.shape[0]
    if not is_doubly_stochastic(P, atol=1e-3):
        raise ValueError("bvn_decompose needs a doubly-stochastic matrix")
    max_terms = max_terms or (m - 1) ** 2 + 1
    coeffs, perms = [], []
    residual = 1.0
    for _ in range(max_terms):
        if residual <= tol:
            break
        # a permutation supported on positive entries: maximize sum of
        # log-weights so zero entries are never selected
        with np.errstate(divide="ignore"):
            W = np.where(P > tol * 1e-3, np.log(np.maximum(P, 1e-300)), -1e9)
        perm = auction(torch.as_tensor(W, dtype=torch.float32, device=dev),
                       eps=1e-4).cpu().numpy()
        c = float(P[perm, np.arange(m)].min())
        if c <= tol * 1e-3:
            break
        coeffs.append(c)
        perms.append(perm.copy())
        P[perm, np.arange(m)] -= c
        residual -= c
    if residual > tol:
        # numerical dust: fold into the largest term
        k = int(np.argmax(coeffs))
        coeffs[k] += residual
    coeffs = np.asarray(coeffs)
    coeffs = coeffs / coeffs.sum()
    return coeffs, np.stack(perms)


def sample_ranking(generator: torch.Generator, coeffs: np.ndarray,
                   perms: np.ndarray) -> torch.Tensor:
    """Draw one ranking from the BvN mixture (the serving-time sampler),
    on the generator's device."""
    dev = generator.device
    p = torch.as_tensor(coeffs, dtype=torch.float32, device=dev)
    idx = torch.multinomial(p, 1, generator=generator)[0]
    return torch.as_tensor(perms, device=dev)[idx]


def sinkhorn_project(M, *, iters: int = 200, device=None) -> torch.Tensor:
    """Project a positive matrix to (approximately) doubly stochastic by
    Sinkhorn row/column normalisation, in float32 on `device` (None =
    the card)."""
    M = torch.as_tensor(M, dtype=torch.float32, device=resolve_device(device))
    M = torch.clamp_min(M, 1e-12)
    for _ in range(iters):
        r = _sum_in_order(M, 1)
        c = _sum_in_order(M / r[:, None], 0)
        M = M / (r[:, None] * c[None, :])
    return M


def _sum_in_order(M: torch.Tensor, dim: int) -> torch.Tensor:
    """The sum over `dim`, the elements added one after another."""
    parts = M.unbind(dim)
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return s
