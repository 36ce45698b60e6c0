"""RankingPipeline, Algorithm 1 of the paper (counterpart of
repro.core.ranking).

Offline stage: solve every train user's dual (core.dual_solver), fit the
predictors f(X) -> lambda on (covariates, shadow prices), tune the
epsilon tie-break on the train users (the paper's footnote 3 grid).

Online stage: predict lam_hat = f(X), rank by s = u + (1+eps) lam_hat @ a,
audit. `rank_with_strategy` runs the paper's Fig. 2 strategies ('none',
'optimal', 'mean', 'knn', and 'linear' beyond the paper) behind one
entry point. backend='torch' is the plain einsum oracle; 'kernel' goes
through the kernels' dispatcher (kernels.ops).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from repro_torch.core.assignment import rank_by_sort
from repro_torch.core.dual_solver import DualSolution, solve_dual_batch
from repro_torch.core.predictors import (
    KNNLambdaPredictor,
    LinearLambdaPredictor,
    MeanLambdaPredictor,
)
from repro_torch.device import resolve_device

# The paper's footnote 3: eps grid {0} U {i * 10^-j | i in 1..9, j in 1..4}.
EPS_GRID = tuple([0.0] + [i * 10.0 ** (-j) for j in range(4, 0, -1)
                          for i in range(1, 10)])
BACKENDS = ("torch", "kernel")

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


@dataclass(frozen=True)
class RankingPipeline:
    """Fitted pipeline state; its tensors live on one device."""

    m2: int
    gamma: torch.Tensor                # (m2,)
    eps: float
    predictors: dict[str, Any]
    lam_train: torch.Tensor            # (n_train, K) offline shadow prices
    train_solution: DualSolution


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


def _check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}, expected one of "
                         f"{BACKENDS}")


def rank_given_lambda(u, a, b, lam, gamma, *, m2: int, eps: float = 1e-4,
                      backend: str = "torch") -> RankingOutput:
    """s = u + (1+eps) lam @ a; top-m2 by s; audit the selection.

    backend='torch' is the oracle body of repro.core.ranking.
    rank_given_lambda(backend='xla'); 'kernel' calls ops.rank_audited.
    `a` may be (n, K, m1) or shared (K, m1), `b` (n, K) or (K,), `gamma`
    (n, m2) or (m2,). Runs wherever its tensors lie.
    """
    _check_backend(backend)
    if backend == "kernel":
        from repro_torch.kernels.ops import rank_audited  # deferred: no cycle

        return rank_audited(u, a, b, lam, gamma, m2=m2, eps=eps,
                            device=u.device)
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


# ---------------------------------------------------------------------------
# Offline stage
# ---------------------------------------------------------------------------

def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def offline_solve(u_train, a_train, b, gamma, *, m2: int,
                  num_iters: int = 400, device=None) -> DualSolution:
    """Batched dual solve over the train users (Algorithm 1's offline
    loop) on `device` (None = the card)."""
    dev = resolve_device(device)
    return solve_dual_batch(_f32(u_train, dev), _f32(a_train, dev),
                            _f32(b, dev), _f32(gamma, dev), m2=m2,
                            num_iters=num_iters)


def tune_eps(u, a, b, lam, gamma, *, m2: int, grid=EPS_GRID) -> float:
    """The eps of `grid` with the fewest train users out of compliance;
    the grid is walked in ascending order and a tie keeps the smaller
    eps. Runs wherever its tensors lie."""
    best_eps, best_viol = 0.0, np.inf
    n = u.shape[0]
    for eps in sorted(float(e) for e in grid):
        out = rank_given_lambda(u, a, b, lam, gamma, m2=m2, eps=eps)
        viol = int((~out.compliant).sum()) / n
        if viol < best_viol - 1e-12:
            best_viol, best_eps = viol, eps
    return best_eps


def fit_pipeline(X_train, u_train, a_train, b, gamma, *, m2: int,
                 num_iters: int = 400, knn_k: int = 10,
                 with_mlp: bool = False, device=None) -> RankingPipeline:
    """The whole offline stage on `device` (None = the card): dual
    solve, then the mean, KNN and linear predictors, then eps."""
    if with_mlp:
        raise NotImplementedError(
            "the MLP predictor is not ported yet (ROADMAP Queue 1 item 3: "
            "it needs optim/adam.py)")
    dev = resolve_device(device)
    X, u, a = _f32(X_train, dev), _f32(u_train, dev), _f32(a_train, dev)
    b, gamma = _f32(b, dev), _f32(gamma, dev)
    sol = solve_dual_batch(u, a, b, gamma, m2=m2, num_iters=num_iters)
    lam = sol.lam
    predictors = {
        "mean": MeanLambdaPredictor.fit(X, lam, device=dev),
        "knn": KNNLambdaPredictor.fit(X, lam, k=knn_k, device=dev),
        "linear": LinearLambdaPredictor.fit(X, lam, device=dev),
    }
    eps = tune_eps(u, a, b, lam, gamma, m2=m2)
    return RankingPipeline(m2=m2, gamma=gamma, eps=eps,
                           predictors=predictors, lam_train=lam,
                           train_solution=sol)


# ---------------------------------------------------------------------------
# Online stage
# ---------------------------------------------------------------------------

def serve(pipe: RankingPipeline, X, u, a, b, *, predictor: str = "knn",
          backend: str = "torch", device=None) -> RankingOutput:
    """Predict lam_hat from covariates X (n, d), then rank and audit.
    backend='kernel' is one dispatcher call, ops.predict_rank_audited;
    'torch' runs the predictor's predict, then the einsum oracle."""
    _check_backend(backend)
    dev = resolve_device(device)
    X, u, a, b = (_f32(x, dev) for x in (X, u, a, b))
    pred = pipe.predictors[predictor]
    if backend == "kernel":
        from repro_torch.kernels.ops import predict_rank_audited  # no cycle

        return predict_rank_audited(X, pred, u, a, b, pipe.gamma,
                                    m2=pipe.m2, eps=pipe.eps, device=dev)
    return rank_given_lambda(u, a, b, pred.predict(X), pipe.gamma,
                             m2=pipe.m2, eps=pipe.eps)


def rank_with_strategy(pipe: RankingPipeline, strategy: str, X, u, a, b, *,
                       dual_iters: int = 400, backend: str = "torch",
                       device=None) -> RankingOutput:
    """The paper's Fig. 2 strategies: 'none' (lam = 0, eps = 0),
    'optimal' (each user's own dual solve), or a fitted predictor's
    name ('mean', 'knn', 'linear')."""
    _check_backend(backend)
    dev = resolve_device(device)
    u, a, b = (_f32(x, dev) for x in (u, a, b))
    n, K = u.shape[0], pipe.lam_train.shape[1]
    if strategy == "none":
        lam = torch.zeros((n, K), dtype=torch.float32, device=dev)
        return rank_given_lambda(u, a, b, lam, pipe.gamma, m2=pipe.m2,
                                 eps=0.0, backend=backend)
    if strategy == "optimal":
        sol = solve_dual_batch(u, a, b, pipe.gamma, m2=pipe.m2,
                               num_iters=dual_iters)
        return rank_given_lambda(u, a, b, sol.lam, pipe.gamma, m2=pipe.m2,
                                 eps=pipe.eps, backend=backend)
    return serve(pipe, X, u, a, b, predictor=strategy, backend=backend,
                 device=dev)


def with_predictor(pipe: RankingPipeline, name: str,
                   predictor: Any) -> RankingPipeline:
    return replace(pipe, predictors={**pipe.predictors, name: predictor})
