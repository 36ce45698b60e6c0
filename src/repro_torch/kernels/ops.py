"""Dispatcher of the online stage (counterpart of repro.kernels.ops):
routes a micro-batch to its kernel by predictor and returns a complete
RankingOutput.

Routes ported in this slice:
  predictor=None  lambda given: `rank_audited`, one launch;
  KNN             `knn_rank_audited`, two launches (distance sweep, then
                  merge + weighting + rank + audit).
Every entry point takes `device` (None = the card). On the card a route
launches its kernel or raises; only `device="cpu"` runs the plain
PyTorch versions. Nothing is padded here: the kernels mask ragged edges
themselves, and the 1M-row KNN database is passed as it lies.
"""

from __future__ import annotations

import torch

from repro_torch.core.predictors import KNNLambdaPredictor
from repro_torch.core.ranking import AUDIT_TOL, RankingOutput
from repro_torch.device import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.fused_rank import MAX_KERNEL_M2, rank_audited_cuda
from repro_torch.kernels.knn_topk import knn_rank_audited_cuda


def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()


def _rank_inputs(u, a, b, gamma, dev):
    """u, a, b, gamma as contiguous f32 on `dev`, with the shared forms
    a (K, m1), b (K,) and gamma (m2,) broadcast over the n rows."""
    u = _f32(u, dev)
    n = u.shape[0]
    a, b, gamma = _f32(a, dev), _f32(b, dev), _f32(gamma, dev)
    if a.dim() == 2:
        a = a.expand((n,) + tuple(a.shape)).contiguous()
    if b.dim() == 1:
        b = b.expand(n, b.shape[0]).contiguous()
    if gamma.dim() == 1:
        gamma = gamma.expand(n, gamma.shape[0]).contiguous()
    return u, a, b, gamma


def _check_m2(m2: int, dev: torch.device) -> bool:
    """True when the kernels take m2; on the card a larger m2 raises."""
    if m2 <= MAX_KERNEL_M2:
        return True
    if dev.type == "cuda":
        raise NotImplementedError(
            f"m2={m2} > {MAX_KERNEL_M2}: the full-sort route for large m2 "
            f"is not ported to the card yet (ROADMAP Queue 1 item 4)")
    return False


def rank_audited(u, a, b, lam, gamma, *, m2: int, eps: float = 1e-4,
                 tol: float | None = None, device=None) -> RankingOutput:
    """Rank + audit with lambda given: u (n, m1), a (n, K, m1) or
    (K, m1), b (n, K) or (K,), lam (n, K), gamma (n, m2) or (m2,)."""
    dev = resolve_device(device)
    tol = AUDIT_TOL if tol is None else tol
    u, a, b, gamma = _rank_inputs(u, a, b, gamma, dev)
    lam = _f32(lam, dev)
    if _check_m2(m2, dev):
        _, idx, util, expo, comp = rank_audited_cuda(
            u, a, b, lam, gamma, m2=m2, eps=eps, tol=tol, device=dev)
    else:
        _, idx, util, expo, comp = ref.rank_audited_ref(
            u, a, b, lam, gamma, m2, eps, tol)
    return RankingOutput(perm=idx, utility=util, exposure=expo,
                         compliant=comp, lam=lam)


def knn_rank_audited(X, X_db, lam_db, u, a, b, gamma, *, k: int = 10,
                     m2: int, eps: float = 1e-4, tol: float | None = None,
                     device=None) -> RankingOutput:
    """The KNN online stage: lambda-hat = IDW-KNN(X) over (X_db, lam_db),
    zero for constraint rows beyond lam_db's width, then rank + audit.
    X_db and lam_db should already lie on `device` (a predictor's
    tensors do): they are never copied or padded per call."""
    dev = resolve_device(device)
    tol = AUDIT_TOL if tol is None else tol
    u, a, b, gamma = _rank_inputs(u, a, b, gamma, dev)
    X = _f32(X, dev)
    n = u.shape[0]
    if X.shape[0] != n:
        raise ValueError(f"X carries {X.shape[0]} covariate rows but the "
                         f"problem has {n} users")
    X_db, lam_db = _f32(X_db, dev), _f32(lam_db, dev)
    if X_db.shape[0] < k:
        raise ValueError(f"n_train={X_db.shape[0]} < k={k}")
    ref.check_pred_width(lam_db.shape[1], a.shape[1])
    if _check_m2(m2, dev):
        _, idx, util, expo, comp, lam = knn_rank_audited_cuda(
            X, X_db, lam_db, u, a, b, gamma, k=k, m2=m2, eps=eps, tol=tol,
            device=dev)
    else:
        _, idx, util, expo, comp, lam = ref.knn_rank_audited_ref(
            X, X_db, lam_db, u, a, b, gamma, k=k, m2=m2, eps=eps, tol=tol)
    return RankingOutput(perm=idx, utility=util, exposure=expo,
                         compliant=comp, lam=lam)


def unported(predictor) -> NotImplementedError:
    """The error for a predictor family this slice does not port."""
    return NotImplementedError(
        f"{type(predictor).__name__}: only the KNN predictor is ported; "
        f"mean, linear and MLP are ROADMAP Queue 1 item 3 (kernel: Queue 2 "
        f"item 3), the quantized KNN database Queue 1 item 6")


def predict_rank_audited(X, predictor, u, a, b, gamma, *, m2: int,
                         eps: float = 1e-4, tol: float | None = None,
                         device=None) -> RankingOutput:
    """The online stage for one micro-batch, routed by predictor:
    `predictor=None` means X already holds the shadow prices (n, K) and
    runs `rank_audited`; a KNN predictor runs `knn_rank_audited` on
    its own tensors. Any other family raises NotImplementedError."""
    n = u.shape[0]
    if X.shape[0] != n:
        raise ValueError(f"X carries {X.shape[0]} covariate rows but the "
                         f"problem has {n} users")
    if predictor is None:
        return rank_audited(u, a, b, X, gamma, m2=m2, eps=eps, tol=tol,
                            device=device)
    if isinstance(predictor, KNNLambdaPredictor):
        return knn_rank_audited(X, predictor.X_db, predictor.lam_db, u, a,
                                b, gamma, k=predictor.k, m2=m2, eps=eps,
                                tol=tol, device=device)
    raise unported(predictor)


def kernel_launch_count(predictor, m2: int, *, device=None) -> int:
    """Kernel launches one dispatcher call makes, by route: 1 for the
    lambda-given route (`predictor=None`), 2 for KNN, 0 where the plain
    PyTorch path runs (a CPU device, or m2 > MAX_KERNEL_M2). A count of
    the route, not a run: it needs no card."""
    dev = torch.device("cuda" if device is None else device)
    if predictor is not None and not isinstance(predictor,
                                                KNNLambdaPredictor):
        raise unported(predictor)
    if dev.type != "cuda" or m2 > MAX_KERNEL_M2:
        return 0
    return 1 if predictor is None else 2
