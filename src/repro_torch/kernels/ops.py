"""Dispatcher of the online stage (counterpart of repro.kernels.ops):
routes a micro-batch to its kernel by predictor and returns a complete
RankingOutput.

Routes, with their launches per micro-batch on the card:
  predictor=None  lambda given: `rank_audited`, one launch;
  mean, linear    `linear_rank_audited`, one launch (lambda-hat = X W^T + c
                  in the prologue; mean is W = 0 with the clamp off);
  KNN             `knn_rank_audited`, two launches (distance sweep, then
                  merge + weighting + rank + audit);
  KNN, knn_chain  `knn_lambda` (two launches) then `rank_audited` (one):
                  three launches where the TPU chain took two.
A KNN predictor that carries a quantized db (`quant` "int8" or "bf16")
takes the same routes through the quantized twins,
`knn_rank_audited_quant` and `knn_lambda_quant`, with the same launch
counts.
Every entry point takes `device` (None = the card). On the card a route
launches its kernel or raises; only `device="cpu"` runs the plain
PyTorch versions. Nothing is padded per call beyond the affine
predictor's W and c to the problem's K (the serving engine builds those
once per bucket): the kernels mask ragged edges themselves, and the
1M-row KNN database (or its pack) is passed as it lies. The MLP family
raises NotImplementedError (`unported`).
"""

from __future__ import annotations

import torch

from repro_torch.core.predictors import (
    KNNLambdaPredictor,
    LinearLambdaPredictor,
    MeanLambdaPredictor,
    check_pack,
    pack_knn_db,
)
from repro_torch.core.ranking import AUDIT_TOL, RankingOutput
from repro_torch.device import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.common import QUANT_EXTRA, QUANT_MODES
from repro_torch.kernels.fused_rank import (
    MAX_KERNEL_M2,
    linear_rank_audited_cuda,
    rank_audited_cuda,
)
from repro_torch.kernels.knn_topk import (
    knn_lambda_cuda,
    knn_lambda_quant_cuda,
    knn_rank_audited_cuda,
    knn_rank_audited_quant_cuda,
)


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


def _quant_db(X_db, X_q, q_scale, y2_q, *, quant: str, dev):
    """The packed db of the quantized sweep on `dev`: the caller's pack,
    validated against the f32 db's row count, or X_db packed here at
    the default slab when the caller hands no pack."""
    if quant not in QUANT_MODES or quant == "off":
        raise ValueError(f"quant must be 'int8' or 'bf16', got {quant!r}")
    if X_q is None:
        return pack_knn_db(X_db, mode=quant, device=dev)
    X_q, q_scale, y2_q = (t.to(dev).contiguous()
                          for t in (X_q, q_scale, y2_q))
    check_pack(X_q, q_scale, y2_q, quant, n_train=X_db.shape[0])
    return X_q, q_scale, y2_q


def knn_rank_audited(X, X_db, lam_db, u, a, b, gamma, *, k: int = 10,
                     m2: int, eps: float = 1e-4, tol: float | None = None,
                     quant: str = "off", X_q=None, q_scale=None, y2_q=None,
                     k_extra: int = QUANT_EXTRA, return_guard: bool = False,
                     device=None):
    """The KNN online stage: lambda-hat = IDW-KNN(X) over (X_db, lam_db),
    zero for constraint rows beyond lam_db's width, then rank + audit.
    X_db and lam_db should already lie on `device` (a predictor's
    tensors do): they are never copied or padded per call.

    quant='int8'|'bf16' sweeps the packed db (X_q, q_scale, y2_q; packed
    here from X_db when not given) with `knn_rank_audited_quant`: the
    top-(k + k_extra) survivors are re-scored exactly in f32.
    `return_guard` also returns the margin guard (n, 1) int32 (zeros
    for the f32 db)."""
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
    kernel = _check_m2(m2, dev)
    guard = None
    if quant != "off":
        pack = _quant_db(X_db, X_q, q_scale, y2_q, quant=quant, dev=dev)
        args = (X, *pack, lam_db, u, a, b, gamma)
        kw = dict(k=k, k_extra=k_extra, mode=quant, m2=m2, eps=eps, tol=tol)
        if kernel:
            _, idx, util, expo, comp, lam, guard = \
                knn_rank_audited_quant_cuda(*args, **kw, device=dev)
        else:
            _, idx, util, expo, comp, lam, guard = \
                ref.knn_rank_audited_quant_ref(*args, **kw)
    elif kernel:
        _, idx, util, expo, comp, lam = knn_rank_audited_cuda(
            X, X_db, lam_db, u, a, b, gamma, k=k, m2=m2, eps=eps, tol=tol,
            device=dev)
    else:
        _, idx, util, expo, comp, lam = ref.knn_rank_audited_ref(
            X, X_db, lam_db, u, a, b, gamma, k=k, m2=m2, eps=eps, tol=tol)
    out = RankingOutput(perm=idx, utility=util, exposure=expo,
                        compliant=comp, lam=lam)
    if not return_guard:
        return out
    if guard is None:
        guard = torch.zeros((n, 1), dtype=torch.int32, device=dev)
    return out, guard


def knn_lambda(X, X_db, lam_db, *, k: int = 10, quant: str = "off",
               X_q=None, q_scale=None, y2_q=None,
               k_extra: int = QUANT_EXTRA, device=None):
    """KNN lambda-hat (B, K_pred) of the queries X (B, d) over (X_db,
    lam_db): the `knn_lambda` kernel on the card, its plain version on
    the CPU. quant='int8'|'bf16' sweeps the packed db instead
    (`knn_lambda_quant`, the pack as in knn_rank_audited)."""
    dev = resolve_device(device)
    X, X_db, lam_db = _f32(X, dev), _f32(X_db, dev), _f32(lam_db, dev)
    if X_db.shape[0] < k:
        raise ValueError(f"n_train={X_db.shape[0]} < k={k}")
    if quant == "off":
        return knn_lambda_cuda(X, X_db, lam_db, k=k, device=dev)
    pack = _quant_db(X_db, X_q, q_scale, y2_q, quant=quant, dev=dev)
    lam, _ = knn_lambda_quant_cuda(X, *pack, lam_db, k=k, k_extra=k_extra,
                                   mode=quant, device=dev)
    return lam


def linear_rank_audited(X, W, c, u, a, b, gamma, *, relu: bool, m2: int,
                        eps: float = 1e-4, tol: float | None = None,
                        device=None) -> RankingOutput:
    """The affine online stage: lambda-hat = X W^T + c (clamped at 0 if
    `relu`), then rank + audit. X (n, d), W (K, d) and c (K,) already
    padded to a's K rows (`ref.affine_params`); u, a, b, gamma as in
    `rank_audited`."""
    dev = resolve_device(device)
    tol = AUDIT_TOL if tol is None else tol
    u, a, b, gamma = _rank_inputs(u, a, b, gamma, dev)
    X, W, c = _f32(X, dev), _f32(W, dev), _f32(c, dev)
    if X.shape[0] != u.shape[0]:
        raise ValueError(f"X carries {X.shape[0]} covariate rows but the "
                         f"problem has {u.shape[0]} users")
    if _check_m2(m2, dev):
        _, idx, util, expo, comp, lam = linear_rank_audited_cuda(
            u, a, b, X, W, c, gamma, m2=m2, eps=eps, tol=tol, relu=relu,
            device=dev)
    else:
        _, idx, util, expo, comp, lam = ref.linear_rank_audited_ref(
            u, a, b, X, W, c, gamma, m2, eps, tol, relu)
    return RankingOutput(perm=idx, utility=util, exposure=expo,
                         compliant=comp, lam=lam)


def unported(predictor) -> NotImplementedError:
    """The error for a predictor family the port does not serve yet."""
    return NotImplementedError(
        f"{type(predictor).__name__}: the mean, linear and KNN families "
        f"(the KNN one also over its quantized db) are ported; the MLP is "
        f"ROADMAP Queue 1 item 3")


def route_of(predictor) -> str:
    """The route a predictor's batches take: 'lam' (None), 'affine'
    (mean, linear) or 'knn'; any other family raises (`unported`)."""
    if predictor is None:
        return "lam"
    if isinstance(predictor, KNNLambdaPredictor):
        return "knn"
    if isinstance(predictor, (LinearLambdaPredictor,
                              MeanLambdaPredictor)):
        return "affine"
    raise unported(predictor)


def predict_rank_audited(X, predictor, u, a, b, gamma, *, m2: int,
                         eps: float = 1e-4, tol: float | None = None,
                         knn_chain: bool = False, affine=None,
                         device=None) -> RankingOutput:
    """The online stage for one micro-batch, routed by predictor:
    `predictor=None` means X already holds the shadow prices (n, K) and
    runs `rank_audited`; mean and linear run `linear_rank_audited`; KNN
    runs `knn_rank_audited` on its own tensors, or with `knn_chain`
    `knn_lambda` then `rank_audited` (the same lambda-hat, bitwise); a
    KNN predictor with a quantized db takes the quantized twins of both
    (its static `quant` picks the route).
    Any other family raises NotImplementedError. `affine` is an affine
    predictor's (W, c, relu) already padded to a's K rows
    (`ref.affine_params`), as the serving engine keeps them per bucket;
    None builds them here."""
    route = route_of(predictor)
    n = u.shape[0]
    if X.shape[0] != n:
        raise ValueError(f"X carries {X.shape[0]} covariate rows but the "
                         f"problem has {n} users")
    if route == "lam":
        return rank_audited(u, a, b, X, gamma, m2=m2, eps=eps, tol=tol,
                            device=device)
    if route == "affine":
        if affine is None:
            affine = ref.affine_params(predictor, X.shape[1], a.shape[-2])
        W, c, relu = affine
        return linear_rank_audited(X, W, c, u, a, b, gamma, relu=relu,
                                   m2=m2, eps=eps, tol=tol, device=device)
    quant = predictor.quant if predictor.X_q is not None else "off"
    pack = dict(quant=quant, X_q=predictor.X_q, q_scale=predictor.q_scale,
                y2_q=predictor.y2_q)
    if not knn_chain:
        return knn_rank_audited(X, predictor.X_db, predictor.lam_db, u, a,
                                b, gamma, k=predictor.k, m2=m2, eps=eps,
                                tol=tol, device=device, **pack)
    K = a.shape[-2]
    ref.check_pred_width(predictor.num_constraints, K)
    lam = knn_lambda(X, predictor.X_db, predictor.lam_db, k=predictor.k,
                     device=device, **pack)
    lam = torch.nn.functional.pad(lam, (0, K - lam.shape[1]))
    return rank_audited(u, a, b, lam, gamma, m2=m2, eps=eps, tol=tol,
                        device=device)


def kernel_launch_count(predictor, m2: int, *, device=None,
                        knn_chain: bool = False) -> int:
    """Kernel launches one dispatcher call makes, by route: 1 for the
    lambda-given route (`predictor=None`) and for mean and linear, 2 for
    KNN, 3 for KNN with `knn_chain`, over the f32 or the quantized db
    alike; 0 where the plain PyTorch path runs
    (a CPU device, or m2 > MAX_KERNEL_M2). A count of the route, not a
    run: it needs no card."""
    dev = torch.device("cuda" if device is None else device)
    route = route_of(predictor)
    if dev.type != "cuda" or m2 > MAX_KERNEL_M2:
        return 0
    if route == "knn":
        return 3 if knn_chain else 2
    return 1
