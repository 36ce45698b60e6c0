"""Plain PyTorch versions of the CUDA kernels: the semantics contracts.

The CPU tests run them, the kernel wrappers run them when their tensors
lie on the CPU, and chip_smoke.py holds each kernel against them on the
card. They repeat the kernels' arithmetic order (the score axpy, the
sequential distance dot, the sequential audit, weighting and bag sums),
so a kernel and its plain version agree bitwise. dual_adjust_ref is the
oracle's einsum score, which the dispatcher's large-m2 route ranks.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.predictors import (
    KNNLambdaPredictor,
    LinearLambdaPredictor,
    MeanLambdaPredictor,
    _idw_lambda,
    _quant_flush,
    knn_quant_scan,
    knn_topk_scan,
    quant_idw,
)
from repro_torch.core.ranking import AUDIT_TOL, audit_selected
from repro_torch.kernels.common import (
    QUANT_EXTRA,
    dot_seq,
    quant_d2_tile,
    sq_norm_seq,
)

# distance elements a plain KNN chunk may hold (b * chunk), 64 MiB of f32
_REF_CHUNK_ELEMS = 1 << 24


def score_axpy(u, a, lam, eps: float):
    """s = u + (1+eps) * sum_k lam_k a_k as the unrolled axpy of the
    Pallas kernel (fused_rank._merge_scored_tile): s starts at u and
    adds ((1+eps) * lam_k) * a_k one constraint at a time."""
    c = float(np.float32(1.0 + eps))
    s = u
    for k in range(a.shape[1]):
        s = s + (c * lam[:, k:k + 1]) * a[:, k, :]
    return s


def dual_adjust_ref(u, a, lam, eps: float = 0.0):
    """Just the adjusted score s = u + (1+eps) lam @ a (no selection), as
    the oracle forms it: one einsum over k."""
    return u + (1.0 + eps) * torch.einsum("nk,nkm->nm", lam, a)


def fused_rank_ref(u, a, lam, m2: int, eps: float = 1e-4):
    """Adjusted-score top-m2: u (n, m1), a (n, K, m1), lam (n, K) ->
    (vals (n, m2) desc, idx (n, m2) int32), s formed by score_axpy; ties
    go to the lower item index (a stable sort). The plain version of the
    fused_rank kernel."""
    s = score_axpy(u, a, lam, eps)
    order = torch.sort(-s, dim=-1, stable=True).indices[:, :m2]
    return torch.gather(s, 1, order), order.to(torch.int32)


def rank_audited_ref(u, a, b, lam, gamma, m2: int, eps: float = 1e-4,
                     tol: float | None = None):
    """Rank + audit: u (n, m1), a (n, K, m1), b (n, K), lam (n, K),
    gamma (n, m2) -> (vals (n, m2) desc, idx (n, m2) int32, utility (n,),
    exposure (n, K), compliant (n,) bool). Ties go to the lower item
    index."""
    if tol is None:
        tol = AUDIT_TOL
    vals, idx = fused_rank_ref(u, a, lam, m2, eps)
    order = idx.long()
    u_sel = torch.gather(u, 1, order)
    a_sel = torch.gather(a, 2, order[:, None, :].expand(-1, a.shape[1], -1))
    utility, exposure, compliant = audit_selected(u_sel, a_sel, gamma, b,
                                                  tol=tol)
    return vals, idx, utility, exposure, compliant


def d2_sequential(Xq, x2, db):
    """Expanded-form squared distances with the cross term summed
    coordinate by coordinate, each product and addition rounded on its
    own: the CUDA sweep's order. x2 (b, 1) must come from sq_norm_seq."""
    cross = dot_seq(Xq[:, None, :], db[None, :, :])
    y2 = sq_norm_seq(db)
    return torch.clamp_min(x2 - 2.0 * cross + y2[None, :], 0.0)


def knn_topk_ref(xq, xdb, k: int):
    """The k nearest db rows of each query: xq (B, D), xdb (N, D), f32 or
    bf16 (widened to f32) -> (d2 (B, k) ascending f32, idx (B, k) int32),
    d2 = max(|q|^2 - 2 q.x + |x|^2, 0) in the sweep's order
    (d2_sequential), selected by (d2, index) with the database streamed
    in chunks. The plain version of the knn_topk kernel, and the
    selection knn_lambda_ref weights."""
    xq, xdb = xq.to(torch.float32), xdb.to(torch.float32)
    chunk = max(1024, _REF_CHUNK_ELEMS // max(1, xq.shape[0]))
    d2_top, idx = knn_topk_scan(xdb, xq, k=k, chunk=chunk,
                                d2_fn=d2_sequential,
                                x2=sq_norm_seq(xq)[:, None])
    return d2_top, idx.to(torch.int32)


def knn_lambda_ref(xq, xdb, lam_db, k: int):
    """Inverse-distance-weighted KNN lambda-hat (B, K) on the k nearest
    rows of knn_topk_ref: the plain version of the knn_lambda kernel."""
    d2_top, idx = knn_topk_ref(xq, xdb, k)
    idx = idx.long()
    return _idw_lambda(d2_top, sq_norm_seq(xq)[:, None],
                       sq_norm_seq(xdb[idx]), lam_db[idx])


def check_pred_width(k_pred: int, k_bucket: int) -> None:
    """A predictor may emit fewer shadow prices than the problem has
    constraint rows (the extras get lam = 0), never more."""
    if k_pred > k_bucket:
        raise ValueError(
            f"predictor emits {k_pred} shadow prices but the problem "
            f"carries only {k_bucket} constraint rows; serving a "
            f"constraint the predictor was not fit for needs lam, not X")


def knn_rank_audited_ref(X, X_db, lam_db, u, a, b, gamma, *, k: int,
                         m2: int, eps: float = 1e-4,
                         tol: float | None = None):
    """The KNN online stage: lambda-hat from knn_lambda_ref, zero-padded
    to a's constraint rows, then rank_audited_ref. Returns the five
    rank_audited_ref outputs plus lam (n, K)."""
    check_pred_width(lam_db.shape[1], a.shape[1])
    lam = knn_lambda_ref(X, X_db, lam_db, k)
    lam = torch.nn.functional.pad(lam, (0, a.shape[1] - lam.shape[1]))
    return (*rank_audited_ref(u, a, b, lam, gamma, m2, eps, tol), lam)


def knn_quant_select_ref(xq, X_q, q_scale, y2_q, k: int, *,
                         k_extra: int | None = None, mode: str = "int8"):
    """The quantized selection from the whole (B, n_pad) quantized
    distance matrix at once (counterpart of the JAX oracle of the same
    name): the top-(k + k_extra) by stable sort, then the flush of
    core.predictors.knn_quant_scan. Returns (d2 (B, k), idx (B, k),
    guard (B, 1) i32), equal to knn_quant_scan's."""
    k_extra = QUANT_EXTRA if k_extra is None else k_extra
    slab = X_q.shape[0] // q_scale.shape[0]
    rows = torch.arange(X_q.shape[0], device=xq.device)
    d2q = quant_d2_tile(xq, X_q, q_scale[rows // slab, 0], y2_q[:, 0],
                        mode=mode)
    order = torch.sort(d2q, dim=-1, stable=True).indices[:, :k + k_extra]
    return _quant_flush(xq, X_q, q_scale, y2_q, torch.gather(d2q, 1, order),
                        order, k, mode)


def knn_quant_lambda_ref(xq, X_q, q_scale, y2_q, lam_db, k: int, *,
                         k_extra: int | None = None, mode: str = "int8"):
    """lambda-hat (B, K) and guard (B, 1) through knn_quant_select_ref
    (counterpart of the JAX oracle of the same name)."""
    d2, idx, guard = knn_quant_select_ref(xq, X_q, q_scale, y2_q, k,
                                          k_extra=k_extra, mode=mode)
    return quant_idw(xq, X_q, y2_q, lam_db, d2, idx), guard


def knn_lambda_quant_ref(xq, X_q, q_scale, y2_q, lam_db, k: int, *,
                         k_extra: int = QUANT_EXTRA, mode: str = "int8"):
    """The plain version of the knn_lambda_quant kernel: lambda-hat
    (B, K_pred) and guard (B, 1) i32 through the chunked quantized scan
    (core.predictors.knn_quant_scan), in the kernel's rounding order."""
    d2, idx, guard = knn_quant_scan(X_q, q_scale, y2_q, xq, k=k,
                                    k_extra=k_extra, mode=mode,
                                    device=xq.device)
    return quant_idw(xq, X_q, y2_q, lam_db, d2, idx), guard


def knn_rank_audited_quant_ref(X, X_q, q_scale, y2_q, lam_db, u, a, b,
                               gamma, *, k: int, mode: str, m2: int,
                               k_extra: int = QUANT_EXTRA,
                               eps: float = 1e-4, tol: float | None = None):
    """The plain version of the knn_rank_audited_quant kernel:
    knn_lambda_quant_ref's lambda-hat zero-padded to a's constraint
    rows, then rank_audited_ref. Returns the five rank_audited_ref
    outputs, lam (n, K) and guard (n, 1) i32."""
    check_pred_width(lam_db.shape[1], a.shape[1])
    lam, guard = knn_lambda_quant_ref(X, X_q, q_scale, y2_q, lam_db, k,
                                      k_extra=k_extra, mode=mode)
    lam = torch.nn.functional.pad(lam, (0, a.shape[1] - lam.shape[1]))
    return (*rank_audited_ref(u, a, b, lam, gamma, m2, eps, tol), lam,
            guard)


def affine_lambda_ref(X, W, c, relu: bool):
    """lam_hat = X W^T + c (n, K), the dot over d taken coordinate by
    coordinate with every product and addition rounded on its own (the
    kernel's prologue order), then + c, then the clamp at 0 if `relu`."""
    lam = dot_seq(X[:, None, :], W[None, :, :]) + c
    return torch.clamp_min(lam, 0.0) if relu else lam


def linear_rank_audited_ref(u, a, b, X, W, c, gamma, m2: int,
                            eps: float = 1e-4, tol: float | None = None,
                            relu: bool = True):
    """The affine online stage: lam_hat from affine_lambda_ref with X
    (n, d), W (K, d), c (K,), then rank_audited_ref. Returns the five
    rank_audited_ref outputs plus lam (n, K)."""
    lam = affine_lambda_ref(X, W, c, relu)
    return (*rank_audited_ref(u, a, b, lam, gamma, m2, eps, tol), lam)


def affine_params(predictor, d: int, K: int):
    """(W (K, d), c (K,), relu) of an affine predictor, zero-padded to K
    constraint rows so padded rows get lam_hat = 0: the linear family
    as it is (relu on), the mean family as W = 0, c = mean_lam (relu
    off, so a negative mean stays negative)."""
    if isinstance(predictor, LinearLambdaPredictor):
        W, c, relu = predictor.W, predictor.c, True
        if W.shape[1] != d:
            raise ValueError(f"predictor takes d={W.shape[1]} covariates, "
                             f"X carries {d}")
    elif isinstance(predictor, MeanLambdaPredictor):
        c, relu = predictor.mean_lam, False
        W = torch.zeros((c.shape[0], d), dtype=torch.float32,
                        device=c.device)
    else:
        raise TypeError(f"{type(predictor).__name__} is not affine")
    check_pred_width(W.shape[0], K)
    pad = K - W.shape[0]
    W = torch.nn.functional.pad(W.to(torch.float32), (0, 0, 0, pad))
    c = torch.nn.functional.pad(c.to(torch.float32), (0, pad))
    return W.contiguous(), c.contiguous(), relu


def predict_rank_audited_ref(X, predictor, u, a, b, gamma, m2: int,
                             eps: float = 1e-4, tol: float | None = None):
    """Predict-then-rank+audit for every family, each lambda-hat from
    the plain version of its kernel's arithmetic (mean and linear: the
    affine prologue; KNN: the sweep's order; the MLP and any other
    family: its own predict, zero-padded to a's K, then
    rank_audited_ref). Returns (vals, idx, utility, exposure, compliant,
    lam); a quantized KNN predictor takes the quantized plain version
    (its guard is dropped)."""
    if isinstance(predictor, KNNLambdaPredictor) and predictor.X_q is not None:
        return knn_rank_audited_quant_ref(
            X, predictor.X_q, predictor.q_scale, predictor.y2_q,
            predictor.lam_db, u, a, b, gamma, k=predictor.k,
            mode=predictor.quant, m2=m2, eps=eps, tol=tol)[:6]
    if isinstance(predictor, KNNLambdaPredictor):
        return knn_rank_audited_ref(X, predictor.X_db, predictor.lam_db, u,
                                    a, b, gamma, k=predictor.k, m2=m2,
                                    eps=eps, tol=tol)
    if isinstance(predictor, (LinearLambdaPredictor, MeanLambdaPredictor)):
        W, c, relu = affine_params(predictor, X.shape[1], a.shape[1])
        return linear_rank_audited_ref(u, a, b, X, W, c, gamma, m2, eps,
                                       tol, relu)
    lam = predicted_lambda(predictor, X, a.shape[1])
    return (*rank_audited_ref(u, a, b, lam, gamma, m2, eps, tol), lam)


def predicted_lambda(predictor, X, K: int) -> torch.Tensor:
    """lambda-hat of the MLP route: predictor.predict(X) in f32,
    zero-padded from the predictor's width to K constraint rows."""
    lam = predictor.predict(X).to(torch.float32)
    check_pred_width(lam.shape[-1], K)
    return torch.nn.functional.pad(lam, (0, K - lam.shape[-1]))


def embedding_bag_ref(table, indices, weights=None):
    """Sum-mode EmbeddingBag: table (V, D) f32 or bf16, indices
    (n_bags, bag) with entries < 0 padding, weights (n_bags, bag) f32 or
    None (ones) -> (n_bags, D) in table.dtype, out[i] = sum_j w[i,j] *
    table[indices[i,j]]. Accumulates in f32 slot by slot, acc + row * w
    with each product and sum rounded on its own, and casts once at the
    end: the embedding_bag kernel's order. A padded slot adds nothing
    (the JAX oracle adds 0 * table[0]; the two differ only where
    table[0] holds an inf or a NaN). An index >= V reads row V - 1, as
    the JAX oracle's clamped gather does."""
    valid = indices >= 0
    rows = table[indices.clamp(0, table.shape[0] - 1).long()].to(
        torch.float32)
    acc = torch.zeros((indices.shape[0], table.shape[1]),
                      dtype=torch.float32, device=table.device)
    for j in range(indices.shape[1]):
        r = rows[:, j] if weights is None else rows[:, j] * weights[:, j, None]
        acc = torch.where(valid[:, j, None], acc + r, acc)
    return acc.to(table.dtype)
