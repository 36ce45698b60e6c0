"""The KNN kernels' wrappers (counterparts of
repro.kernels.knn_topk.knn_rank_audited_pallas, knn_lambda_pallas and
their quantized twins), beside their plain versions.

Each kernel is two launches: a distance sweep split across blocks by
query tile and db chunk, then one block per query that merges the
partial top-k lists and weights lambda-hat. knn_rank_audited
(csrc/knn_rank_audited.cu) then ranks and audits the row; knn_lambda
(csrc/knn_lambda.cu) writes lambda-hat only; both share
csrc/knn_sweep.cuh. knn_rank_audited_quant and knn_lambda_quant are the
same pair over the int8 or bf16 packed db (csrc/knn_quant_sweep.cuh):
the sweep keeps k + k_extra survivors, which the merge re-scores
exactly in f32, re-ranks to k and flags with the margin guard. On a CPU
tensor a wrapper runs the plain version (`ref.knn_rank_audited_ref`,
`ref.knn_lambda_ref`, `ref.knn_rank_audited_quant_ref`,
`ref.knn_lambda_quant_ref`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.predictors import check_pack
from repro_torch.core.ranking import AUDIT_TOL
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.common import (
    KNN_CHUNK,
    KNN_MAX_D,
    KNN_MAX_K,
    KNN_QTILE,
    KNN_QUANT_MAX_KEEP,
    MAX_KERNEL_K,
    QUANT_EXTRA,
    check_tensor,
)
from repro_torch.kernels.fused_rank import check_rank_args, sort_width
from repro_torch.kernels.ref import (
    check_pred_width,
    knn_lambda_quant_ref,
    knn_lambda_ref,
    knn_rank_audited_quant_ref,
    knn_rank_audited_ref,
)

__all__ = ["knn_lambda_cuda", "knn_lambda_quant_cuda", "knn_lambda_ref",
           "knn_lambda_quant_ref", "knn_rank_audited_cuda",
           "knn_rank_audited_quant_cuda", "knn_rank_audited_quant_ref",
           "knn_rank_audited_ref", "quant_sweep_tile", "sweep_tile"]

_SMEM_FLOATS = 48 * 1024 // 4  # static shared-memory limit of one block
_QUANT_SMEM_FLOATS = 96 * 1024 // 4  # the quantized sweep's dynamic budget
_KNN_SUB = 8                    # threads per query in the distance sweep


def sweep_tile(D: int, k: int) -> int:
    """Database rows per shared-memory tile of the distance sweep: as
    many as fit (up to 256) beside the query tile, in multiples of 8."""
    budget = _SMEM_FLOATS - KNN_QTILE * (D + 1)
    if KNN_QTILE * _KNN_SUB * k * 2 > budget:
        raise ValueError(f"d={D}, k={k}: the sweep's tiles exceed one "
                         f"block's shared memory")
    st = min(256, budget // (D + 1)) // 8 * 8
    if st < 8:
        raise ValueError(f"d={D} leaves no room for a db tile")
    return st


def _check_sweep(xq, xdb, lam_db, k: int, dev: torch.device):
    """Validate the KNN sweep's inputs; returns (B, N, D, K_pred, st,
    n_chunks), the tile and grid only on the card."""
    N, D = xdb.shape
    B, k_pred = xq.shape[0], lam_db.shape[1]
    if not 1 <= k <= min(N, KNN_MAX_K):
        raise ValueError(f"the kernel needs 1 <= k <= min(n_train, "
                         f"{KNN_MAX_K}), got k={k}, n_train={N}")
    if D > KNN_MAX_D:
        raise ValueError(f"the kernel takes d <= {KNN_MAX_D}, got {D}")
    f32 = torch.float32
    check_tensor("xq", xq, (B, D), f32, dev)
    check_tensor("xdb", xdb, (N, D), f32, dev)
    check_tensor("lam_db", lam_db, (N, k_pred), f32, dev)
    if dev.type == "cpu":
        return B, N, D, k_pred, 0, 0
    n_chunks = -(-N // KNN_CHUNK)
    if n_chunks > 65535:                 # the sweep grid's y extent
        raise ValueError(f"n_train={N} exceeds {65535 * KNN_CHUNK} rows")
    return B, N, D, k_pred, sweep_tile(D, k), n_chunks


def knn_lambda_cuda(xq, xdb, lam_db, *, k: int = 10, device=None):
    """KNN lambda-hat: xq (B, D), xdb (N, D), lam_db (N, K_pred), all f32
    and contiguous on `device` (None = the card) -> lam (B, K_pred). Two
    launches per call; each adds one to `knn_lambda_cuda.launches`."""
    dev = resolve_device(device)
    B, N, D, k_pred, st, n_chunks = _check_sweep(xq, xdb, lam_db, k, dev)
    if not 1 <= k_pred <= MAX_KERNEL_K:
        raise ValueError(f"the kernel takes 1 <= K_pred <= {MAX_KERNEL_K}, "
                         f"got {k_pred}")
    if dev.type == "cpu":
        return knn_lambda_ref(xq, xdb, lam_db, k)
    f32 = torch.float32
    ws_d2 = torch.empty((B, n_chunks, k), dtype=f32, device=dev)
    ws_idx = torch.empty((B, n_chunks, k), dtype=torch.int32, device=dev)
    lam = torch.empty((B, k_pred), dtype=f32, device=dev)
    if B:
        build.launch(
            "knn_lambda", xq.data_ptr(), xdb.data_ptr(), lam_db.data_ptr(),
            ws_d2.data_ptr(), ws_idx.data_ptr(), lam.data_ptr(), B, N, D, k,
            k_pred, KNN_CHUNK, st, n_chunks,
            torch.cuda.current_stream(dev).cuda_stream)
        knn_lambda_cuda.launches += 2
    return lam


knn_lambda_cuda.launches = 0


def knn_rank_audited_cuda(xq, xdb, lam_db, u, a, b, gamma, *, k: int = 10,
                          m2: int, eps: float = 1e-4,
                          tol: float | None = None, device=None):
    """The KNN online stage: xq (B, D), xdb (N, D), lam_db (N, K_pred)
    with K_pred <= K, then the rank inputs u (B, m1), a (B, K, m1),
    b (B, K), gamma (B, m2), all f32 and contiguous on `device` (None =
    the card). Returns (vals, idx int32, utility, exposure, compliant
    bool, lam (B, K)); lambda-hat's columns beyond K_pred are 0. Two
    launches per call; each adds one to `knn_rank_audited_cuda.launches`.
    """
    dev = resolve_device(device)
    tol = AUDIT_TOL if tol is None else tol
    B, m1, K = check_rank_args(u, a, b, None, gamma, m2, dev)
    if xq.shape[0] != B:
        raise ValueError(f"xq carries {xq.shape[0]} rows, the problem {B}")
    _, N, D, k_pred, st, n_chunks = _check_sweep(xq, xdb, lam_db, k, dev)
    check_pred_width(k_pred, K)
    if dev.type == "cpu":
        return knn_rank_audited_ref(xq, xdb, lam_db, u, a, b, gamma, k=k,
                                    m2=m2, eps=eps, tol=tol)
    f32 = torch.float32
    ws_d2 = torch.empty((B, n_chunks, k), dtype=f32, device=dev)
    ws_idx = torch.empty((B, n_chunks, k), dtype=torch.int32, device=dev)
    vals = torch.empty((B, m2), dtype=f32, device=dev)
    idx = torch.empty((B, m2), dtype=torch.int32, device=dev)
    util = torch.empty((B,), dtype=f32, device=dev)
    expo = torch.empty((B, K), dtype=f32, device=dev)
    comp = torch.empty((B,), dtype=torch.int32, device=dev)
    lam = torch.empty((B, K), dtype=f32, device=dev)
    if B:
        build.launch(
            "knn_rank_audited", xq.data_ptr(), xdb.data_ptr(),
            lam_db.data_ptr(), u.data_ptr(), a.data_ptr(), b.data_ptr(),
            gamma.data_ptr(), ws_d2.data_ptr(), ws_idx.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), util.data_ptr(),
            expo.data_ptr(), comp.data_ptr(), lam.data_ptr(), B, N, D, k,
            k_pred, m1, K, m2, sort_width(m1, m2), KNN_CHUNK, st, n_chunks,
            float(np.float32(1.0 + eps)), float(tol),
            torch.cuda.current_stream(dev).cuda_stream)
        knn_rank_audited_cuda.launches += 2
    return vals, idx, util, expo, comp != 0, lam


knn_rank_audited_cuda.launches = 0


def quant_sweep_tile(D: int, k_keep: int, mode: str) -> int:
    """Database rows per shared-memory tile of the quantized sweep: as
    many as fit (up to 256) beside the query tile, in multiples of 8.
    An int8 row takes ceil(D/4) words plus its y2 and scale, a bf16 row
    D floats (widened) plus its y2; the tile's region later holds the
    KNN_QTILE * 8 survivor lists of k_keep pairs."""
    words = (D + 3) // 4
    budget = _QUANT_SMEM_FLOATS - KNN_QTILE * (D + 2 + words)
    if KNN_QTILE * _KNN_SUB * k_keep * 2 > budget:
        raise ValueError(f"d={D}, k_keep={k_keep}: the quantized sweep's "
                         f"lists exceed its shared memory")
    per_row = words + 2 if mode == "int8" else D + 1
    st = min(256, budget // per_row) // 8 * 8
    if st < 8:
        raise ValueError(f"d={D} leaves no room for a db tile")
    return st


def _check_quant_sweep(xq, X_q, q_scale, y2_q, lam_db, k: int,
                       k_extra: int, mode: str, dev: torch.device):
    """Validate the quantized sweep's inputs; returns (B, n_pad, n_train,
    D, K_pred, slab, st, n_chunks), the tile and grid only on the card."""
    n_pad, D = X_q.shape
    B, (n_train, k_pred) = xq.shape[0], lam_db.shape
    slab = check_pack(X_q, q_scale, y2_q, mode, n_train=n_train)
    k_keep = k + k_extra
    if not 1 <= k <= min(n_train, KNN_MAX_K) or k_extra < 1 \
            or k_keep > min(n_pad, KNN_QUANT_MAX_KEEP):
        raise ValueError(
            f"the kernel needs 1 <= k <= min(n_train, {KNN_MAX_K}), "
            f"k_extra >= 1 and k + k_extra <= min(n_pad, "
            f"{KNN_QUANT_MAX_KEEP}), got k={k}, k_extra={k_extra}, "
            f"n_train={n_train}, n_pad={n_pad}")
    if D > KNN_MAX_D:
        raise ValueError(f"the kernel takes d <= {KNN_MAX_D}, got {D}")
    f32 = torch.float32
    check_tensor("xq", xq, (B, D), f32, dev)
    check_tensor("X_q", X_q, (n_pad, D), X_q.dtype, dev)
    check_tensor("q_scale", q_scale, tuple(q_scale.shape), f32, dev)
    check_tensor("y2_q", y2_q, (n_pad, 1), f32, dev)
    check_tensor("lam_db", lam_db, (n_train, k_pred), f32, dev)
    if dev.type == "cpu":
        return B, n_pad, n_train, D, k_pred, slab, 0, 0
    n_chunks = -(-n_pad // KNN_CHUNK)
    if n_chunks > 65535:                 # the sweep grid's y extent
        raise ValueError(f"n_pad={n_pad} exceeds {65535 * KNN_CHUNK} rows")
    return (B, n_pad, n_train, D, k_pred, slab,
            quant_sweep_tile(D, k_keep, mode), n_chunks)


def knn_lambda_quant_cuda(xq, X_q, q_scale, y2_q, lam_db, *, k: int = 10,
                          k_extra: int = QUANT_EXTRA, mode: str,
                          device=None):
    """Quantized KNN lambda-hat: xq (B, D) f32, the pack X_q (n_pad, D)
    int8 or bf16 (`mode`), q_scale (n_slabs, 1), y2_q (n_pad, 1) and
    lam_db (n_train, K_pred), contiguous on `device` (None = the card)
    -> (lam (B, K_pred), guard (B, 1) int32). Two launches per call;
    each adds one to `knn_lambda_quant_cuda.launches`."""
    dev = resolve_device(device)
    B, n_pad, n_train, D, k_pred, slab, st, n_chunks = _check_quant_sweep(
        xq, X_q, q_scale, y2_q, lam_db, k, k_extra, mode, dev)
    if not 1 <= k_pred <= MAX_KERNEL_K:
        raise ValueError(f"the kernel takes 1 <= K_pred <= {MAX_KERNEL_K}, "
                         f"got {k_pred}")
    if dev.type == "cpu":
        return knn_lambda_quant_ref(xq, X_q, q_scale, y2_q, lam_db, k,
                                    k_extra=k_extra, mode=mode)
    kk = k + k_extra
    ws_d2 = torch.empty((B, n_chunks, kk), dtype=torch.float32, device=dev)
    ws_idx = torch.empty((B, n_chunks, kk), dtype=torch.int32, device=dev)
    lam = torch.empty((B, k_pred), dtype=torch.float32, device=dev)
    guard = torch.empty((B, 1), dtype=torch.int32, device=dev)
    if B:
        build.launch(
            "knn_lambda_quant", xq.data_ptr(), X_q.data_ptr(),
            q_scale.data_ptr(), y2_q.data_ptr(), lam_db.data_ptr(),
            ws_d2.data_ptr(), ws_idx.data_ptr(), lam.data_ptr(),
            guard.data_ptr(), B, n_pad, n_train, D, k, kk, k_pred, slab,
            int(mode == "int8"), KNN_CHUNK, st, n_chunks,
            torch.cuda.current_stream(dev).cuda_stream)
        knn_lambda_quant_cuda.launches += 2
    return lam, guard


knn_lambda_quant_cuda.launches = 0


def knn_rank_audited_quant_cuda(xq, X_q, q_scale, y2_q, lam_db, u, a, b,
                                gamma, *, k: int = 10,
                                k_extra: int = QUANT_EXTRA, mode: str,
                                m2: int, eps: float = 1e-4,
                                tol: float | None = None, device=None):
    """The KNN online stage over the quantized db: the pack and lam_db
    as in knn_lambda_quant_cuda (K_pred <= K), then the rank inputs u
    (B, m1), a (B, K, m1), b (B, K), gamma (B, m2), all contiguous on
    `device` (None = the card). Returns (vals, idx int32, utility,
    exposure, compliant bool, lam (B, K), guard (B, 1) int32);
    lambda-hat's columns beyond K_pred are 0. Two launches per call;
    each adds one to `knn_rank_audited_quant_cuda.launches`."""
    dev = resolve_device(device)
    tol = AUDIT_TOL if tol is None else tol
    B, m1, K = check_rank_args(u, a, b, None, gamma, m2, dev)
    if xq.shape[0] != B:
        raise ValueError(f"xq carries {xq.shape[0]} rows, the problem {B}")
    _, n_pad, n_train, D, k_pred, slab, st, n_chunks = _check_quant_sweep(
        xq, X_q, q_scale, y2_q, lam_db, k, k_extra, mode, dev)
    check_pred_width(k_pred, K)
    if dev.type == "cpu":
        return knn_rank_audited_quant_ref(
            xq, X_q, q_scale, y2_q, lam_db, u, a, b, gamma, k=k, mode=mode,
            m2=m2, k_extra=k_extra, eps=eps, tol=tol)
    f32 = torch.float32
    kk = k + k_extra
    ws_d2 = torch.empty((B, n_chunks, kk), dtype=f32, device=dev)
    ws_idx = torch.empty((B, n_chunks, kk), dtype=torch.int32, device=dev)
    vals = torch.empty((B, m2), dtype=f32, device=dev)
    idx = torch.empty((B, m2), dtype=torch.int32, device=dev)
    util = torch.empty((B,), dtype=f32, device=dev)
    expo = torch.empty((B, K), dtype=f32, device=dev)
    comp = torch.empty((B,), dtype=torch.int32, device=dev)
    lam = torch.empty((B, K), dtype=f32, device=dev)
    guard = torch.empty((B, 1), dtype=torch.int32, device=dev)
    if B:
        build.launch(
            "knn_rank_audited_quant", xq.data_ptr(), X_q.data_ptr(),
            q_scale.data_ptr(), y2_q.data_ptr(), lam_db.data_ptr(),
            u.data_ptr(), a.data_ptr(), b.data_ptr(), gamma.data_ptr(),
            ws_d2.data_ptr(), ws_idx.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), util.data_ptr(), expo.data_ptr(),
            comp.data_ptr(), lam.data_ptr(), guard.data_ptr(), B, n_pad,
            n_train, D, k, kk, k_pred, slab, int(mode == "int8"), m1, K, m2,
            sort_width(m1, m2), KNN_CHUNK, st, n_chunks,
            float(np.float32(1.0 + eps)), float(tol),
            torch.cuda.current_stream(dev).cuda_stream)
        knn_rank_audited_quant_cuda.launches += 2
    return vals, idx, util, expo, comp != 0, lam, guard


knn_rank_audited_quant_cuda.launches = 0
