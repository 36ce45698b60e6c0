"""The KNN online-stage kernel's wrapper (counterpart of
repro.kernels.knn_topk.knn_rank_audited_pallas), beside its plain
version.

The kernel (csrc/knn_rank_audited.cu) is two launches: a distance sweep
split across blocks by query tile and db chunk, then one block per
query that merges the partial top-k lists, weights lambda-hat and ranks
the row. On a CPU tensor the wrapper runs the plain version,
`ref.knn_rank_audited_ref`.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ranking import AUDIT_TOL
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.common import (
    KNN_CHUNK,
    KNN_MAX_D,
    KNN_MAX_K,
    KNN_QTILE,
    check_tensor,
)
from repro_torch.kernels.fused_rank import check_rank_args, sort_width
from repro_torch.kernels.ref import check_pred_width, knn_rank_audited_ref

__all__ = ["knn_rank_audited_cuda", "knn_rank_audited_ref", "sweep_tile"]

_SMEM_FLOATS = 48 * 1024 // 4  # static shared-memory limit of one block
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
    N, D = xdb.shape
    k_pred = lam_db.shape[1]
    check_pred_width(k_pred, K)
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
        return knn_rank_audited_ref(xq, xdb, lam_db, u, a, b, gamma, k=k,
                                    m2=m2, eps=eps, tol=tol)
    st = sweep_tile(D, k)
    n_chunks = -(-N // KNN_CHUNK)
    if n_chunks > 65535:                 # the sweep grid's y extent
        raise ValueError(f"n_train={N} exceeds {65535 * KNN_CHUNK} rows")
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
