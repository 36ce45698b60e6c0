"""The KNN kernels' wrappers (counterparts of
repro.kernels.knn_topk.knn_topk_pallas, knn_rank_audited_pallas,
knn_lambda_pallas and the quantized twins of the last two), beside their
plain versions.

Each kernel is two launches: a distance sweep split across blocks by
query tile and db chunk, then one block per query that merges the
partial top-k lists. knn_topk (csrc/knn_topk.cu) writes the merged
(d2, idx); knn_lambda (csrc/knn_lambda.cu) weights lambda-hat and
writes it; knn_rank_audited (csrc/knn_rank_audited.cu) weights it, then
ranks and audits the row; all three share csrc/knn_sweep.cuh.
knn_rank_audited_quant and knn_lambda_quant are the last two over the
int8 or bf16 packed db (csrc/knn_quant_sweep.cuh): the sweep keeps
k + k_extra survivors, which the merge re-scores exactly in f32,
re-ranks to k and flags with the margin guard. On a CPU tensor a
wrapper runs the plain version (`ref.knn_topk_ref`,
`ref.knn_rank_audited_ref`, `ref.knn_lambda_ref`,
`ref.knn_rank_audited_quant_ref`, `ref.knn_lambda_quant_ref`), which
takes any k and d. On the card the shapes a sweep takes, and its tile,
chunk and list length, come from one pure function per sweep:
`sweep_geometry` (f32: k <= KNN_MAX_K = 256, any d whose resident
queries leave a ring of 32-row pieces of 32 coordinates in
KNN_SMEM_BYTES: d <= 1629 at k <= 32, 1181 at k = 256) and
`quant_sweep_geometry` (a pack: k + k_extra <= KNN_QUANT_MAX_KEEP =
256, any d whose tiles leave 32 rows: d <= 2252 int8, 844 bf16 at 18
survivors); past them a ValueError names the ROADMAP item that would
lift the limit. Both sweeps keep a query's running list spread over a
warp's lanes (csrc/knn_select.cuh), so their merges run one routine.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.predictors import check_pack
from repro_torch.core.ranking import AUDIT_TOL
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.common import (
    KNN_MAX_K,
    KNN_QTILE,
    KNN_QUANT_MAX_KEEP,
    KNN_SMEM_BYTES,
    QUANT_EXTRA,
    check_tensor,
)
from repro_torch.kernels.fused_rank import (
    check_rank_args,
    check_rank_kernel,
    rank_split,
)
from repro_torch.kernels.ref import (
    check_pred_width,
    knn_lambda_quant_ref,
    knn_lambda_ref,
    knn_rank_audited_quant_ref,
    knn_rank_audited_ref,
    knn_topk_ref,
)

__all__ = ["knn_lambda_cuda", "knn_lambda_quant_cuda", "knn_lambda_ref",
           "knn_lambda_quant_ref", "knn_rank_audited_cuda",
           "knn_rank_audited_quant_cuda", "knn_rank_audited_quant_ref",
           "knn_rank_audited_ref", "knn_topk_cuda", "knn_topk_ref",
           "SweepGeometry", "quant_sweep_geometry", "sweep_geometry"]

_SHAPE_LIMIT = "(lifting it is ROADMAP Queue 2 item 7)"
_SWEEP_BLOCKS_PER_SM = 4        # sweep blocks an SM holds at k <= 32
_MIN_PIECE = 32                 # coordinates a piece of a wide row holds
H100_SMS = 132


class SweepGeometry(NamedTuple):
    """A KNN sweep's shape on the card (launch A / A')."""
    tile: int         # db rows per shared-memory tile (a multiple of 32)
    chunk: int        # db rows per block (a multiple of the tile)
    n_chunks: int     # blocks along the db: the grid's y extent
    list_len: int     # pairs of a query's running list (>= k or k_keep)
    smem_bytes: int   # dynamic shared memory of one sweep block
    piece: int        # coordinates of a row a tile holds (d: whole rows)


def _list_len(k_keep: int) -> int:
    """A warp list's length: 32, 64, 128 or 256 pairs (knn_select.cuh's
    list_rl)."""
    return 32 * (1 if k_keep <= 32 else 2 if k_keep <= 64
                 else 4 if k_keep <= 128 else 8)


def _chunking(B: int, N: int, tile: int, n_sm: int) -> tuple[int, int]:
    """(chunk, n_chunks): a chunk, a multiple of the tile, that gives the
    card about _SWEEP_BLOCKS_PER_SM blocks on each of its n_sm SMs over
    the batch's query tiles of 32."""
    q_tiles = max(1, -(-B // KNN_QTILE))
    per_tile = max(1, _SWEEP_BLOCKS_PER_SM * n_sm // q_tiles)
    chunk = -(-max(1, -(-N // per_tile)) // tile) * tile
    return chunk, -(-N // chunk)


def sweep_geometry(B: int, N: int, D: int, k: int,
                   n_sm: int = H100_SMS) -> SweepGeometry:
    """The f32 sweep (csrc/knn_sweep.cuh) for B queries over N db rows
    of width D keeping k neighbours: a list of L = 32, 64, 128 or 256
    pairs a query; the block's 32 queries, their |q|^2 and a stage of L
    pairs each resident in KNN_SMEM_BYTES, beside a two-slot ring of
    tiles at the odd row stride piece | 1 (sweep_smem): whole rows in
    tiles of up to 256 rows, in multiples of 32, where 32 of them fit,
    else 32-row tiles of the widest piece of d that fits (at least
    _MIN_PIECE coordinates); a chunk as in quant_sweep_geometry. Raises
    past the kernel's limits."""
    if not 1 <= k <= KNN_MAX_K:
        raise ValueError(f"the f32 KNN kernel keeps 1 <= k <= {KNN_MAX_K} "
                         f"neighbours, got k={k} {_SHAPE_LIMIT}")
    L = _list_len(k)
    fixed = KNN_QTILE * (D + 1 + 2 * L)
    avail = KNN_SMEM_BYTES // 4 - fixed
    if avail >= 2 * 32 * (D | 1):
        piece = D
        tile = min(256, avail // (2 * (D | 1)) // 32 * 32)
    else:
        tile, piece = 32, (avail // 64 - 1) | 1
        if piece < _MIN_PIECE:
            raise ValueError(f"d={D}, k={k}: the f32 KNN sweep's resident "
                             f"queries leave no 32-row tiles of "
                             f"{_MIN_PIECE} coordinates in {KNN_SMEM_BYTES} "
                             f"bytes of shared memory {_SHAPE_LIMIT}")
    chunk, n_chunks = _chunking(B, N, tile, n_sm)
    return SweepGeometry(tile, chunk, n_chunks, L,
                         4 * (fixed + 2 * tile * (piece | 1)), piece)


def quant_merge_floats(D: int, k: int, k_keep: int) -> int:
    """Floats of shared memory the quantized merge needs beside nw and
    ni (knn_quant_sweep.cuh's quant_merge_floats): a stage and a list of
    L pairs for each of its 8 warps, then the survivors' and winners'
    rows and the query."""
    L = _list_len(k_keep)
    return 4 * 8 * L + 5 * k_keep + 2 * k + 2 * D + 1


def quant_sweep_geometry(B: int, N: int, D: int, k: int, k_extra: int,
                         mode: str, n_sm: int = H100_SMS) -> SweepGeometry:
    """The quantized sweep (csrc/knn_quant_sweep.cuh) for B queries over
    a pack of N rows of width D in `mode`, keeping k_keep = k + k_extra
    survivors: a list of L = 32, 64, 128 or 256 pairs a query; tiles of
    up to 256 rows, in multiples of 32, such that two of them, the
    query operands and a stage of L pairs a query fit KNN_SMEM_BYTES;
    a chunk (a multiple of the tile) that gives the card about
    _SWEEP_BLOCKS_PER_SM blocks on each of its n_sm SMs. Raises past
    the kernel's limits."""
    k_keep = k + k_extra
    if k_keep > KNN_QUANT_MAX_KEEP:
        raise ValueError(f"the quantized KNN kernel keeps k + k_extra <= "
                         f"{KNN_QUANT_MAX_KEEP} survivors, got k={k}, "
                         f"k_extra={k_extra} {_SHAPE_LIMIT}")
    int8 = mode == "int8"
    L = _list_len(k_keep)
    words = (D + 3) // 4 if int8 else (D + 1) // 2
    fixed = KNN_QTILE * (words * (1 if int8 else 2) + 2 + 2 * L)
    per_row = 2 * (words | 1) + 4
    st = max(0, min(256, (KNN_SMEM_BYTES // 4 - fixed) // per_row)
             // 32 * 32)
    merge = 2 * k + quant_merge_floats(D, k, k_keep)
    if st < 32 or 4 * merge > KNN_SMEM_BYTES:
        raise ValueError(f"d={D}: the quantized KNN sweep's tiles exceed "
                         f"{KNN_SMEM_BYTES} bytes of shared memory "
                         f"{_SHAPE_LIMIT}")
    chunk, n_chunks = _chunking(B, N, st, n_sm)
    return SweepGeometry(st, chunk, n_chunks, L, 4 * (fixed + per_row * st),
                         D)


def _check_sweep(xq, xdb, k: int, dev: torch.device):
    """Validate the f32 KNN sweep's inputs; returns (B, N, D, geometry),
    the geometry (None on the CPU) only on the card, where the kernel's
    own limits on k and d are checked too."""
    N, D = xdb.shape
    B = xq.shape[0]
    if not 1 <= k <= N:
        raise ValueError(f"need 1 <= k <= n_train, got k={k}, n_train={N}")
    check_tensor("xq", xq, (B, D), torch.float32, dev)
    check_tensor("xdb", xdb, (N, D), torch.float32, dev)
    if dev.type == "cpu":
        return B, N, D, None
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return B, N, D, sweep_geometry(B, N, D, k, n_sm)


def _check_lam_db(lam_db, N: int, dev: torch.device) -> int:
    """Validate the db's lambda rows (N, K_pred); returns K_pred."""
    k_pred = lam_db.shape[1]
    check_tensor("lam_db", lam_db, (N, k_pred), torch.float32, dev)
    return k_pred


def _workspace(B: int, n_chunks: int, k: int, dev: torch.device):
    """The sweep's (B, n_chunks, k) partial lists: d2 f32, idx int32."""
    return (torch.empty((B, n_chunks, k), dtype=torch.float32, device=dev),
            torch.empty((B, n_chunks, k), dtype=torch.int32, device=dev))


def knn_topk_cuda(xq, xdb, *, k: int = 10, device=None):
    """The k nearest db rows of each query under squared L2: xq (B, D),
    xdb (N, D), f32 or bf16 (a bf16 operand is widened to f32 first, as
    the TPU kernel widens each tile), contiguous on `device` (None = the
    card) -> (d2 (B, k) ascending f32, idx (B, k) int32), ties to the
    lower index. Two launches per call; each adds one to
    `knn_topk_cuda.launches`."""
    dev = resolve_device(device)
    xq, xdb = (x.float() if x.dtype == torch.bfloat16 else x
               for x in (xq, xdb))
    B, N, D, g = _check_sweep(xq, xdb, k, dev)
    if dev.type == "cpu":
        return knn_topk_ref(xq, xdb, k)
    ws_d2, ws_idx = _workspace(B, g.n_chunks, k, dev)
    d2 = torch.empty((B, k), dtype=torch.float32, device=dev)
    idx = torch.empty((B, k), dtype=torch.int32, device=dev)
    if B:
        build.launch(
            "knn_topk", xq.data_ptr(), xdb.data_ptr(), ws_d2.data_ptr(),
            ws_idx.data_ptr(), d2.data_ptr(), idx.data_ptr(), B, N, D, k,
            g.chunk, g.tile, g.piece, g.n_chunks,
            torch.cuda.current_stream(dev).cuda_stream)
        knn_topk_cuda.launches += 2
    return d2, idx


knn_topk_cuda.launches = 0


def knn_lambda_cuda(xq, xdb, lam_db, *, k: int = 10, device=None):
    """KNN lambda-hat: xq (B, D), xdb (N, D), lam_db (N, K_pred), all f32
    and contiguous on `device` (None = the card) -> lam (B, K_pred). Two
    launches per call; each adds one to `knn_lambda_cuda.launches`."""
    dev = resolve_device(device)
    B, N, D, g = _check_sweep(xq, xdb, k, dev)
    k_pred = _check_lam_db(lam_db, N, dev)
    if dev.type == "cpu":
        return knn_lambda_ref(xq, xdb, lam_db, k)
    ws_d2, ws_idx = _workspace(B, g.n_chunks, k, dev)
    lam = torch.empty((B, k_pred), dtype=torch.float32, device=dev)
    if B:
        build.launch(
            "knn_lambda", xq.data_ptr(), xdb.data_ptr(), lam_db.data_ptr(),
            ws_d2.data_ptr(), ws_idx.data_ptr(), lam.data_ptr(), B, N, D, k,
            k_pred, g.chunk, g.tile, g.piece, g.n_chunks,
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
    _, N, D, g = _check_sweep(xq, xdb, k, dev)
    k_pred = _check_lam_db(lam_db, N, dev)
    check_pred_width(k_pred, K)
    if dev.type == "cpu":
        return knn_rank_audited_ref(xq, xdb, lam_db, u, a, b, gamma, k=k,
                                    m2=m2, eps=eps, tol=tol)
    check_rank_kernel(K, m2)
    f32 = torch.float32
    ws_d2, ws_idx = _workspace(B, g.n_chunks, k, dev)
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
            k_pred, m1, K, m2, rank_split(B, m1, dev), g.chunk, g.tile,
            g.piece, g.n_chunks, float(np.float32(1.0 + eps)), float(tol),
            torch.cuda.current_stream(dev).cuda_stream)
        knn_rank_audited_cuda.launches += 2
    return vals, idx, util, expo, comp != 0, lam


knn_rank_audited_cuda.launches = 0


def _check_quant_sweep(xq, X_q, q_scale, y2_q, lam_db, k: int,
                       k_extra: int, mode: str, dev: torch.device):
    """Validate the quantized sweep's inputs; returns (B, n_pad, n_train,
    D, K_pred, slab, geometry), the geometry (None on the CPU) only on
    the card, where the kernel's own limits on k + k_extra and d are
    checked too."""
    n_pad, D = X_q.shape
    B, (n_train, k_pred) = xq.shape[0], lam_db.shape
    slab = check_pack(X_q, q_scale, y2_q, mode, n_train=n_train)
    k_keep = k + k_extra
    if not 1 <= k <= n_train or k_extra < 1 or k_keep > n_pad:
        raise ValueError(
            f"need 1 <= k <= n_train, k_extra >= 1 and k + k_extra <= "
            f"n_pad, got k={k}, k_extra={k_extra}, n_train={n_train}, "
            f"n_pad={n_pad}")
    f32 = torch.float32
    check_tensor("xq", xq, (B, D), f32, dev)
    check_tensor("X_q", X_q, (n_pad, D), X_q.dtype, dev)
    check_tensor("q_scale", q_scale, tuple(q_scale.shape), f32, dev)
    check_tensor("y2_q", y2_q, (n_pad, 1), f32, dev)
    check_tensor("lam_db", lam_db, (n_train, k_pred), f32, dev)
    if dev.type == "cpu":
        return B, n_pad, n_train, D, k_pred, slab, None
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    return (B, n_pad, n_train, D, k_pred, slab,
            quant_sweep_geometry(B, n_pad, D, k, k_extra, mode, n_sm))


def knn_lambda_quant_cuda(xq, X_q, q_scale, y2_q, lam_db, *, k: int = 10,
                          k_extra: int = QUANT_EXTRA, mode: str,
                          device=None):
    """Quantized KNN lambda-hat: xq (B, D) f32, the pack X_q (n_pad, D)
    int8 or bf16 (`mode`), q_scale (n_slabs, 1), y2_q (n_pad, 1) and
    lam_db (n_train, K_pred), contiguous on `device` (None = the card)
    -> (lam (B, K_pred), guard (B, 1) int32). Two launches per call;
    each adds one to `knn_lambda_quant_cuda.launches`."""
    dev = resolve_device(device)
    B, n_pad, n_train, D, k_pred, slab, g = _check_quant_sweep(
        xq, X_q, q_scale, y2_q, lam_db, k, k_extra, mode, dev)
    if dev.type == "cpu":
        return knn_lambda_quant_ref(xq, X_q, q_scale, y2_q, lam_db, k,
                                    k_extra=k_extra, mode=mode)
    kk = k + k_extra
    ws_d2, ws_idx = _workspace(B, g.n_chunks, kk, dev)
    lam = torch.empty((B, k_pred), dtype=torch.float32, device=dev)
    guard = torch.empty((B, 1), dtype=torch.int32, device=dev)
    if B:
        build.launch(
            "knn_lambda_quant", xq.data_ptr(), X_q.data_ptr(),
            q_scale.data_ptr(), y2_q.data_ptr(), lam_db.data_ptr(),
            ws_d2.data_ptr(), ws_idx.data_ptr(), lam.data_ptr(),
            guard.data_ptr(), B, n_pad, n_train, D, k, kk, k_pred, slab,
            int(mode == "int8"), g.chunk, g.tile, g.n_chunks,
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
    _, n_pad, n_train, D, k_pred, slab, g = _check_quant_sweep(
        xq, X_q, q_scale, y2_q, lam_db, k, k_extra, mode, dev)
    check_pred_width(k_pred, K)
    if dev.type == "cpu":
        return knn_rank_audited_quant_ref(
            xq, X_q, q_scale, y2_q, lam_db, u, a, b, gamma, k=k, mode=mode,
            m2=m2, k_extra=k_extra, eps=eps, tol=tol)
    check_rank_kernel(K, m2)
    f32 = torch.float32
    kk = k + k_extra
    ws_d2, ws_idx = _workspace(B, g.n_chunks, kk, dev)
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
            rank_split(B, m1, dev), g.chunk, g.tile, g.n_chunks,
            float(np.float32(1.0 + eps)), float(tol),
            torch.cuda.current_stream(dev).cuda_stream)
        knn_rank_audited_quant_cuda.launches += 2
    return vals, idx, util, expo, comp != 0, lam, guard


knn_rank_audited_quant_cuda.launches = 0
