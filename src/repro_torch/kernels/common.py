"""Constants, argument checks and the quantized-db arithmetic shared by
the CUDA kernel wrappers and their plain versions.

The TPU kernels' LANE/SUBLANE/TILE_B/TILE_M/DB_SLAB were vreg shapes;
nothing here copies them. The GPU geometry is chosen for Hopper: a
ranked row on one 256-thread block or a cluster of them (the rank
routine's own constants are in kernels/fused_rank.py), and KNN sweeps
that give each block 32 queries (8 warps of 4) and a chunk of database
rows sized from the batch, their tiles within KNN_SMEM_BYTES of shared
memory. The KNN kernels' limits (k <= KNN_MAX_K over the f32 db,
k + k_extra <= KNN_QUANT_MAX_KEEP over a pack, a d whose resident
queries and tiles fit the shared memory) hold on the card only and are
computed by kernels/knn_topk.py's sweep_geometry and
quant_sweep_geometry; the plain versions take any k and d.

The second half holds the quantized KNN database's arithmetic
(counterpart of repro.kernels.common's quant section): the plain
functions below are what the quantized CUDA kernels compute, written in
the kernels' order of rounded operations (every product and addition
rounded on its own, sums over the covariates taken coordinate by
coordinate), so a kernel and its plain version give the same bits.
"""

from __future__ import annotations

import torch

# Finite "minus infinity" for padded candidate utilities: padded
# candidates never enter a top-m2, yet 0.0 * NEG_INF == 0.0 exactly.
NEG_INF = float(-1e30)

KNN_QTILE = 32       # queries per block of both KNN sweeps (8 warps x 4)
KNN_MAX_K = 256      # neighbours the f32 KNN kernels keep per query
# Dynamic shared memory a KNN sweep block may use, of the card's 227 KB
# opt-in (the launchers raise the kernel's limit past the default 48 KB).
KNN_SMEM_BYTES = 220 * 1024

# -- the quantized KNN database ------------------------------------------
QUANT_MODES = ("off", "bf16", "int8")
# The quantized sweep keeps k + QUANT_EXTRA survivors, so a rank
# inversion near the k-th place caused by quantization is repaired by
# the exact re-score instead of lost.
QUANT_EXTRA = 8
# |x~|^2 of the pack's padding rows: they never survive a sweep.
PAD_Y2 = float(1e30)
# The storage format's slab (the JAX package's DB_SLAB): rows share one
# int8 scale per slab. Not a tile of the card: the kernels read
# scale[row // slab] with any slab, so a pack made by either package
# loads in the other.
QUANT_SLAB = 512
# Survivors one quantized sweep keeps per query (k + k_extra), at most.
KNN_QUANT_MAX_KEEP = 256


def check_tensor(name: str, t: torch.Tensor, shape: tuple,
                 dtype: torch.dtype, device: torch.device) -> None:
    """Raise unless `t` is a contiguous tensor of this shape, dtype and
    device: the kernels index raw pointers and trust all four."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def dot_seq(q, x):
    """q . x over the last axis of both (broadcast), summed coordinate by
    coordinate with every product and addition rounded on its own."""
    acc = q[..., 0] * x[..., 0]
    for d in range(1, q.shape[-1]):
        acc = acc + q[..., d] * x[..., d]
    return acc


def sq_norm_seq(x):
    """|x|^2 over the last axis, summed coordinate by coordinate."""
    return dot_seq(x, x)


def quantize_query(q):
    """Symmetric per-row int8 quantization of the queries: q (B, d) f32 ->
    (qi (B, d) f32 holding integers in [-127, 127], sq (B, 1) f32).
    sq = max|q| / 127 (1 where the row is 0); torch.round rounds half to
    even, as jnp.round and the kernels' rintf do."""
    sq = torch.amax(q.abs(), dim=-1, keepdim=True) / 127.0
    sq = torch.where(sq > 0, sq, torch.ones_like(sq))
    qi = torch.clamp(torch.round(q / sq), -127.0, 127.0)
    return qi, sq


def dequant_rows(rows_q, scale):
    """x~ = stored rows * scale, in f32 (int8 or bf16 storage)."""
    return rows_q.to(torch.float32) * torch.as_tensor(
        scale, dtype=torch.float32, device=rows_q.device)


def quant_d2_tile(q, db_q, scale, y2, *, mode: str):
    """Quantized squared distances of queries to stored db rows:
    q (B, d) f32, db_q (T, d) int8 or bf16, scale (T,) f32 (each row's
    slab scale) or a scalar, y2 (T,) the rows' exact |x~|^2 -> (B, T).

    int8: the query is quantized per row and the cross term is an
    integer dot (exact in f32 in any order, since d * 127^2 < 2^24),
    then d2 = q2 - ((2 sq) scale) cross + y2, each operation rounded on
    its own. bf16: the rows are dequantized exactly and the dot runs in
    f32, coordinate by coordinate: d2 = q2 - 2 cross + y2. Clamped at 0.
    q2 is sq_norm_seq(q)."""
    q2 = sq_norm_seq(q)[:, None]
    scale = torch.as_tensor(scale, dtype=torch.float32, device=q.device)
    if mode == "int8":
        qi, sq = quantize_query(q)
        cross = qi @ db_q.to(torch.float32).T
        d2 = q2 - ((2.0 * sq) * scale) * cross + y2
    elif mode == "bf16":
        xt = dequant_rows(db_q, scale[..., None] if scale.dim() else scale)
        d2 = q2 - 2.0 * dot_seq(q[:, None, :], xt[None, :, :]) + y2
    else:
        raise ValueError(f"quant_d2_tile: bad mode {mode!r}")
    return torch.clamp_min(d2, 0.0)


def exact_rescore(q, x_sel, y2_sel):
    """Exact f32 squared distances of each query's survivors: q (B, d),
    x_sel (B, d, k') dequantized survivor rows, y2_sel (B, k') their
    |x~|^2 -> (B, k') = max(q2 - 2 (q . x~) + y2, 0)."""
    q2 = sq_norm_seq(q)[:, None]
    cross = dot_seq(q[:, None, :], x_sel.transpose(1, 2))
    return torch.clamp_min(q2 - 2.0 * cross + y2_sel, 0.0)


def quant_d2_err(q, x_sel, *, mode: str):
    """The exact error of each survivor's quantized distance caused by
    the query's quantization: |2 (q - sq qi) . x~| (B, k'); 0 in bf16
    mode, which rounds only the db."""
    if mode != "int8":
        return torch.zeros((x_sel.shape[0], x_sel.shape[-1]),
                           dtype=torch.float32, device=x_sel.device)
    qi, sq = quantize_query(q)
    e = q - sq * qi
    return torch.abs(2.0 * dot_seq(e[:, None, :], x_sel.transpose(1, 2)))


def bottomk_rerank(d2, gidx, k: int):
    """The k smallest of a small candidate set per row, ascending by
    (d2, global index): ties go to the lowest global index. d2 (B, k'),
    gidx (B, k') -> (d2_top (B, k), idx_top (B, k))."""
    by_idx = torch.sort(gidx, dim=-1, stable=True).indices
    d2_i, g_i = torch.gather(d2, 1, by_idx), torch.gather(gidx, 1, by_idx)
    order = torch.sort(d2_i, dim=-1, stable=True).indices[:, :k]
    return torch.gather(d2_i, 1, order), torch.gather(g_i, 1, order)
