"""Shadow-price predictors f(X) -> lambda (counterpart of
repro.core.predictors): the paper's mean baseline, its KNN regressor
and the ridge-regression linear family.

The KNN estimator is sklearn's KNN regressor with inverse-distance
weights (k = 10, Euclidean), computed by brute force: d2(x, xi) =
|x|^2 - 2 x.xi + |xi|^2, then the k smallest with ties to the lowest
database index, then the weights of `_idw_lambda`. A KNN predictor may
also carry a quantized copy of its database (`quantized`, int8 or bf16
rows with one scale per slab); it then predicts through the quantized
sweep with an exact f32 re-score of its survivors. The MLP family is a
later slice (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.common import (
    PAD_Y2,
    QUANT_EXTRA,
    QUANT_MODES,
    QUANT_SLAB,
    bottomk_rerank,
    dequant_rows,
    exact_rescore,
    quant_d2_err,
    quant_d2_tile,
    sq_norm_seq,
)

# Above this many train rows KNNLambdaPredictor.predict streams the
# database in chunks: the one-product form's (b, n_train) distance matrix
# is n_train * 4 bytes per query row.
KNN_CHUNK_THRESHOLD = 32_768


def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


@dataclass(frozen=True)
class MeanLambdaPredictor:
    """Intercept-only, covariate-free predictor: lam_hat = mean(lam_train).
    The mean is broadcast as it is, unclamped: a negative mean stays
    negative."""

    mean_lam: torch.Tensor  # (K,) f32

    @staticmethod
    def fit(X_train, lam_train, device=None) -> "MeanLambdaPredictor":
        del X_train
        dev = resolve_device(device)
        return MeanLambdaPredictor(
            mean_lam=torch.mean(_f32(lam_train, dev), dim=0))

    @property
    def device(self) -> torch.device:
        return self.mean_lam.device

    @property
    def num_constraints(self) -> int:
        return int(self.mean_lam.shape[0])

    def to(self, device) -> "MeanLambdaPredictor":
        return MeanLambdaPredictor(
            mean_lam=self.mean_lam.to(resolve_device(device)))

    def predict(self, X) -> torch.Tensor:
        batch = tuple(X.shape[:-1])
        return self.mean_lam.expand(batch + tuple(self.mean_lam.shape))


@dataclass(frozen=True)
class LinearLambdaPredictor:
    """Ridge regression lam ~ W x + c in closed form; lam_hat is clamped
    at 0."""

    W: torch.Tensor  # (K, d) f32
    c: torch.Tensor  # (K,) f32

    @staticmethod
    def fit(X_train, lam_train, l2: float = 1e-3,
            device=None) -> "LinearLambdaPredictor":
        """Centre X and lam, solve (Xc^T Xc + l2 I) W^T = Xc^T Yc in f32,
        then c = mean(lam) - W mean(X)."""
        dev = resolve_device(device)
        X, Y = _f32(X_train, dev), _f32(lam_train, dev)
        mu_x, mu_y = X.mean(dim=0), Y.mean(dim=0)
        Xc, Yc = X - mu_x, Y - mu_y
        d = X.shape[1]
        G = Xc.T @ Xc + l2 * torch.eye(d, dtype=X.dtype, device=dev)
        W = torch.linalg.solve(G, Xc.T @ Yc).T.contiguous()    # (K, d)
        return LinearLambdaPredictor(W=W, c=mu_y - W @ mu_x)

    @property
    def device(self) -> torch.device:
        return self.W.device

    @property
    def num_constraints(self) -> int:
        return int(self.W.shape[0])

    def to(self, device) -> "LinearLambdaPredictor":
        dev = resolve_device(device)
        return LinearLambdaPredictor(W=self.W.to(dev), c=self.c.to(dev))

    def predict(self, X) -> torch.Tensor:
        X = _f32(X, self.device)
        return torch.clamp_min(X @ self.W.T + self.c, 0.0)


@dataclass(frozen=True)
class KNNLambdaPredictor:
    """Exact k-nearest-neighbour regressor, inverse-distance weighted.
    Its tensors live on one device; `predict` runs there.

    Optionally it also carries a quantized copy of the db (`quantized`):
    int8 or bf16 rows X_q (n_pad, d), one scale per slab q_scale
    (n_slabs, 1) and the exact |x~|^2 of the dequantized rows y2_q
    (n_pad, 1), PAD_Y2 on the padding rows. `quant` names the storage
    mode ("off" without a pack); the serving route follows it."""

    X_db: torch.Tensor    # (n_train, d) f32
    lam_db: torch.Tensor  # (n_train, K) f32
    k: int
    X_q: torch.Tensor | None = None      # (n_pad, d) int8 or bf16
    q_scale: torch.Tensor | None = None  # (n_slabs, 1) f32
    y2_q: torch.Tensor | None = None     # (n_pad, 1) f32
    quant: str = "off"

    @staticmethod
    def fit(X_train, lam_train, k: int = 10,
            device=None) -> "KNNLambdaPredictor":
        dev = resolve_device(device)
        return KNNLambdaPredictor(
            X_db=torch.as_tensor(X_train, dtype=torch.float32, device=dev),
            lam_db=torch.as_tensor(lam_train, dtype=torch.float32,
                                   device=dev),
            k=int(k))

    @property
    def device(self) -> torch.device:
        return self.X_db.device

    @property
    def num_constraints(self) -> int:
        return int(self.lam_db.shape[1])

    def quantized(self, mode: str = "int8", slab: int | None = None,
                  device=None) -> "KNNLambdaPredictor":
        """A copy of this predictor on `device` (None = the card) that
        carries its db packed in `mode` ("int8" or "bf16") with one
        scale per `slab` rows (default QUANT_SLAB, the JAX package's)."""
        if mode not in QUANT_MODES or mode == "off":
            raise ValueError(f"quantized(): mode must be 'int8' or 'bf16', "
                             f"got {mode!r}")
        base = self.to(device)
        X_q, q_scale, y2_q = pack_knn_db(
            base.X_db, mode=mode, slab=QUANT_SLAB if slab is None else slab,
            device=base.device)
        return dataclasses.replace(base, X_q=X_q, q_scale=q_scale,
                                   y2_q=y2_q, quant=mode)

    def to(self, device) -> "KNNLambdaPredictor":
        dev = resolve_device(device)
        return dataclasses.replace(self, **{
            f: getattr(self, f).to(dev) for f in state_fields(self)})

    def predict(self, X) -> torch.Tensor:
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        if self.X_q is not None:
            return knn_predict_quant(self.X_q, self.q_scale, self.y2_q,
                                     self.lam_db, X, k=self.k,
                                     mode=self.quant)
        if self.X_db.shape[0] > KNN_CHUNK_THRESHOLD:
            return knn_predict_chunked(self.X_db, self.lam_db, X, k=self.k)
        return knn_predict(self.X_db, self.lam_db, X, k=self.k)


def _idw_lambda(d2_top, x2, y2_sel, lam_neighbors) -> torch.Tensor:
    """Inverse-distance weighting with the exact-match override on
    already selected neighbours: d2_top (b, k) ascending, x2 (b, 1),
    y2_sel (b, k), lam_neighbors (b, k, C) -> (b, C).

    The expanded-form d2 carries O(eps_f32 * |x|^2) error, so 'exact'
    (the query coincides with a database point: return that point's
    value, sklearn's 'distance' semantics) is a relative test. The two
    sums over the k neighbours run neighbour by neighbour, each product
    and addition rounded on its own, which is the order the CUDA kernel
    uses: the plain path and the kernel then give the same bits.
    """
    dist = torch.sqrt(d2_top)
    scale2 = x2 + y2_sel + 1e-12
    exact = d2_top <= 1e-6 * scale2
    any_exact = torch.any(exact, dim=-1, keepdim=True)
    w_inv = 1.0 / torch.clamp_min(dist, 1e-12)
    w = torch.where(any_exact, exact.to(d2_top.dtype), w_inv)
    total = w[:, 0]
    for j in range(1, w.shape[1]):
        total = total + w[:, j]
    w = w / total[:, None]
    out = w[:, 0, None] * lam_neighbors[:, 0]
    for j in range(1, w.shape[1]):
        out = out + w[:, j, None] * lam_neighbors[:, j]
    return out


def _topk_smallest(d2, idx, k: int):
    """The k smallest d2 per row, ascending, ties to the earlier column
    (a stable sort): callers lay candidates out in ascending database
    index, so ties go to the lowest index."""
    order = torch.sort(d2, dim=-1, stable=True).indices[:, :k]
    return torch.gather(d2, 1, order), torch.gather(idx, 1, order)


def knn_predict(X_db, lam_db, X, *, k: int = 10) -> torch.Tensor:
    """Inverse-distance-weighted KNN regression over one (b, n) distance
    product. X: (b, d) or (d,) -> (b, K) or (K,)."""
    squeeze = X.dim() == 1
    Xq = torch.atleast_2d(X)
    x2 = torch.sum(Xq * Xq, dim=-1, keepdim=True)
    y2 = torch.sum(X_db * X_db, dim=-1)
    d2 = torch.clamp_min(x2 - 2.0 * (Xq @ X_db.T) + y2[None, :], 0.0)
    n = X_db.shape[0]
    idx = torch.arange(n, device=X_db.device).expand(Xq.shape[0], n)
    d2_top, top = _topk_smallest(d2, idx, k)
    out = _idw_lambda(d2_top, x2, y2[top], lam_db[top])
    return out[0] if squeeze else out


def _d2_matmul(Xq, x2, db):
    """Expanded-form squared distances of queries to one db chunk, the
    cross term as one matrix product."""
    y2 = torch.sum(db * db, dim=-1)
    return torch.clamp_min(x2 - 2.0 * (Xq @ db.T) + y2[None, :], 0.0)


def knn_topk_scan(X_db, Xq, *, k: int = 10, chunk: int = 8192,
                  d2_fn=_d2_matmul, x2=None):
    """Streaming k smallest d2: the database goes through in `chunk`-row
    slabs and only the running (d2, index) top-k per query is kept, so
    no (b, n_train) matrix is ever built. The running buffer precedes
    the fresh chunk in each merge, so ties go to the lowest global
    index. `d2_fn(Xq, x2, db_chunk)` forms one chunk's distances from
    the queries' |x|^2 `x2` (b, 1), by default their plain sum.
    Returns (d2 (b, k) ascending, idx (b, k) int64)."""
    n = X_db.shape[0]
    if n < k:
        raise ValueError(f"n_train={n} < k={k}")
    b = Xq.shape[0]
    if x2 is None:
        x2 = torch.sum(Xq * Xq, dim=-1, keepdim=True)
    run_v = torch.empty((b, 0), dtype=Xq.dtype, device=Xq.device)
    run_i = torch.empty((b, 0), dtype=torch.int64, device=Xq.device)
    for start in range(0, n, chunk):
        db = X_db[start:start + chunk]
        d2 = d2_fn(Xq, x2, db)
        gidx = torch.arange(start, start + db.shape[0],
                            device=Xq.device).expand(b, -1)
        run_v, run_i = _topk_smallest(torch.cat([run_v, d2], dim=1),
                                      torch.cat([run_i, gidx], dim=1), k)
    return run_v, run_i


def knn_predict_chunked(X_db, lam_db, X, *, k: int = 10,
                        chunk: int = 8192) -> torch.Tensor:
    """knn_predict for large train databases: the same estimator on the
    knn_topk_scan slab sweep."""
    squeeze = X.dim() == 1
    Xq = torch.atleast_2d(X)
    d2_top, idx = knn_topk_scan(X_db, Xq, k=k, chunk=chunk)
    x2 = torch.sum(Xq * Xq, dim=-1, keepdim=True)
    y2_sel = torch.sum(X_db[idx] * X_db[idx], dim=-1)
    out = _idw_lambda(d2_top, x2, y2_sel, lam_db[idx])
    return out[0] if squeeze else out


# -- the quantized db: pack, and the quantized sweep's selection ----------
# Plain PyTorch, in the order of rounded operations the quantized CUDA
# kernels repeat (kernels/common.py), so the kernels' selection, guard
# and lambda-hat equal these bitwise.

# distance elements one chunk of the quantized scan may hold (b * chunk)
_SCAN_CHUNK_ELEMS = 1 << 24


def _pack_one_slab(x_slab, *, mode: str):
    """Pack db slabs: x_slab (..., s, d) f32, padding rows all zero ->
    (rows_q (..., s, d) int8 or bf16, scale (..., 1) f32, y2 (..., s)
    f32, the |x~|^2 of the dequantized rows in sq_norm_seq order). Each
    slab is packed on its own (int8: scale = max|x| / 127, 1 for a zero
    slab; rows = clip(round(x / scale), -127, 127)), vectorised over any
    leading axis of slabs, so packing some slabs again gives the very
    bits of the full pack."""
    x = x_slab.to(torch.float32)
    if mode == "int8":
        scale = torch.amax(x.abs(), dim=(-2, -1)) / 127.0
        scale = torch.where(scale > 0, scale, torch.ones_like(scale))
        scale = scale[..., None]                              # (..., 1)
        rows_q = torch.clamp(torch.round(x / scale[..., None]), -127.0,
                             127.0).to(torch.int8)
        xt = dequant_rows(rows_q, scale[..., None])
    elif mode == "bf16":
        rows_q = x.to(torch.bfloat16)
        scale = torch.ones(x.shape[:-2] + (1,), dtype=torch.float32,
                           device=x.device)
        xt = rows_q.to(torch.float32)
    else:
        raise ValueError(f"_pack_one_slab: bad mode {mode!r}")
    return rows_q, scale, sq_norm_seq(xt)


def _slab_rows(X, slabs, slab: int):
    """The rows of db slabs `slabs` (t,) as (t, slab, d), rows past the
    db zero, and the (t, slab) mask of real rows."""
    n = X.shape[0]
    idx = slabs[:, None] * slab + torch.arange(slab, device=X.device)
    real = idx < n
    rows = X[torch.clamp(idx, max=n - 1)]
    zero = torch.zeros((), dtype=X.dtype, device=X.device)
    return torch.where(real[..., None], rows, zero), idx, real


def pack_knn_db(X_db, *, mode: str = "int8", slab: int = QUANT_SLAB,
                device=None):
    """Quantize the KNN train db (n, d) into slabs of `slab` rows on
    `device` (None = the card), all slabs in one vectorised pass.
    Returns (X_q (n_pad, d) int8 or bf16, q_scale (n_slabs, 1) f32,
    y2_q (n_pad, 1) f32) with n_pad = n rounded up to a slab multiple;
    padding rows store 0 with y2 = PAD_Y2, so no sweep selects them.
    The layout is the JAX package's pack_knn_db, bit for bit in X_q and
    q_scale."""
    dev = resolve_device(device)
    X = torch.as_tensor(X_db, dtype=torch.float32, device=dev)
    n, d = X.shape
    if mode not in ("int8", "bf16"):
        raise ValueError(f"pack_knn_db: mode must be 'int8' or 'bf16', "
                         f"got {mode!r}")
    n_slabs = -(-n // slab)
    rows, _, real = _slab_rows(X, torch.arange(n_slabs, device=dev), slab)
    rows_q, q_scale, y2 = _pack_one_slab(rows, mode=mode)
    y2 = torch.where(real, y2, torch.full_like(y2, PAD_Y2))
    return (rows_q.reshape(n_slabs * slab, d), q_scale,
            y2.reshape(n_slabs * slab, 1))


def repack_knn_slabs(X_db, X_q, q_scale, y2_q, rows, *, mode: str,
                     slab: int):
    """After a write to db `rows`, pack again only the slabs that hold
    them, fresh scale included, with the per-slab program of
    pack_knn_db: the result is bitwise a full repack of the updated db.
    Returns new (X_q, q_scale, y2_q); the inputs are left as they are."""
    X = torch.as_tensor(X_db, dtype=torch.float32, device=X_q.device)
    touched = torch.unique(torch.as_tensor(rows, device=X.device)
                           .reshape(-1).to(torch.int64) // slab)
    x, idx, real = _slab_rows(X, touched, slab)
    rows_q, scale, y2 = _pack_one_slab(x, mode=mode)
    y2 = torch.where(real, y2, torch.full_like(y2, PAD_Y2))
    X_q, q_scale, y2_q = X_q.clone(), q_scale.clone(), y2_q.clone()
    X_q[idx.reshape(-1)] = rows_q.reshape(-1, X_q.shape[1])
    q_scale[touched] = scale
    y2_q[idx.reshape(-1), 0] = y2.reshape(-1)
    return X_q, q_scale, y2_q


def check_pack(X_q, q_scale, y2_q, mode: str, n_train: int | None = None):
    """Raise unless (X_q, q_scale, y2_q) is a pack of `mode`: X_q
    (n_pad, d) int8 or bf16, q_scale (n_slabs, 1) f32 with n_slabs
    dividing n_pad, y2_q (n_pad, 1) f32, and n_pad covering n_train by
    less than one slab. Returns the slab."""
    want = {"int8": torch.int8, "bf16": torch.bfloat16}.get(mode)
    if want is None:
        raise ValueError(f"quant must be 'int8' or 'bf16', got {mode!r}")
    if X_q.dtype != want:
        raise ValueError(f"X_q has dtype {X_q.dtype}, {mode} needs {want}")
    n_pad, n_slabs = X_q.shape[0], q_scale.shape[0]
    if X_q.dim() != 2 or q_scale.shape != (n_slabs, 1) or n_slabs < 1 \
            or n_pad % n_slabs or tuple(y2_q.shape) != (n_pad, 1):
        raise ValueError(f"X_q {tuple(X_q.shape)}, q_scale "
                         f"{tuple(q_scale.shape)} and y2_q "
                         f"{tuple(y2_q.shape)} are not one pack")
    slab = n_pad // n_slabs
    if n_train is not None and not 0 <= n_pad - n_train < slab:
        raise ValueError(f"a pack of {n_pad} rows at slab {slab} does not "
                         f"hold a db of {n_train} rows")
    return slab


def _quant_flush(Xq, X_q, q_scale, y2_q, d2q, idx, k: int, mode: str):
    """The quantized sweep's flush on its survivors d2q, idx (b, k')
    in quantized order: the margin guard on the quantized k-th gap, the
    exact f32 re-score on the dequantized rows, the re-rank to k.
    Returns (d2_top (b, k) exact-on-x~, idx (b, k), guard (b, 1) i32)."""
    slab = X_q.shape[0] // q_scale.shape[0]
    x_cols = dequant_rows(X_q[idx], q_scale[idx // slab]).transpose(1, 2)
    d2x = exact_rescore(Xq, x_cols, y2_q[idx, 0])
    gap = d2q[:, k:k + 1] - d2q[:, k - 1:k]
    errs = quant_d2_err(Xq, x_cols, mode=mode)
    guard = (gap <= errs[:, k - 1:k] + errs[:, k:k + 1]).to(torch.int32)
    d2_top, idx_top = bottomk_rerank(d2x, idx, k)
    return d2_top, idx_top, guard


def knn_quant_scan(X_q, q_scale, y2_q, Xq, *, k: int = 10,
                   k_extra: int | None = None, mode: str = "int8",
                   chunk: int | None = None, device=None):
    """The quantized sweep's selection on `device` (None = the card):
    the packed db goes through in `chunk`-row pieces at low precision
    (kernels.common.quant_d2_tile, each row at its slab's scale), with a
    running top-(k + k_extra) of (d2q, global index), ties to the lowest
    index; then the survivors are re-scored exactly in f32 and re-ranked
    to k. Returns (d2 (b, k) ascending, idx (b, k), guard (b, 1) i32,
    1 where the quantized k/(k+1) gap is within the two boundary
    survivors' exact quantization error)."""
    dev = resolve_device(device)
    k_extra = QUANT_EXTRA if k_extra is None else int(k_extra)
    k_keep = k + k_extra
    X_q, q_scale, y2_q = (t.to(dev) for t in (X_q, q_scale, y2_q))
    Xq = torch.as_tensor(Xq, dtype=torch.float32, device=dev)
    n_pad = X_q.shape[0]
    if not 1 <= k or k_extra < 1 or n_pad < k_keep:
        raise ValueError(f"need k >= 1, k_extra >= 1 and k + k_extra <= "
                         f"{n_pad} packed rows, got k={k}, k_extra={k_extra}")
    slab = n_pad // q_scale.shape[0]
    b = Xq.shape[0]
    if chunk is None:
        chunk = max(1024, _SCAN_CHUNK_ELEMS // max(1, b))
    run_v = torch.empty((b, 0), dtype=torch.float32, device=dev)
    run_i = torch.empty((b, 0), dtype=torch.int64, device=dev)
    for start in range(0, n_pad, chunk):
        rows = torch.arange(start, min(n_pad, start + chunk), device=dev)
        d2q = quant_d2_tile(Xq, X_q[start:start + chunk],
                            q_scale[rows // slab, 0],
                            y2_q[start:start + chunk, 0], mode=mode)
        run_v, run_i = _topk_smallest(torch.cat([run_v, d2q], dim=1),
                                      torch.cat([run_i, rows.expand(b, -1)],
                                                dim=1), k_keep)
    return _quant_flush(Xq, X_q, q_scale, y2_q, run_v, run_i, k, mode)


def quant_idw(Xq, X_q, y2_q, lam_db, d2_top, idx) -> torch.Tensor:
    """lambda-hat (b, K) of a quantized selection (d2_top, idx): the
    k re-ranked neighbours weighted by _idw_lambda, |q|^2 in sq_norm_seq
    order and y2 from y2_q; the pack's padding rows price 0."""
    lam_p = torch.nn.functional.pad(
        lam_db.to(torch.float32), (0, 0, 0, X_q.shape[0] - lam_db.shape[0]))
    return _idw_lambda(d2_top, sq_norm_seq(Xq)[:, None], y2_q[idx, 0],
                       lam_p[idx])


def knn_predict_quant(X_q, q_scale, y2_q, lam_db, X, *, k: int = 10,
                      mode: str = "int8") -> torch.Tensor:
    """knn_predict through the quantized sweep and the exact survivor
    re-score, on the pack's device: the estimator exact on the
    dequantized db x~. X: (b, d) or (d,) -> (b, K) or (K,)."""
    squeeze = X.dim() == 1
    Xq = torch.atleast_2d(X).to(torch.float32)
    d2_top, idx, _ = knn_quant_scan(X_q, q_scale, y2_q, Xq, k=k, mode=mode,
                                    device=Xq.device)
    lam = quant_idw(Xq, X_q, y2_q, lam_db, d2_top, idx)
    return lam[0] if squeeze else lam


# The array fields of each ported family: the state a predictor carries
# across from the JAX package and swaps in place. KNN's packed-db triple
# takes part only when present (state_fields).
STATE_FIELDS = {
    MeanLambdaPredictor: ("mean_lam",),
    KNNLambdaPredictor: ("X_db", "lam_db", "X_q", "q_scale", "y2_q"),
    LinearLambdaPredictor: ("W", "c"),
}


def state_fields(predictor) -> tuple:
    """The array fields present on this predictor: its family's
    STATE_FIELDS minus optional fields that are None (so an unquantized
    KNN predictor's state stays {X_db, lam_db}); empty for a family
    this package does not know."""
    return tuple(f for f in STATE_FIELDS.get(type(predictor), ())
                 if getattr(predictor, f, None) is not None)


def predictor_state(predictor) -> dict:
    """The predictor's array state as a flat dict of tensors."""
    return {f: getattr(predictor, f) for f in state_fields(predictor)}


def with_state(predictor, state: dict):
    """The predictor with its array state replaced by `state` (the keys
    of predictor_state); non-array fields (KNN's k) carry over."""
    fields = state_fields(predictor)
    if set(state) != set(fields):
        raise ValueError(f"state keys {sorted(state)} != {sorted(fields)} "
                         f"for {type(predictor).__name__}")
    if not fields:
        return predictor
    return dataclasses.replace(predictor, **state)


def from_numpy(state: dict, k: int | None = None, device=None,
               quant: str | None = None):
    """Build the port's predictor from the arrays of a JAX predictor
    (`repro.core.predictors.predictor_state(p)`, each converted with
    np.asarray): the weights carried across from the reference. The
    family follows from the keys: {X_db, lam_db} is KNN (and needs k),
    with {X_q, q_scale, y2_q} besides a quantized KNN, {W, c} linear,
    {mean_lam} mean.

    A quantized state keeps its storage: an int8 X_q stays int8. numpy
    may have no bfloat16, so a bf16 X_q may arrive as float32 values
    (exact for bf16) with `quant="bf16"` and is cast back; `quant`
    defaults to "int8" for an int8 X_q and must be given otherwise."""
    keys = set(state)
    knn2, packed = {"X_db", "lam_db"}, {"X_q", "q_scale", "y2_q"}
    if keys not in ({"mean_lam"}, {"W", "c"}, knn2, knn2 | packed):
        raise NotImplementedError(
            f"state fields {sorted(keys)}: only the mean, linear and KNN "
            f"families are ported; the MLP family is ROADMAP Queue 1 item 3")
    arrays = {f: np.array(v, np.float32) for f, v in state.items()
              if f != "X_q"}
    dev = resolve_device(device)
    if keys == {"mean_lam"}:
        mean_lam = arrays["mean_lam"]
        if mean_lam.ndim != 1:
            raise ValueError(f"mean_lam {mean_lam.shape} must be 1-D")
        return MeanLambdaPredictor(mean_lam=_f32(mean_lam, dev))
    if keys == {"W", "c"}:
        W, c = arrays["W"], arrays["c"]
        if W.ndim != 2 or c.shape != (W.shape[0],):
            raise ValueError(f"W {W.shape} and c {c.shape} must be (K, d) "
                             f"and (K,)")
        return LinearLambdaPredictor(W=_f32(W, dev), c=_f32(c, dev))
    X_db, lam_db = arrays["X_db"], arrays["lam_db"]
    if X_db.ndim != 2 or lam_db.ndim != 2 or X_db.shape[0] != lam_db.shape[0]:
        raise ValueError(f"X_db {X_db.shape} and lam_db {lam_db.shape} must "
                         f"be 2-D with one row per train user")
    if k is None:
        raise ValueError("a KNN state needs k")
    knn = KNNLambdaPredictor.fit(X_db, lam_db, k=k, device=dev)
    if keys == knn2:
        return knn
    X_q = _packed_rows(state["X_q"], quant)
    q_scale, y2_q = (_f32(arrays[f], dev) for f in ("q_scale", "y2_q"))
    mode = "int8" if X_q.dtype == torch.int8 else "bf16"
    X_q = X_q.to(dev)
    check_pack(X_q, q_scale, y2_q, mode, n_train=X_db.shape[0])
    return dataclasses.replace(knn, X_q=X_q, q_scale=q_scale, y2_q=y2_q,
                               quant=mode)


def _packed_rows(X_q, quant: str | None) -> torch.Tensor:
    """A packed X_q from numpy: int8 as it is; bf16 from values that are
    exact in bfloat16 (float32, or numpy's extension bfloat16)."""
    X_q = np.asarray(X_q)
    if X_q.dtype == np.int8:
        if quant not in (None, "int8"):
            raise ValueError(f"an int8 X_q is an int8 pack, not {quant!r}")
        return torch.from_numpy(X_q.copy())
    if quant != "bf16":
        raise ValueError(f"X_q of dtype {X_q.dtype} needs quant='bf16' "
                         f"(an int8 pack arrives as int8), got {quant!r}")
    x = torch.from_numpy(np.array(X_q, np.float32))
    X_bf = x.to(torch.bfloat16)
    if not torch.equal(X_bf.to(torch.float32), x):
        raise ValueError("X_q holds values that bfloat16 cannot represent")
    return X_bf
