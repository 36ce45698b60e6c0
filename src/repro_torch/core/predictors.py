"""The paper's KNN shadow-price predictor f(X) -> lambda (counterpart of
the exact KNN path of repro.core.predictors).

The estimator is sklearn's KNN regressor with inverse-distance weights
(k = 10, Euclidean), computed by brute force: d2(x, xi) = |x|^2 -
2 x.xi + |xi|^2, then the k smallest with ties to the lowest database
index, then the weights of `_idw_lambda`. The other predictor families
(mean, linear, MLP) and the quantized database are later slices
(ROADMAP Queue 1 items 3 and 6).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device

# Above this many train rows KNNLambdaPredictor.predict streams the
# database in chunks: the one-product form's (b, n_train) distance matrix
# is n_train * 4 bytes per query row.
KNN_CHUNK_THRESHOLD = 32_768


@dataclass(frozen=True)
class KNNLambdaPredictor:
    """Exact k-nearest-neighbour regressor, inverse-distance weighted.
    Its tensors live on one device; `predict` runs there."""

    X_db: torch.Tensor    # (n_train, d) f32
    lam_db: torch.Tensor  # (n_train, K) f32
    k: int

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

    def to(self, device) -> "KNNLambdaPredictor":
        dev = resolve_device(device)
        return KNNLambdaPredictor(X_db=self.X_db.to(dev),
                                  lam_db=self.lam_db.to(dev), k=self.k)

    def predict(self, X) -> torch.Tensor:
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
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


STATE_FIELDS = ("X_db", "lam_db")


def predictor_state(predictor: KNNLambdaPredictor) -> dict:
    """The predictor's array state as a flat dict of tensors."""
    return {f: getattr(predictor, f) for f in STATE_FIELDS}


def from_numpy(state: dict, k: int, device=None) -> KNNLambdaPredictor:
    """Build the port's KNN predictor from the arrays of a JAX predictor
    (`repro.core.predictors.predictor_state(knn)`, each converted with
    np.asarray): the weights carried across from the reference."""
    extra = set(state) - set(STATE_FIELDS)
    if extra:
        raise NotImplementedError(
            f"state fields {sorted(extra)}: the quantized KNN database is "
            f"not ported yet (ROADMAP Queue 1 item 6)")
    missing = set(STATE_FIELDS) - set(state)
    if missing:
        raise ValueError(f"KNN state lacks {sorted(missing)}")
    X_db = np.array(state["X_db"], np.float32)
    lam_db = np.array(state["lam_db"], np.float32)
    if X_db.ndim != 2 or lam_db.ndim != 2 or X_db.shape[0] != lam_db.shape[0]:
        raise ValueError(f"X_db {X_db.shape} and lam_db {lam_db.shape} must "
                         f"be 2-D with one row per train user")
    return KNNLambdaPredictor.fit(X_db, lam_db, k=k, device=device)
