"""Shadow-price predictors f(X) -> lambda (counterpart of
repro.core.predictors): the paper's mean baseline, its KNN regressor
and the ridge-regression linear family.

The KNN estimator is sklearn's KNN regressor with inverse-distance
weights (k = 10, Euclidean), computed by brute force: d2(x, xi) =
|x|^2 - 2 x.xi + |xi|^2, then the k smallest with ties to the lowest
database index, then the weights of `_idw_lambda`. The MLP family and
the quantized KNN database are later slices (ROADMAP Queue 1 items 3
and 6).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.device import resolve_device

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


# The array fields of each ported family: the state a predictor carries
# across from the JAX package and swaps in place.
STATE_FIELDS = {
    MeanLambdaPredictor: ("mean_lam",),
    KNNLambdaPredictor: ("X_db", "lam_db"),
    LinearLambdaPredictor: ("W", "c"),
}


def state_fields(predictor) -> tuple:
    """The array fields of the predictor's family (empty for a family
    this package does not know)."""
    return STATE_FIELDS.get(type(predictor), ())


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


def from_numpy(state: dict, k: int | None = None, device=None):
    """Build the port's predictor from the arrays of a JAX predictor
    (`repro.core.predictors.predictor_state(p)`, each converted with
    np.asarray): the weights carried across from the reference. The
    family follows from the keys: {X_db, lam_db} is KNN (and needs k),
    {W, c} linear, {mean_lam} mean."""
    keys = set(state)
    if {"X_db", "lam_db"} < keys:
        raise NotImplementedError(
            f"state fields {sorted(keys - {'X_db', 'lam_db'})}: the "
            f"quantized KNN database is not ported yet (ROADMAP Queue 1 "
            f"item 6)")
    if keys not in ({"mean_lam"}, {"W", "c"}, {"X_db", "lam_db"}):
        raise NotImplementedError(
            f"state fields {sorted(keys)}: only the mean, linear and KNN "
            f"families are ported; the MLP family is ROADMAP Queue 1 item 3")
    arrays = {f: np.array(v, np.float32) for f, v in state.items()}
    if keys == {"mean_lam"}:
        mean_lam = arrays["mean_lam"]
        if mean_lam.ndim != 1:
            raise ValueError(f"mean_lam {mean_lam.shape} must be 1-D")
        return MeanLambdaPredictor(
            mean_lam=_f32(mean_lam, resolve_device(device)))
    if keys == {"W", "c"}:
        W, c = arrays["W"], arrays["c"]
        if W.ndim != 2 or c.shape != (W.shape[0],):
            raise ValueError(f"W {W.shape} and c {c.shape} must be (K, d) "
                             f"and (K,)")
        dev = resolve_device(device)
        return LinearLambdaPredictor(W=_f32(W, dev), c=_f32(c, dev))
    X_db, lam_db = arrays["X_db"], arrays["lam_db"]
    if X_db.ndim != 2 or lam_db.ndim != 2 or X_db.shape[0] != lam_db.shape[0]:
        raise ValueError(f"X_db {X_db.shape} and lam_db {lam_db.shape} must "
                         f"be 2-D with one row per train user")
    if k is None:
        raise ValueError("a KNN state needs k")
    return KNNLambdaPredictor.fit(X_db, lam_db, k=k, device=device)
