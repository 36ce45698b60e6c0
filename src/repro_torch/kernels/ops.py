"""Dispatcher of the online stage (counterpart of repro.kernels.ops):
routes a micro-batch to its kernel by predictor and returns a complete
RankingOutput.

Routes of the online stage, with their launches per micro-batch on the
card:
  predictor=None  lambda given: `rank_audited`, one launch;
  mean, linear    `linear_rank_audited`, one launch (lambda-hat = X W^T + c
                  in the prologue; mean is W = 0 with the clamp off);
  KNN             `knn_rank_audited`, two launches (distance sweep, then
                  merge + weighting + rank + audit);
  KNN, knn_chain  `knn_lambda` (two launches) then `rank_audited` (one):
                  three launches where the TPU chain took two;
  MLP, any other  lambda-hat = predictor.predict(X) as torch ops, zero-
                  padded to a's K, then `rank_audited`, one launch.
A KNN predictor that carries a quantized db (`quant` "int8" or "bf16")
takes the same routes through the quantized twins,
`knn_rank_audited_quant` and `knn_lambda_quant`, with the same launch
counts.
For m2 > MAX_KERNEL_M2 every route takes the JAX dispatcher's XLA
route, chosen by m2 alone and on every device: lambda-hat first (given;
X W^T + c as torch ops for mean and linear; the MLP's predict;
`knn_lambda` or `knn_lambda_quant` for KNN, two launches on the card),
then
core.ranking.rank_given_lambda's einsum score, stable sort and audit as
torch ops (no launch). `fused_rank` takes the same sort.
`lambda_hat` gives a micro-batch's lambda-hat as the chained routes
compute it (the serving engine's `dist` executor ranks after it).
The kernel library's other entry points, as `repro.kernels` exports
them: `knn_topk` (two launches), `knn_predict_kernel` (`knn_topk`, then
the inverse-distance weighting as torch ops) and `embedding_bag` (one).
Every entry point takes `device` (None = the card). On the card a route
launches its kernel or raises; only `device="cpu"` runs the plain
PyTorch versions. Nothing is padded per call beyond the affine
predictor's W and c to the problem's K (the serving engine builds those
once per bucket): the kernels mask ragged edges themselves, and the
1M-row KNN database (or its pack) is passed as it lies.
"""

from __future__ import annotations

import torch

from repro_torch.core.assignment import rank_by_sort
from repro_torch.core.predictors import (
    KNNLambdaPredictor,
    LinearLambdaPredictor,
    MeanLambdaPredictor,
    _idw_lambda,
    check_pack,
    pack_knn_db,
    with_state,
)
from repro_torch.core.ranking import (
    AUDIT_TOL,
    RankingOutput,
    rank_given_lambda,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ref
from repro_torch.kernels.common import QUANT_EXTRA, QUANT_MODES
from repro_torch.kernels.embedding_bag import embedding_bag_cuda
from repro_torch.kernels.fused_rank import (
    MAX_KERNEL_M2,
    fused_rank_cuda,
    linear_rank_audited_cuda,
    rank_audited_cuda,
)
from repro_torch.kernels.knn_topk import (
    knn_lambda_cuda,
    knn_lambda_quant_cuda,
    knn_rank_audited_cuda,
    knn_rank_audited_quant_cuda,
    knn_topk_cuda,
)


def _f32(x, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=dev).contiguous()


def _f32_or_bf16(x, dev: torch.device) -> torch.Tensor:
    """x contiguous on `dev`: bf16 if it is bf16, f32 otherwise."""
    x = torch.as_tensor(x, device=dev)
    if x.dtype != torch.bfloat16:
        x = x.to(torch.float32)
    return x.contiguous()


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


def fused_rank(u, a, lam, *, m2: int, eps: float = 1e-4, device=None):
    """Adjusted-score top-m2: u (n, m1), a (n, K, m1), lam (n, K) ->
    (vals (n, m2) desc f32, idx (n, m2) int32), ties to the lower item
    index. The `fused_rank` kernel for m2 <= MAX_KERNEL_M2; above it the
    oracle's einsum score and a stable sort, on any device."""
    dev = resolve_device(device)
    u, a, lam = _f32(u, dev), _f32(a, dev), _f32(lam, dev)
    if m2 <= MAX_KERNEL_M2:
        return fused_rank_cuda(u, a, lam, m2=m2, eps=eps, device=dev)
    s = ref.dual_adjust_ref(u, a, lam, eps)
    idx = rank_by_sort(s, m2)
    return torch.gather(s, 1, idx.long()), idx


def rank_audited(u, a, b, lam, gamma, *, m2: int, eps: float = 1e-4,
                 tol: float | None = None, device=None) -> RankingOutput:
    """Rank + audit with lambda given: u (n, m1), a (n, K, m1) or
    (K, m1), b (n, K) or (K,), lam (n, K), gamma (n, m2) or (m2,). The
    `rank_audited` kernel for m2 <= MAX_KERNEL_M2; above it
    core.ranking.rank_given_lambda's torch body, on any device."""
    dev = resolve_device(device)
    tol = AUDIT_TOL if tol is None else tol
    u, a, b, gamma = _rank_inputs(u, a, b, gamma, dev)
    lam = _f32(lam, dev)
    if m2 > MAX_KERNEL_M2:
        return rank_given_lambda(u, a, b, lam, gamma, m2=m2, eps=eps,
                                 tol=tol)
    _, idx, util, expo, comp = rank_audited_cuda(
        u, a, b, lam, gamma, m2=m2, eps=eps, tol=tol, device=dev)
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
    for the f32 db). For m2 > MAX_KERNEL_M2 lambda-hat comes from
    `knn_lambda` (or `knn_lambda_quant`) and the sort route ranks."""
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
    K = a.shape[1]
    ref.check_pred_width(lam_db.shape[1], K)
    guard = None
    pack = None
    if quant != "off":
        pack = _quant_db(X_db, X_q, q_scale, y2_q, quant=quant, dev=dev)
    if m2 > MAX_KERNEL_M2:
        if pack is None:
            lam = knn_lambda_cuda(X, X_db, lam_db, k=k, device=dev)
        else:
            lam, guard = knn_lambda_quant_cuda(X, *pack, lam_db, k=k,
                                               k_extra=k_extra, mode=quant,
                                               device=dev)
        lam = torch.nn.functional.pad(lam, (0, K - lam.shape[1]))
        out = rank_given_lambda(u, a, b, lam, gamma, m2=m2, eps=eps,
                                tol=tol)
    else:
        if pack is None:
            _, idx, util, expo, comp, lam = knn_rank_audited_cuda(
                X, X_db, lam_db, u, a, b, gamma, k=k, m2=m2, eps=eps,
                tol=tol, device=dev)
        else:
            _, idx, util, expo, comp, lam, guard = \
                knn_rank_audited_quant_cuda(
                    X, *pack, lam_db, u, a, b, gamma, k=k, k_extra=k_extra,
                    mode=quant, m2=m2, eps=eps, tol=tol, device=dev)
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


def knn_topk(xq, xdb, *, k: int = 10, device=None):
    """The k nearest rows of xdb (N, D) for each query xq (B, D) under
    squared L2 -> (d2 (B, k) ascending f32, idx (B, k) int32), ties to
    the lower index: the `knn_topk` kernel on the card, its plain
    version on the CPU. A bf16 operand stays bf16 until the wrapper
    widens it; any other type is taken as f32."""
    dev = resolve_device(device)
    return knn_topk_cuda(_f32_or_bf16(xq, dev), _f32_or_bf16(xdb, dev),
                         k=k, device=dev)


def knn_predict_kernel(X_db, lam_db, X, *, k: int = 10, device=None):
    """Kernel-backed twin of core.predictors.knn_predict: X (B, d) or
    (d,) -> lambda-hat (B, K) or (K,). `knn_topk` selects the k nearest
    rows, then the inverse-distance weighting with the exact-match
    override (core.predictors._idw_lambda) runs as torch ops on the
    winners, as the JAX twin runs it in XLA."""
    dev = resolve_device(device)
    X, X_db, lam_db = _f32(X, dev), _f32(X_db, dev), _f32(lam_db, dev)
    squeeze = X.dim() == 1
    Xq = torch.atleast_2d(X)
    d2, idx = knn_topk(Xq, X_db, k=k, device=dev)
    idx = idx.long()
    rows = X_db[idx]
    out = _idw_lambda(d2, torch.sum(Xq * Xq, dim=-1, keepdim=True),
                      torch.sum(rows * rows, dim=-1), lam_db[idx])
    return out[0] if squeeze else out


def embedding_bag(table, indices, weights=None, *, device=None):
    """Sum-mode EmbeddingBag: table (V, D) f32 or bf16 (any other type is
    taken as f32), indices (n_bags, bag) with entries < 0 padding,
    weights (n_bags, bag) or None -> (n_bags, D) in the table's type:
    the `embedding_bag` kernel on the card, its plain version on the
    CPU."""
    dev = resolve_device(device)
    indices = torch.as_tensor(indices, device=dev).to(torch.int32)
    if weights is not None:
        weights = _f32(weights, dev)
    return embedding_bag_cuda(_f32_or_bf16(table, dev),
                              indices.contiguous(), weights, device=dev)


def linear_rank_audited(X, W, c, u, a, b, gamma, *, relu: bool, m2: int,
                        eps: float = 1e-4, tol: float | None = None,
                        device=None) -> RankingOutput:
    """The affine online stage: lambda-hat = X W^T + c (clamped at 0 if
    `relu`), then rank + audit. X (n, d), W (K, d) and c (K,) already
    padded to a's K rows (`ref.affine_params`); u, a, b, gamma as in
    `rank_audited`. For m2 > MAX_KERNEL_M2 lambda-hat is the kernel
    prologue's arithmetic as torch ops (`ref.affine_lambda_ref`) and the
    sort route ranks."""
    dev = resolve_device(device)
    tol = AUDIT_TOL if tol is None else tol
    u, a, b, gamma = _rank_inputs(u, a, b, gamma, dev)
    X, W, c = _f32(X, dev), _f32(W, dev), _f32(c, dev)
    if X.shape[0] != u.shape[0]:
        raise ValueError(f"X carries {X.shape[0]} covariate rows but the "
                         f"problem has {u.shape[0]} users")
    if m2 > MAX_KERNEL_M2:
        lam = ref.affine_lambda_ref(X, W, c, relu)
        return rank_given_lambda(u, a, b, lam, gamma, m2=m2, eps=eps,
                                 tol=tol)
    _, idx, util, expo, comp, lam = linear_rank_audited_cuda(
        u, a, b, X, W, c, gamma, m2=m2, eps=eps, tol=tol, relu=relu,
        device=dev)
    return RankingOutput(perm=idx, utility=util, exposure=expo,
                         compliant=comp, lam=lam)


def route_of(predictor) -> str:
    """The route a predictor's batches take: 'lam' (None), 'affine'
    (mean, linear), 'knn', or 'mlp' for the MLP and any other family
    that has a `predict` (as the JAX dispatcher's "mlp / other")."""
    if predictor is None:
        return "lam"
    if isinstance(predictor, KNNLambdaPredictor):
        return "knn"
    if isinstance(predictor, (LinearLambdaPredictor,
                              MeanLambdaPredictor)):
        return "affine"
    if not callable(getattr(predictor, "predict", None)):
        raise TypeError(f"{type(predictor).__name__} is no predictor: it "
                        f"has no predict(X)")
    return "mlp"


def lambda_hat(X, predictor, K: int, *, affine=None, device=None):
    """A micro-batch's lambda-hat (n, K) as the chained routes compute
    it, zero-padded to K constraint rows: given (predictor None: X
    holds it); mean and linear by the linear kernel's prologue
    arithmetic (`ref.affine_lambda_ref` on `affine`, the (W, c, relu)
    padded to K, built here when None), so it equals that kernel's
    bitwise; the MLP's (or any other family's) predict; KNN by
    `knn_lambda`, or `knn_lambda_quant` over the predictor's pack."""
    route = route_of(predictor)
    if route == "lam":
        return X
    if route == "affine":
        if affine is None:
            affine = ref.affine_params(predictor, X.shape[1], K)
        return ref.affine_lambda_ref(X, *affine)
    if route == "mlp":
        return ref.predicted_lambda(predictor, X, K)
    ref.check_pred_width(predictor.num_constraints, K)
    quant = predictor.quant if predictor.X_q is not None else "off"
    lam = knn_lambda(X, predictor.X_db, predictor.lam_db, k=predictor.k,
                     quant=quant, X_q=predictor.X_q,
                     q_scale=predictor.q_scale, y2_q=predictor.y2_q,
                     device=device)
    return torch.nn.functional.pad(lam, (0, K - lam.shape[1]))


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
    (its static `quant` picks the route). The MLP, or any other family
    with a `predict`, computes lambda-hat = predictor.predict(X) as torch
    ops, zero-pads it to a's K and runs `rank_audited`. `affine` is an
    affine predictor's (W, c, relu) already padded to a's K rows
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
    if route == "knn" and not knn_chain:
        quant = predictor.quant if predictor.X_q is not None else "off"
        return knn_rank_audited(X, predictor.X_db, predictor.lam_db, u, a,
                                b, gamma, k=predictor.k, m2=m2, eps=eps,
                                tol=tol, device=device, quant=quant,
                                X_q=predictor.X_q, q_scale=predictor.q_scale,
                                y2_q=predictor.y2_q)
    lam = lambda_hat(X, predictor, a.shape[-2], device=device)
    return rank_audited(u, a, b, lam, gamma, m2=m2, eps=eps, tol=tol,
                        device=device)


def predict_rank_audited_stateful(state: dict, predictor, X, u, a, b,
                                  gamma, **kw) -> RankingOutput:
    """predict_rank_audited with the predictor's array state passed
    apart from it (core.predictors.predictor_state): the predictor is
    the template whose family and non-array fields (KNN's k, its quant
    mode) pick the route, `state` the arrays it serves with. The seam
    through which a refresh swaps a predictor's state in."""
    return predict_rank_audited(X, with_state(predictor, state), u, a, b,
                                gamma, **kw)


def kernel_launch_count(predictor, m2: int, *, device=None,
                        knn_chain: bool = False) -> int:
    """Kernel launches one dispatcher call makes, by route: 1 for the
    lambda-given route (`predictor=None`), for mean and linear and for
    the MLP (its lambda-hat is torch ops, then `rank_audited`), 2 for
    KNN, 3 for KNN with `knn_chain`, over the f32 or the quantized db
    alike; 0 where the plain PyTorch path runs (a CPU device). For
    m2 > MAX_KERNEL_M2 the ranking is torch ops: 2 for KNN, fused or
    chain (its lambda-hat from `knn_lambda` or `knn_lambda_quant`), 0
    for the other routes. The JAX dispatcher's count there is 0 on every
    route, since its lambda-hat is computed in XLA. A count of the
    route, not a run: it needs no card."""
    dev = torch.device("cuda" if device is None else device)
    route = route_of(predictor)
    if dev.type != "cuda":
        return 0
    if route == "knn":
        return 3 if knn_chain and m2 <= MAX_KERNEL_M2 else 2
    return 1 if m2 <= MAX_KERNEL_M2 else 0
