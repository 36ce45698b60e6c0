"""Distributed variants of the online serving stage (counterpart of
repro.core.serving_dist): the KNN database split by rows, or the
candidate axis split by items, over a mesh of torch.devices that one
process drives (launch/mesh.py). Each shard selects its own top k (or
m2) and only those candidates, with their payload, are gathered to the
merging device (the device of the queries, or of u), where the merge
and the weighting or the audit run:

  knn_predict_distributed        per-shard KNN selection -> merge -> IDW
  knn_predict_quant_distributed  the same over a quantized pack
  rank_distributed               adjusted scores + top-m2 with the item
                                 axis split (serve_retrieval's 2^20)
  serve_partitioned              configs.paper's default serve program
                                 partitioned: the first and the third's
                                 shard bodies at every mesh position,
                                 each shard's candidates all-gathered
                                 over its group and merged there

Exact KNN and exact top-k: the merged selection is the dense one, ties
to the lowest global index.

Per-shard work on the card:
  - `knn_predict_distributed`: the `knn_topk` kernel (two launches a
    shard; its plain version on the CPU); the merged rows' |x|^2 and
    the queries' |q|^2 in kernels.common.sq_norm_seq's order, as the
    knn_lambda kernel forms them, so the result is ops.knn_lambda's.
  - `rank_distributed`: the `fused_rank` kernel (one launch a shard)
    when m2 <= MAX_KERNEL_M2, which then also bounds each shard's
    kk = min(m2, m1 local); above it the sort route as torch ops on
    every device, as the dense dispatcher chooses its route by m2: the
    merged perm is then the dense route's, the einsum score (the
    rank_by_sort of rank_given_lambda) above MAX_KERNEL_M2 and the
    kernel's axpy score at or below it.
  - `knn_predict_quant_distributed`: core.predictors.knn_quant_scan as
    torch ops on every device (no kernel returns the exact-on-x~
    selection yet: ROADMAP Queue 2).
`dist_kernel_launches` gives a call's launches by kernel.
"""

from __future__ import annotations

import torch

from repro_torch.core.assignment import rank_by_sort
from repro_torch.core.predictors import _idw_lambda, knn_quant_scan
from repro_torch.core.ranking import AUDIT_TOL, RankingOutput, audit_selected
from repro_torch.distributed.sharding import drop_nondivisible
from repro_torch.distributed.topk import (
    all_gather_dim,
    assemble,
    each_position,
    gather_merge_top_k,
    map_shards,
    merge_top_k,
    position_blocks,
    positions,
    shard_bodies,
)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.common import sq_norm_seq
from repro_torch.kernels.fused_rank import MAX_KERNEL_M2
from repro_torch.launch.mesh import (
    Mesh,
    axis_size,
    block_of,
    place,
    shard_rows,
    spec_entries,
    split_dim,
)


def _knn_shard(xq, xdb, offset: int, kk: int, lam=None):
    """One database shard's top kk rows for the queries xq (b, d):
    ops.knn_topk (the kernel on the card, its plain version on the CPU)
    over the shard's rows xdb, which start at global row `offset`.
    Returns (-d2 (b, kk), global int64 idx, payload {"y2": the winners'
    |x|^2 in sq_norm_seq's order[, "lam": their rows of the shard's
    `lam` as (K, b, kk)]})."""
    d2, idx = ops.knn_topk(xq, xdb, k=kk, device=xq.device)
    idx = idx.to(torch.int64)
    pay = {"y2": sq_norm_seq(xdb[idx])}
    if lam is not None:
        pay["lam"] = lam[idx].movedim(-1, 0)
    return -d2, idx + offset, pay


def _knn_merge_idw(parts_by_block, k, x2_fn, lam_db, dev):
    """Merge each batch block's shard candidates (-d2, global idx, {y2})
    and weight the k winners: lambda-hat (B, K)."""
    out = []
    for rows, parts in parts_by_block:
        neg_d2, idx, sel = gather_merge_top_k(
            [p[0] for p in parts], [p[1] for p in parts], k,
            [p[2] for p in parts], device=dev)
        out.append(_idw_lambda(-neg_d2, x2_fn(rows), sel["y2"],
                               lam_db[idx]))
    return torch.cat(out)


def knn_predict_distributed(mesh: Mesh, X_db, lam_db: torch.Tensor,
                            X: torch.Tensor, *, k: int = 10,
                            db_axis: str = "model",
                            batch_axes=("pod", "data"),
                            chunk: int = 8192) -> torch.Tensor:
    """Inverse-distance-weighted KNN regression, database split by rows
    over `db_axis` (a tensor, or rows placed once by
    launch.mesh.shard_rows), queries X (B, d) by batch over
    `batch_axes`: the same weighting and relative exact-match override
    as core.predictors.knn_predict. Each shard selects its local top
    min(k, n_local) with ops.knn_topk (the kernel on the card, its plain
    version on the CPU); their |x|^2 ride the merge as a payload; lam_db
    (n_db, K) is read on the merging device only, by the k winners'
    global rows. `chunk` is JAX's slab size and is not used: the
    selection's sweep picks its own."""
    db = shard_rows(mesh, X_db, db_axis)
    dev = X.device
    lam_db = place(lam_db, dev)
    kk = min(k, db.rows)

    def body(rows, si, sdev):
        return _knn_shard(place(X[rows], sdev), db.local(si, sdev),
                          db.offsets[si], kk)

    parts = map_shards(mesh, db_axis, batch_axes, X.shape[0], body, dev)
    return _knn_merge_idw(parts, k, lambda rows: sq_norm_seq(X[rows])[:, None],
                          lam_db, dev)


def knn_predict_quant_distributed(mesh: Mesh, X_q, q_scale, y2_q,
                                  lam_db: torch.Tensor, X: torch.Tensor, *,
                                  k: int = 10, mode: str = "int8",
                                  db_axis: str = "model",
                                  batch_axes=("pod", "data")) -> torch.Tensor:
    """knn_predict_distributed over a QUANTIZED db split by rows: each
    shard runs the quantized sweep and the exact f32 survivor re-score
    (core.predictors.knn_quant_scan) on its rows, so the values that are
    merged are already exact on x~, and the merge and the weighting
    (|q|^2 in sq_norm_seq's order and y2_q, as core.predictors.quant_idw)
    are the f32 path's. The result matches knn_predict_quant's.

    Contract: pack with pack_knn_db at a slab that divides the per-shard
    row count, so the pack splits with no pad rows (X_q.shape[0] ==
    lam_db.shape[0]) and each shard holds whole slabs with their scales.

    TODO(ROADMAP Queue 2): a kernel for the per-shard exact-on-x~
    selection; today it is torch ops on every device."""
    if X_q.shape[0] != lam_db.shape[0]:
        raise ValueError(
            f"sharded quantized db must carry no pad rows: X_q has "
            f"{X_q.shape[0]} rows but lam_db {lam_db.shape[0]} — pack "
            f"with a slab dividing the per-shard row count")
    dbq = shard_rows(mesh, X_q, db_axis)
    scales = shard_rows(mesh, q_scale, db_axis)
    y2s = shard_rows(mesh, y2_q, db_axis)
    dev = X.device
    lam_db = place(lam_db, dev)
    kk = min(k, dbq.rows)

    def body(rows, si, sdev):
        xq = place(X[rows], sdev).to(torch.float32)
        y2_l = y2s.local(si, sdev)
        d2, idx, _ = knn_quant_scan(dbq.local(si, sdev),
                                    scales.local(si, sdev), y2_l, xq,
                                    k=kk, mode=mode, device=sdev)
        return -d2, idx + dbq.offsets[si], {"y2": y2_l[idx, 0]}

    parts = map_shards(mesh, db_axis, batch_axes, X.shape[0], body, dev)
    return _knn_merge_idw(
        parts, k,
        lambda rows: sq_norm_seq(X[rows].to(torch.float32))[:, None],
        lam_db, dev)


def _shard_scores(u_l, a_l, lam_l, m2: int, kk: int, eps: float, dev):
    """One item shard's top kk by adjusted score: the fused_rank kernel
    (its plain version on the CPU) for m2 <= MAX_KERNEL_M2, else the
    oracle's einsum score and a stable sort as torch ops."""
    if m2 <= MAX_KERNEL_M2:
        return ops.fused_rank(u_l, a_l, lam_l, m2=kk, eps=eps, device=dev)
    s = ref.dual_adjust_ref(u_l, a_l, lam_l, eps)
    idx = rank_by_sort(s, kk)
    return torch.gather(s, 1, idx.long()), idx


def _rank_shard(u_l, a_l, lam_l, offset: int, m2: int, kk: int,
                eps: float):
    """One item shard's candidates: its top kk by adjusted score
    (_shard_scores) over u_l (b, m1_l), a_l (b, K, m1_l), whose first
    item is global item `offset`, with their raw utilities and K
    constraint rows as payload: (vals, global int64 idx, {"u": (b, kk),
    "a": (K, b, kk)})."""
    vals, idx = _shard_scores(u_l, a_l, lam_l, m2, kk, eps, u_l.device)
    idx = idx.to(torch.int64)
    a_sel = torch.gather(a_l, 2, idx[:, None, :].expand(-1, a_l.shape[1],
                                                        -1))
    return vals, idx + offset, {"u": torch.gather(u_l, 1, idx),
                                "a": a_sel.movedim(1, 0)}


def _audit(perm, sel, gamma, b, tol: float):
    """The merged m2 winners' audit: (perm, utility, exposure,
    compliant), gamma (m2,) or (n, m2), b (K,) or (n, K)."""
    n, K = perm.shape[0], sel["a"].shape[0]
    b_r = b if b.dim() == 2 else b.expand(n, K)
    g_r = gamma if gamma.dim() == 2 else gamma.expand(n, perm.shape[1])
    return (perm, *audit_selected(sel["u"], sel["a"].movedim(0, 1), g_r,
                                  b_r, tol=tol))


def rank_distributed(mesh: Mesh, u: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, lam: torch.Tensor,
                     gamma: torch.Tensor, *, m2: int, eps: float = 1e-4,
                     item_axis: str = "model", batch_axes=("pod", "data"),
                     tol: float = AUDIT_TOL) -> RankingOutput:
    """Online ranking with the item axis split over `item_axis`: u (B,
    m1), a (K, m1) shared or (B, K, m1) per request, b (K,) or (B, K),
    lam (B, K), gamma (m2,) or (B, m2). Each item shard scores its
    items and keeps its top kk = min(m2, m1 local); the m2 * shards
    candidates, with their raw utilities and K constraint rows as
    payload, are merged on u's device, and the merged payload feeds
    the audit (core.ranking.audit_selected). A shared `a` is expanded to
    the shard's rows there, as JAX's body broadcasts it. Returns a
    RankingOutput (perm int32, ties to the lowest global index)."""
    dev = u.device
    B, m1 = u.shape
    K = a.shape[-2]
    m1_l = split_dim(m1, mesh.shape[item_axis], f"items over {item_axis!r}")
    if not 1 <= m2 <= m1:
        raise ValueError(f"need 1 <= m2 <= m1, got m2={m2}, m1={m1}")
    kk = min(m2, m1_l)

    def body(rows, si, sdev):
        cols = slice(si * m1_l, (si + 1) * m1_l)
        u_l = place(u[rows, cols], sdev).contiguous()
        if a.dim() == 3:
            a_l = place(a[rows, :, cols], sdev).contiguous()
        else:
            a_l = place(a[:, cols], sdev).expand(
                u_l.shape[0], K, m1_l).contiguous()
        return _rank_shard(u_l, a_l, place(lam[rows], sdev), si * m1_l, m2,
                           kk, eps)

    outs = []
    for rows, parts in map_shards(mesh, item_axis, batch_axes, B, body,
                                  dev):
        _, perm, sel = gather_merge_top_k(
            [p[0] for p in parts], [p[1] for p in parts], m2,
            [p[2] for p in parts], device=dev)
        outs.append(_audit(perm, sel, gamma[rows] if gamma.dim() == 2
                           else gamma, b[rows] if b.dim() == 2 else b, tol))
    perm, utility, exposure, compliant = (torch.cat(x) for x in zip(*outs))
    return RankingOutput(perm=perm.to(torch.int32), utility=utility,
                         exposure=exposure, compliant=compliant, lam=lam)


def serve_partitioned(mesh: Mesh, rules, X, u, a, b, X_db, lam_db,
                      gamma: torch.Tensor, *, k: int, m2: int,
                      eps: float = 1e-4,
                      tol: float = AUDIT_TOL) -> RankingOutput:
    """The paper's serve cell, default variant, partitioned over `mesh`
    by `rules` (PAPER_RULES): X (B, d) by ('batch', None), u (B, m1) by
    ('batch', 'items'), a (B, K, m1) by ('batch', None, 'items'), b (K,)
    replicated, X_db (n_db, d) and lam_db (n_db, K) by ('users_db',
    None), each spec relaxed as drop_nondivisible relaxes it; each
    argument a tensor (laid by its spec here) or a Sharded laid so.
    One body a mesh position (p, d, m): the KNN shard body over its
    batch block and database block m (_knn_shard, its winners' |x|^2
    and lambda rows as payload), the candidates all-gathered over the
    database's axes and merged to k, the weighting (identical at every
    position of the group); then the rank shard body over item block m
    (_rank_shard), the candidates all-gathered over the items' axes,
    merged to m2 and audited. Every position of a group merges the same
    candidates in block order, so its replicas hold the same bits, and
    the dist-topk variant's (rank_distributed after
    knn_predict_distributed) on the same arrays. Returns a RankingOutput
    whose fields are Sharded over the users by the batch axes."""
    B, m1 = u.shape[0], u.shape[1]
    n_db, K = lam_db.shape[0], lam_db.shape[1]
    if not 1 <= m2 <= m1:
        raise ValueError(f"need 1 <= m2 <= m1, got m2={m2}, m1={m1}")
    bat, items = spec_entries(drop_nondivisible(
        rules.resolve("batch", "items"), (B, m1), mesh), 2)
    db_ax = spec_entries(drop_nondivisible(rules.resolve("users_db"),
                                           (n_db,), mesh), 1)[0]
    n_l, m1_l = n_db // axis_size(mesh, db_ax), m1 // axis_size(mesh, items)
    pos = positions(mesh)
    xs = position_blocks(mesh, X, (bat, None), "X")
    us = position_blocks(mesh, u, (bat, items), "u")
    as_ = position_blocks(mesh, a, (bat, None, items), "a")
    bs = position_blocks(mesh, b, (), "b")
    dbs = position_blocks(mesh, X_db, (db_ax, None), "X_db")
    lams = position_blocks(mesh, lam_db, (db_ax, None), "lam_db")

    def offset(i, axes, size):
        return block_of(mesh, (axes,), pos[i])[0] * size

    def knn(i, dev):
        return _knn_shard(xs[i], dbs[i], offset(i, db_ax, n_l),
                          min(k, n_l), lams[i])

    knn_cand = _gather_candidates(mesh, db_ax, each_position(mesh, knn))

    def weigh(i, dev):
        vals, idx, pay = knn_cand[i]
        neg_d2, _, sel = merge_top_k(vals, idx, k, pay)
        return _idw_lambda(-neg_d2, sq_norm_seq(xs[i])[:, None], sel["y2"],
                           sel["lam"].movedim(0, -1))

    lam_hat = each_position(mesh, weigh)

    def rank(i, dev):
        return _rank_shard(us[i].contiguous(), as_[i].contiguous(),
                           lam_hat[i], offset(i, items, m1_l), m2,
                           min(m2, m1_l), eps)

    rank_cand = _gather_candidates(mesh, items, each_position(mesh, rank))

    def audit(i, dev):
        vals, idx, pay = rank_cand[i]
        _, perm, sel = merge_top_k(vals, idx, m2, pay)
        return _audit(perm.to(torch.int32), sel, place(gamma, perm.device),
                      bs[i], tol)

    outs = each_position(mesh, audit)
    spec = (bat,)
    perm, utility, exposure, compliant = (
        assemble(mesh, [o[j] for o in outs], spec, shape)
        for j, shape in enumerate(((B, m2), (B,), (B, K), (B,))))
    return RankingOutput(perm=perm, utility=utility, exposure=exposure,
                         compliant=compliant,
                         lam=assemble(mesh, lam_hat, spec, (B, K)))


def _gather_candidates(mesh: Mesh, axes, parts: list) -> list:
    """Each position's (values, global idx, payload) candidates joined
    with its group's over `axes`, in block order along the last dim
    (distributed.topk.all_gather_dim): the union every position of the
    group then merges alike."""
    def gather(xs):
        return all_gather_dim(mesh, axes, xs, dim=-1)
    vals, idx = gather([p[0] for p in parts]), gather([p[1] for p in parts])
    pay = {name: gather([p[2][name] for p in parts]) for name in parts[0][2]}
    return [(vals[i], idx[i], {name: pay[name][i] for name in pay})
            for i in range(len(parts))]


def dist_kernel_launches(predictor, m2: int, *, mesh: Mesh,
                         item_axis: str = "model",
                         batch_axes=("pod", "data"),
                         device=None) -> dict[str, int]:
    """Kernel launches, by kernel, of one micro-batch of the engine's
    `dist` executor: lambda-hat (KNN: `knn_lambda`, or
    `knn_lambda_quant` over a pack, 2; given, affine or MLP: torch ops,
    0), then `rank_distributed` (`fused_rank` once a shard body for
    m2 <= MAX_KERNEL_M2, else the sort route's torch ops). Empty where
    the plain path runs (a CPU device). A count of the route, not a
    run: it needs no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return {}
    out = {}
    if ops.route_of(predictor) == "knn":
        out["knn_lambda" if predictor.X_q is None else "knn_lambda_quant"] = 2
    if m2 <= MAX_KERNEL_M2:
        out["fused_rank"] = shard_bodies(mesh, item_axis, batch_axes)
    return out
