"""Distributed top-k merge (counterpart of repro.distributed.topk).

When the KNN train-user database (or the item catalog) is split over a
mesh axis, each shard selects its local top-k and only those k
candidates (and their payload) are gathered to the merging device,
where a stable descending sort of the union in shard order takes the
top k, so ties go to the lowest global index as lax.top_k does on JAX's
all-gather. Nothing database-sized moves.

JAX writes the shard bodies inside shard_map, one program over the
mesh. Here one process drives the mesh (launch/mesh.py): `map_shards`
runs each (batch block, shard) body from the calling thread on its
shard's device. On the card a body whose device is not the caller's
runs on that device's side stream (one a device, kept), which first
waits on the caller's stream and which the caller's stream waits on
after; where the shard's
device is the caller's, it runs on the caller's own stream. Each body's
outputs are gathered to the merging device with one
`.to(device, non_blocking=True)`. `sharded_knn_topk`'s per-shard
selection is the `knn_topk` kernel on the card (two launches a shard)
and its plain version on the CPU.
"""

from __future__ import annotations

import functools

import torch

from repro_torch.kernels import ops
from repro_torch.launch.mesh import (
    Mesh,
    axis_size,
    block_coords,
    place,
    shard_device,
    shard_rows,
    split_dim,
)


def _take_last(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather on the LAST axis; idx (b, k) broadcasts over any leading
    payload dims (payloads may be (..., b, n))."""
    while idx.dim() < p.dim():
        idx = idx[None]
    return torch.gather(p, -1, idx.expand(p.shape[:-1] + idx.shape[-1:]))


def _merge_topk(values, indices, k: int, payload=None):
    """Merge (b, n_cand) candidate (value, global-index) pairs -> top-k,
    by a stable descending sort: equal values keep their order, so the
    candidates must come in shard order (lowest global index first)."""
    pos = torch.sort(values, dim=-1, descending=True, stable=True).indices
    pos = pos[..., :k]
    top_v = torch.gather(values, -1, pos)
    top_i = torch.gather(indices, -1, pos)
    if payload is None:
        return top_v, top_i
    sel = {name: _take_last(p, pos) for name, p in payload.items()}
    return top_v, top_i, sel


def gather_merge_top_k(local_v, local_i, k: int, payload=None, *,
                       device=None):
    """The collective half of distributed_top_k: each shard's already
    selected (value, GLOBAL index) candidates, (b, kk) each in shard
    order, with their payload slots (a dict of (..., b, kk) tensors a
    shard), gathered to `device` (None = the first shard's), joined in
    shard order along the last axis, then the top k of the union.
    Returns (values (b, k) descending, indices (b, k)[, payload])."""
    dev = local_v[0].device if device is None else device
    all_v = torch.cat([place(v, dev) for v in local_v], dim=-1)
    all_i = torch.cat([place(i, dev) for i in local_i], dim=-1)
    all_p = None
    if payload is not None:
        all_p = {name: torch.cat([place(p[name], dev) for p in payload],
                                 dim=-1) for name in payload[0]}
    return _merge_topk(all_v, all_i, k, all_p)


def local_top_k(scores: torch.Tensor, k: int, offset: int = 0,
                payload=None):
    """One shard's top min(k, n_local) of scores (b, n_local), ties to
    the lower index: (values, global int64 indices[, payload slots])."""
    kk = min(k, scores.shape[-1])
    order = torch.sort(scores, dim=-1, descending=True,
                       stable=True).indices[..., :kk]
    out = (torch.gather(scores, -1, order), order + offset)
    if payload is None:
        return out
    return out + ({name: _take_last(p, order)
                   for name, p in payload.items()},)


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return place(tree, device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return type(tree)(_to(v, device) for v in tree)


@functools.cache
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The one stream a card runs shard bodies on for another card's
    caller, made on first use and kept."""
    return torch.cuda.Stream(device=device)


def run_on_shard(device: torch.device, merge_device: torch.device, body):
    """body() on `device`, its outputs (tensors, tuples and dicts of
    them) gathered to merge_device. On the card a device that is not
    the merging one runs the body on its side stream, ordered after the
    caller's stream and before the caller's next work."""
    if device.type != "cuda" or device == merge_device:
        return _to(body(), merge_device)
    caller = (torch.cuda.current_stream(merge_device)
              if merge_device.type == "cuda" else None)
    stream = _side_stream(device)
    if caller is not None:
        stream.wait_stream(caller)
    with torch.cuda.device(device), torch.cuda.stream(stream):
        out = _to(body(), merge_device)
    if caller is not None:
        caller.wait_stream(stream)
    return out


def batch_axes_of(mesh: Mesh, batch_axes) -> tuple[str, ...]:
    """The batch axes the mesh has (JAX's filter of `batch_axes`)."""
    return tuple(a for a in batch_axes if a in mesh.axis_names)


def shard_bodies(mesh: Mesh, shard_axis: str | None, batch_axes) -> int:
    """Shard bodies one call runs: a body for each batch block and each
    shard of `shard_axis` (None: one shard). Axes in neither replicate
    the work in JAX; here their first position runs it, once."""
    return (axis_size(mesh, batch_axes_of(mesh, batch_axes))
            * axis_size(mesh, shard_axis))


def map_shards(mesh: Mesh, shard_axis: str | None, batch_axes,
               n_batch: int, body, merge_device: torch.device):
    """Run body(rows, shard, device) for every batch block (rows: the
    block's slice of the batch dimension) and every shard of
    `shard_axis` (None: one shard, 0), each on its device
    (run_on_shard). Returns, per batch block, (rows, [each shard's
    outputs on merge_device]). Every body is started before any merge,
    so bodies on different cards overlap."""
    axes = batch_axes_of(mesh, batch_axes)
    nb = axis_size(mesh, axes)
    rows_l = split_dim(n_batch, nb, f"batch over {axes}")
    out = []
    for bi in range(nb):
        rows = slice(bi * rows_l, (bi + 1) * rows_l)
        coords = block_coords(mesh, axes, bi)
        parts = []
        for si in range(axis_size(mesh, shard_axis)):
            at = coords if shard_axis is None else {**coords,
                                                    shard_axis: si}
            dev = shard_device(mesh, at)
            parts.append(run_on_shard(
                dev, merge_device,
                lambda si=si, dev=dev: body(rows, si, dev)))
        out.append((rows, parts))
    return out


def distributed_top_k(scores, k: int, global_offsets=None, payload=None,
                      *, device=None):
    """Local top-k on every shard -> gather -> re-top-k. `scores` is a
    sequence over the shard axis of (b, n_local) tensors, each on its
    shard's device, `payload` a matching sequence of dicts of
    (..., b, n_local) tensors that ride along (e.g. raw utilities and
    constraint rows when selecting by adjusted score).
    `global_offsets` are the shards' first global indices (default: the
    running sum of n_local). Returns (values (b, k) descending, global
    int64 indices (b, k)[, payload slots]) on `device` (None = the first
    shard's)."""
    if global_offsets is None:
        sizes = [s.shape[-1] for s in scores]
        global_offsets = [sum(sizes[:i]) for i in range(len(sizes))]
    dev = scores[0].device if device is None else device
    parts = [run_on_shard(s.device, dev, lambda i=i, s=s: local_top_k(
        s, k, global_offsets[i], None if payload is None else payload[i]))
        for i, s in enumerate(scores)]
    return gather_merge_top_k(
        [p[0] for p in parts], [p[1] for p in parts], k,
        None if payload is None else [p[2] for p in parts], device=dev)


def sharded_knn_topk(mesh: Mesh, xq: torch.Tensor, xdb, k: int, *,
                     shard_axis: str = "model", batch_axes=("pod", "data")):
    """k nearest database rows under squared L2, database split by rows
    over `shard_axis` (a tensor, or rows placed once by
    launch.mesh.shard_rows), queries (b, d) by batch over `batch_axes`.
    Each shard selects its k smallest d2 = max(|q|^2 - 2 q.x + |x|^2, 0)
    with `ops.knn_topk` (the kernel on the card, ties to the lower row);
    only k candidates a shard are gathered to the queries' device.
    Returns (d2 (b, k) ascending, idx (b, k) global int32)."""
    db = shard_rows(mesh, xdb, shard_axis)
    kk = min(k, db.rows)

    def body(rows, si, dev):
        d2, idx = ops.knn_topk(place(xq[rows], dev), db.local(si, dev),
                               k=kk, device=dev)
        return -d2, idx.to(torch.int64) + db.offsets[si]

    d2s, idxs = [], []
    for _, parts in map_shards(mesh, shard_axis, batch_axes, xq.shape[0],
                               body, xq.device):
        neg_v, idx = gather_merge_top_k([p[0] for p in parts],
                                        [p[1] for p in parts], k,
                                        device=xq.device)
        d2s.append(-neg_v)
        idxs.append(idx)
    return torch.cat(d2s), torch.cat(idxs).to(torch.int32)


def sharded_score_topk(mesh: Mesh, scores: torch.Tensor, k: int, *,
                       shard_axis: str = "model",
                       batch_axes=("pod", "data")):
    """Top-k over a candidate axis split over `shard_axis` (retrieval:
    10^6 candidates, k winners): scores (b, n) -> (values (b, k)
    descending, indices (b, k) int32), ties to the lower index."""
    n_l = split_dim(scores.shape[1], mesh.shape[shard_axis],
                    f"candidates over {shard_axis!r}")

    def body(rows, si, dev):
        s = place(scores[rows, si * n_l:(si + 1) * n_l], dev)
        return local_top_k(s, k, si * n_l)

    vals, idxs = [], []
    for _, parts in map_shards(mesh, shard_axis, batch_axes, scores.shape[0],
                               body, scores.device):
        v, i = gather_merge_top_k([p[0] for p in parts],
                                  [p[1] for p in parts], k,
                                  device=scores.device)
        vals.append(v)
        idxs.append(i)
    return torch.cat(vals), torch.cat(idxs).to(torch.int32)
