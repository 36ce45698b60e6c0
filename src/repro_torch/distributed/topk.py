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

The mesh collectives of a partitioned program (models.gnn's step) are
here too, as torch.autograd.Functions over the blocks of a mesh axis
group: `all_gather_rows`, `reduce_scatter_rows` (a sum, or a max) and
`psum`. Each takes one block a shard, in the shard order of
`each_block` (block_coords' order along the axes), each on its shard's
device, and returns one a shard, each on its shard's device. Every sum
runs in shard order on the device that keeps it, and each backward is
written by hand (an all-gather's is the reduce-scatter, a
reduce-scatter's the all-gather, a psum's a psum), so a step's bits do
not depend on the order in which several devices' gradients reach a
tensor: a mesh across cards gives a virtual mesh's bits. `sum_to`
sums the shards' tensors onto one device (a replicated step's
gradients), with no backward.

The partitioned LM (models.transformer.lm_plan) runs one body a mesh
position, and its collectives take a list of one tensor a position
(row-major over the mesh's axes, `positions`) and act within each
position's group over `axes` (the positions that share every other
coordinate), in block order: `all_gather_dim` and
`reduce_scatter_dim` along any dimension (FSDP's gathers: an
all-gather's backward reduce-scatters where the work below it is split
over `axes`, and takes the position's own slice where the work is
replicated there), Megatron's pair `reduce_from_shards` (a sum, whose
backward is the identity: after a row-parallel product) and
`copy_to_shards` (the identity, whose backward is a sum: before a
column-parallel one), and `max_over_shards` and `all_to_all_dim` (the
paper's offline reshard: block r of one dimension to member r, joined
along another), with no gradient. Every position sums its group's
tensors itself, stacked in block order and reduced by one op, so
replicas hold the same bits. `position_blocks` cuts an argument (a
tensor or a Sharded) into its block at every position, `assemble` makes
a Sharded of the blocks a program returns.

`one_body()` is the cost walk's mode (launch/graph_cost.py): each_block
runs the body of its first block only and hands its outputs out for
every block, the collectives take the first block's tensor for all of
theirs, and each op is counted for the blocks it stands for. It holds
where every block's body runs the same ops on the same shapes: a
program's inputs split evenly (models.transformer._blocks cuts them by
split_dim, graph_plan refuses a graph its blocks do not divide).
"""

from __future__ import annotations

import contextlib
import functools
import threading

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.launch.mesh import (
    Mesh,
    Sharded,
    axis_size,
    block_coords,
    block_of,
    place,
    shard,
    shard_device,
    shard_rows,
    spec_entries,
    split_dim,
)


def _take_last(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather on the LAST axis; idx (b, k) broadcasts over any leading
    payload dims (payloads may be (..., b, n))."""
    while idx.dim() < p.dim():
        idx = idx[None]
    return torch.gather(p, -1, idx.expand(p.shape[:-1] + idx.shape[-1:]))


def merge_top_k(values, indices, k: int, payload=None):
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
    return merge_top_k(all_v, all_i, k, all_p)


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


def run_on_shard(device: torch.device, merge_device: torch.device | None,
                 body):
    """body() on `device`, its outputs (tensors, tuples and dicts of
    them) gathered to merge_device (None: left on `device`). On the
    card a device that is not the merging one runs the body on its side
    stream, ordered after the caller's stream and before the caller's
    next work; with no merging device the body runs on `device`'s
    current stream, which the copies between cards order."""
    if merge_device is None:
        if device.type != "cuda":
            return body()
        with torch.cuda.device(device):
            return body()
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


_ONE = threading.local()


@contextlib.contextmanager
def one_body():
    """Within the block, on this thread, each_block runs its first
    block's body alone and the collectives take the first block's
    tensor for every block (the cost walk's mode; see the module's
    docstring)."""
    prev = getattr(_ONE, "on", False)
    _ONE.on = True
    try:
        yield
    finally:
        _ONE.on = prev


def one_body_active() -> bool:
    return getattr(_ONE, "on", False)


def body_copies() -> int:
    """The blocks the body running now stands for: 1, or under
    one_body() the blocks of its each_block."""
    return getattr(_ONE, "copies", 1)


def each_block(mesh: Mesh, axes, body) -> list:
    """body(i, device) for each block i of a dimension split over `axes`
    (a name or a tuple of names; block_coords' order, the first axis
    slowest), each on its block's device (run_on_shard), its outputs
    left there. Returns the outputs in block order; under one_body() the
    first block's outputs stand for every block's."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n = axis_size(mesh, axes)
    if one_body_active():
        dev = shard_device(mesh, block_coords(mesh, axes, 0))
        prev, _ONE.copies = body_copies(), n
        try:
            out = run_on_shard(dev, None, lambda: body(0, dev))
        finally:
            _ONE.copies = prev
        return [out] * n
    out = []
    for i in range(n):
        dev = shard_device(mesh, block_coords(mesh, axes, i))
        out.append(run_on_shard(dev, None,
                                lambda i=i, dev=dev: body(i, dev)))
    return out


def note_exchange(kind: str, nbytes: float, axes: tuple = ()):
    """The bytes a collective over the mesh axes `axes` moves into the
    shard whose body calls it (kind: 'all-gather', 'reduce-scatter',
    'all-reduce' or 'all-to-all'). Nothing happens here; a cost trace
    (launch/graph_cost.py) counts them by mesh position, since a
    virtual mesh has one device."""


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _gather_rows(mesh: Mesh, axes, blocks) -> list:
    """Each shard's copy of the row blocks joined in shard order."""
    def body(i, dev):
        note_exchange("all-gather", sum(_nbytes(b) for j, b in
                                        enumerate(blocks) if j != i), axes)
        return torch.cat([place(b, dev) for b in blocks])
    return each_block(mesh, axes, body)


def _scatter_rows(mesh: Mesh, axes, parts) -> list:
    """Row block j of the shards' (N, ...) partials, summed in shard
    order on block j's device."""
    rows = split_dim(parts[0].shape[0], len(parts), "rows over the blocks")

    def body(j, dev):
        at = slice(j * rows, (j + 1) * rows)
        note_exchange("reduce-scatter", sum(_nbytes(p[at]) for i, p in
                                            enumerate(parts) if i != j),
                      axes)
        acc = place(parts[0][at], dev)
        for p in parts[1:]:
            acc = acc + place(p[at], dev)
        return acc
    return each_block(mesh, axes, body)


def _psum(mesh: Mesh, axes, xs) -> list:
    """The shards' sum on every shard, each summing them in shard order
    on its own device: the same bits on every shard, and the same ops in
    every block's body."""
    def body(i, dev):
        note_exchange("all-reduce", 2 * _nbytes(xs[i]), axes)
        acc = place(xs[0], dev)
        for x in xs[1:]:
            acc = acc + place(x, dev)
        return acc
    return each_block(mesh, axes, body)


def _expand(xs, n: int) -> list:
    """A collective's inputs as n blocks: under one_body() the first
    block's tensor stands for all n."""
    xs = list(xs)
    return xs * n if len(xs) == 1 and n > 1 else xs


def _ins(xs) -> list:
    """The tensors a collective hands to autograd: under one_body() the
    first block's alone, so its backward runs once, for that block."""
    return list(xs[:1]) if one_body_active() else list(xs)


def _outs(out, n: int) -> list:
    return list(out) * n if len(out) == 1 and n > 1 else list(out)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, *blocks):
        ctx.mesh, ctx.axes, ctx.k = mesh, axes, len(blocks)
        n = axis_size(mesh, axes)
        return tuple(_gather_rows(mesh, axes, _expand(blocks, n))[:ctx.k])

    @staticmethod
    def backward(ctx, *grads):
        n = axis_size(ctx.mesh, ctx.axes)
        return (None, None) + tuple(_scatter_rows(
            ctx.mesh, ctx.axes, _expand(grads, n))[:ctx.k])


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, *parts):
        ctx.mesh, ctx.axes, ctx.k = mesh, axes, len(parts)
        n = axis_size(mesh, axes)
        return tuple(_scatter_rows(mesh, axes, _expand(parts, n))[:ctx.k])

    @staticmethod
    def backward(ctx, *grads):
        n = axis_size(ctx.mesh, ctx.axes)
        return (None, None) + tuple(_gather_rows(
            ctx.mesh, ctx.axes, _expand(grads, n))[:ctx.k])


class _ReduceScatterMax(torch.autograd.Function):
    """Row block j of the shards' partial maxima, in shard order on
    block j's device. The gradient of each element goes to the shards
    that reach its maximum, in proportion to the ties each counted
    there (its count: how many of its own elements reached its partial
    maximum), so that with the local max's even split every tied
    element of every shard takes an equal share. An element that no
    shard reached (-inf, a count of 0 everywhere) takes none."""

    @staticmethod
    def forward(ctx, mesh, axes, *parts_and_counts):
        k = len(parts_and_counts) // 2
        n = axis_size(mesh, axes)
        parts = _expand(parts_and_counts[:k], n)
        counts = _expand(parts_and_counts[k:], n)
        rows = split_dim(parts[0].shape[0], n, "rows over the blocks")

        def body(j, dev):
            at = slice(j * rows, (j + 1) * rows)
            note_exchange("reduce-scatter", sum(
                _nbytes(p[at]) + _nbytes(c[at]) for i, (p, c) in
                enumerate(zip(parts, counts)) if i != j), axes)
            ps = [place(p[at], dev) for p in parts]
            acc = ps[0]
            for p in ps[1:]:
                acc = torch.maximum(acc, p)
            tied = [(p == acc).to(acc.dtype) * place(c[at], dev)
                    for p, c in zip(ps, counts)]
            total = tied[0]
            for t in tied[1:]:
                total = total + t
            some = total > 0
            safe = torch.where(some, total, torch.ones_like(total))
            return acc, [torch.where(some, t / safe, torch.zeros_like(t))
                         for t in tied]
        outs = each_block(mesh, axes, body)
        ctx.mesh, ctx.axes, ctx.shares = mesh, axes, [o[1] for o in outs]
        ctx.k = k
        return tuple(o[0] for o in outs[:k])

    @staticmethod
    def backward(ctx, *grads):
        shares = ctx.shares
        grads = _expand(grads, len(shares))
        pieces = each_block(ctx.mesh, ctx.axes, lambda j, dev: [
            grads[j] * w for w in shares[j]])

        def gather(i, dev):
            note_exchange("all-gather", sum(_nbytes(p[i]) for j, p in
                                            enumerate(pieces) if j != i),
                          ctx.axes)
            return torch.cat([place(p[i], dev) for p in pieces])
        return ((None, None)
                + tuple(each_block(ctx.mesh, ctx.axes, gather)[:ctx.k])
                + (None,) * ctx.k)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, mesh, axes, identity, *xs):
        ctx.mesh, ctx.axes, ctx.k = mesh, axes, len(xs)
        ctx.identity = identity
        n = axis_size(mesh, axes)
        return tuple(_psum(mesh, axes, _expand(xs, n))[:ctx.k])

    @staticmethod
    def backward(ctx, *grads):
        if ctx.identity:
            return (None, None, None) + tuple(g.view_as(g) for g in grads)
        n = axis_size(ctx.mesh, ctx.axes)
        return (None, None, None) + tuple(_psum(ctx.mesh, ctx.axes,
                                                _expand(grads, n))[:ctx.k])


def _axes_of(mesh: Mesh, axes, n: int) -> tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if n != axis_size(mesh, axes):
        raise ValueError(f"{n} blocks for the {axis_size(mesh, axes)} "
                         f"shards of {axes}")
    return axes


def all_gather_rows(mesh: Mesh, axes, blocks) -> list:
    """Each shard's (N / S, ...) row block -> every shard's (N, ...)
    whole, the blocks joined in shard order. Its backward is
    reduce_scatter_rows. One block (any mesh, or none) is the
    identity, as are the other collectives'."""
    if len(blocks) == 1:
        return list(blocks)
    axes = _axes_of(mesh, axes, len(blocks))
    return _outs(_AllGather.apply(mesh, axes, *_ins(blocks)), len(blocks))


def reduce_scatter_rows(mesh: Mesh, axes, parts, reduce: str = "sum",
                        counts=None) -> list:
    """Each shard's (N, ...) partial -> row block j of their sum (or
    elementwise max) on shard j, reduced in shard order there. Its
    backward is all_gather_rows; a max's splits each element's gradient
    over the shards that reach it by their `counts` (one (N, ...)
    tensor a shard: its elements that reached its partial maximum)."""
    if len(parts) == 1:
        return list(parts)
    axes = _axes_of(mesh, axes, len(parts))
    n = len(parts)
    if reduce == "sum":
        return _outs(_ReduceScatter.apply(mesh, axes, *_ins(parts)), n)
    if reduce != "max":
        raise ValueError(reduce)
    if counts is None or len(counts) != len(parts):
        raise ValueError("a max needs each shard's tie counts")
    return _outs(_ReduceScatterMax.apply(mesh, axes, *_ins(parts),
                                         *_ins(counts)), n)


def psum(mesh: Mesh, axes, xs, grad: str = "sum") -> list:
    """The sum of the shards' tensors (one a shard, of one shape) on
    every shard, each summing them in shard order on its own device.
    Its backward is a psum of the gradients, or with grad="identity"
    each shard's own gradient (where every shard's copy of the sum
    seeds its own backward, as the partitioned GNN's loss does)."""
    if grad not in ("sum", "identity"):
        raise ValueError(grad)
    if len(xs) == 1:
        return list(xs)
    axes = _axes_of(mesh, axes, len(xs))
    return _outs(_Psum.apply(mesh, axes, grad == "identity", *_ins(xs)),
                 len(xs))


def sum_to(mesh: Mesh, axes, xs, device: torch.device) -> torch.Tensor:
    """The shards' tensors (one a shard, of one shape) summed in shard
    order on `device` alone: the gradients of a replicated step, which
    is taken once there and read back by every replica. Not
    differentiable. Each shard is counted as an all-reduce of its
    tensor: it sends its gradient and reads back the stepped leaf."""
    if len(xs) == 1:
        return place(xs[0], device)
    axes = _axes_of(mesh, axes, len(xs))
    each_block(mesh, axes, lambda i, dev: note_exchange(
        "all-reduce", 2 * _nbytes(xs[i]), axes))
    acc = place(xs[0], device)
    for x in xs[1:]:
        acc = acc + place(x, device)
    return acc


# -- collectives over each position's group (the partitioned LM) -------------

def positions(mesh: Mesh) -> list[tuple]:
    """The mesh's positions, row-major over its axes (the first axis
    slowest): the order of a list of one tensor a position."""
    return [tuple(int(c) for c in p) for p in np.ndindex(*mesh.devices.shape)]


def each_position(mesh: Mesh, body) -> list:
    """body(i, device) for every mesh position i (positions' order), each
    on its device: each_block over all of the mesh's axes."""
    return each_block(mesh, mesh.axis_names, body)


def position_blocks(mesh: Mesh, x, spec, what: str) -> list:
    """x (a tensor, or a launch.mesh.Sharded of this mesh laid by
    `spec`) as its block at every mesh position (positions' order), on
    that position's device. Every block has one shape (the spec divides
    each dim, or split_dim raises), so every body runs the same ops;
    under one_body() only the first position's block is cut."""
    pos = positions(mesh)
    if isinstance(x, Sharded):
        if x.mesh is not mesh or spec_entries(
                x.spec, len(x.shape)) != spec_entries(spec, len(x.shape)):
            raise ValueError(f"{what}: laid by {x.spec}, not {spec}")
        sh = x
    elif one_body_active():
        first = tuple(slice(0, split_dim(n, axis_size(mesh, axes),
                                         f"{what} dim {d} over {axes}"))
                      for d, (n, axes) in enumerate(zip(
                          x.shape, spec_entries(spec, x.dim()))))
        return [place(x[first], mesh.devices[pos[0]])] * len(pos)
    else:
        sh = shard(mesh, x, spec)
    if one_body_active():
        return [sh.at(pos[0])] * len(pos)
    return [sh.at(p) for p in pos]


def assemble(mesh: Mesh, xs: list, spec, shape) -> Sharded:
    """The position list of a tensor's blocks as a Sharded laid by
    `spec`: each block from the first position that holds it on each
    device."""
    entries = spec_entries(spec, len(shape))
    blocks: dict = {}
    for i, pos in enumerate(positions(mesh)):
        blk = block_of(mesh, entries, pos)
        blocks.setdefault(blk, {}).setdefault(mesh.devices[pos], xs[i])
    return Sharded(mesh=mesh, spec=tuple(spec), shape=tuple(shape),
                   dtype=xs[0].dtype, blocks=blocks)


@functools.cache
def _groups(mesh: Mesh, axes: tuple) -> tuple:
    """For each position, (its group over `axes`: the positions that
    share its other coordinates, in block order; its block index)."""
    names = mesh.axis_names
    rest = [names.index(a) for a in names if a not in axes]
    order = rest + [names.index(a) for a in axes]
    flat = np.arange(mesh.devices.size).reshape(mesh.devices.shape)
    rows = flat.transpose(order).reshape(-1, axis_size(mesh, axes))
    out = [None] * mesh.devices.size
    for row in rows:
        members = tuple(int(q) for q in row)
        for r, q in enumerate(members):
            out[q] = (members, r)
    return tuple(out)


def _group_axes(mesh: Mesh, axes) -> tuple[str, ...]:
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    return tuple(a for a in axes if a in mesh.axis_names)


def _gather_dim(mesh, axes, dim, xs) -> list:
    groups = _groups(mesh, axes)

    def body(i, dev):
        members, _ = groups[i]
        note_exchange("all-gather", sum(_nbytes(xs[q]) for q in members
                                        if q != i), axes)
        return torch.cat([place(xs[q], dev) for q in members], dim)
    return each_position(mesh, body)


def _stacked_sum(ts: list) -> torch.Tensor:
    """The tensors stacked in block order and summed by one reduction
    (in f32 for a narrower type, rounded once): the same op, and so the
    same bits, on every position that sums them."""
    return torch.stack(ts).sum(0)


def _scatter_dim(mesh, axes, dim, xs) -> list:
    groups = _groups(mesh, axes)
    size = split_dim(xs[0].shape[dim], axis_size(mesh, axes),
                     f"dim {dim} over {axes}")

    def body(i, dev):
        members, r = groups[i]
        note_exchange("reduce-scatter", sum(
            _nbytes(xs[q]) // len(members) for q in members if q != i), axes)
        return _stacked_sum([place(xs[q].narrow(dim, r * size, size), dev)
                             for q in members])
    return each_position(mesh, body)


def _own_dim(mesh, axes, dim, xs) -> list:
    """Each position's own slice of its own tensor, copied in its body
    (a slice's view would be copied again outside it, where a gradient
    accumulates)."""
    groups = _groups(mesh, axes)
    size = split_dim(xs[0].shape[dim], axis_size(mesh, axes),
                     f"dim {dim} over {axes}")
    return each_position(mesh, lambda i, dev: xs[i].narrow(
        dim, groups[i][1] * size, size).clone())


def _sum_group(mesh, axes, xs) -> list:
    groups = _groups(mesh, axes)

    def body(i, dev):
        members, _ = groups[i]
        note_exchange("all-reduce", 2 * _nbytes(xs[i]), axes)
        return _stacked_sum([place(xs[q], dev) for q in members])
    return each_position(mesh, body)


def _max_group(mesh, axes, xs) -> list:
    groups = _groups(mesh, axes)

    def body(i, dev):
        members, _ = groups[i]
        note_exchange("all-reduce", 2 * _nbytes(xs[i]), axes)
        return torch.stack([place(xs[q], dev) for q in members]).amax(0)
    return each_position(mesh, body)


# (forward, backward) of each collective over position lists; Megatron's
# pair's identity halves return views of the tensors they are given
_OVER = {
    "gather_sum": (_gather_dim, _scatter_dim),
    "gather_own": (_gather_dim, _own_dim),
    "scatter": (_scatter_dim, _gather_dim),
    "reduce": (lambda m, a, d, xs: _sum_group(m, a, xs), None),
    "copy": (None, lambda m, a, d, gs: _sum_group(m, a, gs)),
}


class _OverShards(torch.autograd.Function):
    """One collective over every position's group: its inputs one tensor
    a position (under one_body() the first position's alone)."""

    @staticmethod
    def forward(ctx, kind, mesh, axes, dim, *xs):
        ctx.kind, ctx.mesh, ctx.axes, ctx.dim = kind, mesh, axes, dim
        ctx.k = len(xs)
        fwd = _OVER[kind][0]
        if fwd is None:
            return tuple(x.view_as(x) for x in xs)
        return tuple(fwd(mesh, axes, dim, _expand(xs, mesh.devices.size))[
            :ctx.k])

    @staticmethod
    def backward(ctx, *gs):
        back = _OVER[ctx.kind][1]
        if back is None:
            return (None,) * 4 + tuple(g.view_as(g) for g in gs)
        return (None,) * 4 + tuple(back(ctx.mesh, ctx.axes, ctx.dim,
                                        _expand(gs, ctx.mesh.devices.size))[
            :ctx.k])


def _over(kind: str, mesh: Mesh, axes, xs, dim: int = 0) -> list:
    axes = _group_axes(mesh, axes)
    n = mesh.devices.size
    if len(xs) != n:
        raise ValueError(f"{len(xs)} tensors for the {n} positions")
    if axis_size(mesh, axes) == 1:
        return list(xs)
    ins = _ins(xs)
    if torch.is_grad_enabled() and any(x.requires_grad for x in ins):
        return _outs(_OverShards.apply(kind, mesh, axes, dim, *ins), n)
    fwd = _OVER[kind][0]
    if fwd is None:
        return list(xs)
    return _outs(fwd(mesh, axes, dim, _expand(ins, n))[:len(ins)], n)


def all_gather_dim(mesh: Mesh, axes, xs, dim: int = 0,
                   grad: str = "sum") -> list:
    """Each position's block -> its group's blocks over `axes` joined
    along `dim` in block order. The backward sums each block's gradient
    over the group (grad="sum": a reduce-scatter, where the positions'
    work below is split over `axes`) or takes the position's own slice
    of its own gradient (grad="own": where that work is replicated over
    `axes` and each copy's gradient whole). Every sum here is
    _stacked_sum's."""
    if grad not in ("sum", "own"):
        raise ValueError(grad)
    return _over(f"gather_{grad}", mesh, axes, xs, dim)


def reduce_scatter_dim(mesh: Mesh, axes, xs, dim: int = 0) -> list:
    """Each position's partial -> block r (its block index over `axes`)
    of the group's sum along `dim`. Its backward is all_gather_dim's
    forward."""
    return _over("scatter", mesh, axes, xs, dim)


def reduce_from_shards(mesh: Mesh, axes, xs) -> list:
    """The group's sum over `axes` on each position; the backward is the
    identity (Megatron's operator after a row-parallel product: the
    work after it is replicated over `axes`, and each copy seeds its
    own gradient)."""
    return _over("reduce", mesh, axes, xs)


def copy_to_shards(mesh: Mesh, axes, xs) -> list:
    """The identity; the backward sums the group's gradients over `axes`
    (Megatron's operator before a column-parallel product: each
    position's gradient is its part of the whole)."""
    return _over("copy", mesh, axes, xs)


@torch.no_grad()
def max_over_shards(mesh: Mesh, axes, xs) -> list:
    """The group's elementwise max over `axes` on each position; no
    gradient (a log-sum-exp's shift, a softmax merge's)."""
    axes = _group_axes(mesh, axes)
    if axis_size(mesh, axes) == 1:
        return list(xs)
    if one_body_active():
        return _max_group(mesh, axes, _expand(xs[:1], len(xs)))
    return _max_group(mesh, axes, list(xs))


def _all_to_all(mesh, axes, split, cat, xs) -> list:
    groups = _groups(mesh, axes)
    size = split_dim(xs[0].shape[split], axis_size(mesh, axes),
                     f"dim {split} over {axes}")

    def body(i, dev):
        members, r = groups[i]
        parts = [xs[q].narrow(split, r * size, size) for q in members]
        note_exchange("all-to-all", sum(_nbytes(p) for q, p in
                                        zip(members, parts) if q != i), axes)
        return torch.cat([place(p, dev) for p in parts], cat)
    return each_position(mesh, body)


@torch.no_grad()
def all_to_all_dim(mesh: Mesh, axes, xs, split_dim: int,
                   cat_dim: int) -> list:
    """Position r of each group over `axes` gives block r' of its
    tensor's `split_dim` to member r' and receives its own block r from
    every member, joined along `cat_dim` in block order; no gradient.
    (Users over the batch axes x items over 'model' -> users over the
    batch axes and 'model' x all items: the offline solve's reshard.)"""
    axes = _group_axes(mesh, axes)
    if axis_size(mesh, axes) == 1:
        return list(xs)
    if len(xs) != mesh.devices.size:
        raise ValueError(f"{len(xs)} tensors for the {mesh.devices.size} "
                         f"positions")
    return _all_to_all(mesh, axes, split_dim, cat_dim,
                       _expand(xs[:1], len(xs)) if one_body_active()
                       else list(xs))


@torch.no_grad()
def sum_over_shards(mesh: Mesh, axes, xs) -> list:
    """The group's sum over `axes` on each position, with no gradient (a
    train step's gradients over the batch axes that its parameter is not
    split over; the clip's squares)."""
    axes = _group_axes(mesh, axes)
    if axis_size(mesh, axes) == 1:
        return list(xs)
    return _sum_group(mesh, axes, _expand(xs[:1], len(xs))
                      if one_body_active() else list(xs))


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
