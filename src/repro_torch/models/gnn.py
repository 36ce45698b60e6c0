"""MeshGraphNet (arXiv:2010.03409), encode-process-decode GNN
(counterpart of repro.models.gnn).

Messages are computed on an explicit edge list and summed per receiver
by `aggregate`, the port's segment_sum: the system's scatter substrate,
as JAX's jax.ops.segment_sum is. It is plain torch ops, as in the JAX
package, where no Pallas kernel covers it:

  * sum and mean add with `index_put(..., accumulate=True)` into zeros.
    On the card that op sorts the indices and adds each segment in a
    fixed order, so two calls give the same bits (index_add_ and
    scatter_add_ add atomically, in no fixed order). It adds in
    another order than XLA's CPU scatter, so it agrees with JAX to
    rounding;
  * max is `scatter_reduce(amax, include_self=False)` into -inf: an
    empty segment stays -inf, as segment_max leaves it, and tied
    maxima share the gradient evenly, as JAX's does.

Three execution modes match the cells: one graph (full_graph_sm,
ogb_products), a sampled block of a CSR graph (minibatch_lg:
`neighbor_sample`, then `block_graph_from_sample`) and batched small
graphs (molecule: `forward_batched`, one graph of B x N nodes whose
segments do not meet, in place of JAX's vmap).

The processor's 15 steps have their own weights, stacked on a leading
L axis as JAX's vmapped init builds them; with cfg.remat each step runs
under torch.utils.checkpoint (JAX's jax.checkpoint around the scanned
step). The parameter tree keeps JAX's names (node_encoder,
edge_encoder, processor/{edge_mlp,node_mlp}/w0.., decoder), drawn from a
torch.Generator in JAX's layout and scales; `load_numpy` carries a JAX
`init(key)` across. The sampler's uniforms come from a torch.Generator
(torch cannot reproduce jax.random); `sample_from_uniforms` is its
deterministic body, which JAX's own uniforms drive in the tests.
`gnn_logical_axes` (MeshGraphNet.logical_axes) mirrors the parameter
tree with per-dim logical axis names: the weights replicate, the
processor's stacked leaves lead with 'layers'; the node and edge
states carry JAX's logical_shard annotations ('nodes', 'edges').

Under a mesh context whose rules split the nodes and edges over more
than one block (GNN_RULES: ('pod', 'data')), gnn_forward, gnn_loss,
gnn_grads and so gnn_train_step run partitioned, as JAX's jit
partitions the annotated step over the mesh it runs under
(graph_plan): one shard body a block, each on its block's device with
its node rows, its edge rows (global sender and receiver ids) and its
own replica of the weights. A processor step all-gathers the node
latents, builds its edges' messages, aggregates them into a zero
(N, D) partial by the same sorted index_put and reduce-scatters the
partials to the node blocks (mean with its counts, max with its ties)
before its node MLP; the loss is the psum of each block's squared
error over the count, each block's copy seeding its own backward; the
replicas' gradients are summed in shard order onto the parameters'
device, then clipped and stepped once. The
collectives are distributed.topk's. A batch of graphs splits by whole
graphs, whose blocks exchange nothing. The global step is the same
code over one block, whose collectives are the identity.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.checkpoint.store import flatten_with_paths, unflatten_like
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    current_mesh,
    current_rules,
    logical_shard,
)
from repro_torch.distributed.topk import (
    all_gather_rows,
    each_block,
    psum,
    reduce_scatter_rows,
    sum_to,
)
from repro_torch.launch.mesh import axis_size, place
from repro_torch.models.layers import dense_init
from repro_torch.models.recsys import _register, _tree_of
from repro_torch.models.transformer import _device_of
from repro_torch.optim import adam_init, adam_update, clip_by_global_norm

LN_EPS = 1e-6


@dataclass(frozen=True)
class GNNConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15          # processor message-passing steps
    d_hidden: int = 128
    mlp_layers: int = 2         # hidden layers per MLP block
    aggregator: str = "sum"     # sum | mean | max
    d_node_in: int = 16
    d_edge_in: int = 8
    d_out: int = 3
    layer_norm: bool = True
    dtype: Any = torch.float32
    param_dtype: Any = torch.float32
    remat: bool = True

    @property
    def n_params(self) -> int:
        def mlp(d_in, d_out):
            n, prev = 0, d_in
            for _ in range(self.mlp_layers):
                n += prev * self.d_hidden + self.d_hidden
                prev = self.d_hidden
            n += prev * d_out + d_out
            if self.layer_norm:
                n += 2 * d_out
            return n

        h = self.d_hidden
        enc = mlp(self.d_node_in, h) + mlp(self.d_edge_in, h)
        proc = self.n_layers * (mlp(3 * h, h) + mlp(2 * h, h))
        dec = mlp(h, self.d_out)
        return enc + proc + dec


# --------------------------------------------------------------------------
# MLP block (Linear x mlp_layers + out, ReLU, optional LayerNorm at output)
# --------------------------------------------------------------------------

def _mlp_init(gen, d_in: int, d_out: int, cfg: GNNConfig, dev) -> dict:
    dims = [d_in] + [cfg.d_hidden] * cfg.mlp_layers + [d_out]
    p = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        p[f"w{i}"] = dense_init(gen, (a, b), cfg.param_dtype, device=dev)
        p[f"b{i}"] = torch.zeros((b,), dtype=cfg.param_dtype, device=dev)
    if cfg.layer_norm:
        p["ln_scale"] = torch.ones((d_out,), dtype=cfg.param_dtype,
                                   device=dev)
        p["ln_bias"] = torch.zeros((d_out,), dtype=cfg.param_dtype,
                                   device=dev)
    return p


def _mlp_axes(cfg: GNNConfig) -> dict:
    p = {}
    for i in range(cfg.mlp_layers + 1):
        p[f"w{i}"] = ("mlp_in", "mlp_out")
        p[f"b{i}"] = (None,)
    if cfg.layer_norm:
        p["ln_scale"] = (None,)
        p["ln_bias"] = (None,)
    return p


def _mlp_apply(p: dict, x: torch.Tensor, cfg: GNNConfig) -> torch.Tensor:
    n = cfg.mlp_layers + 1
    for i in range(n):
        x = x @ p[f"w{i}"].to(x.dtype) + p[f"b{i}"].to(x.dtype)
        if i < n - 1:
            x = torch.relu(x)
    if cfg.layer_norm:
        # jnp.mean, jnp.var, then rsqrt(var + eps), as explicit ops
        mu = x.mean(dim=-1, keepdim=True)
        var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
        x = (x - mu) * torch.rsqrt(var + LN_EPS)
        x = x * p["ln_scale"].to(x.dtype) + p["ln_bias"].to(x.dtype)
    return x


# --------------------------------------------------------------------------
# Aggregation (the SpMM substrate: segment ops over the receiver index)
# --------------------------------------------------------------------------

def _segment_sum(x: torch.Tensor, receivers: torch.Tensor,
                 n_nodes: int) -> torch.Tensor:
    out = torch.zeros((n_nodes,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_put((receivers,), x, accumulate=True)


def aggregate(messages: torch.Tensor, receivers: torch.Tensor, n_nodes: int,
              mode: str) -> torch.Tensor:
    """(n_edges, D) messages -> (n_nodes, D) per-receiver aggregate:
    sum, mean (the sum over max(count, 1)) or max (-inf where a node
    receives nothing)."""
    receivers = receivers.to(device=messages.device, dtype=torch.long)
    if mode == "sum":
        return _segment_sum(messages, receivers, n_nodes)
    if mode == "mean":
        s = _segment_sum(messages, receivers, n_nodes)
        cnt = _segment_sum(torch.ones((messages.shape[0],),
                                      dtype=messages.dtype,
                                      device=messages.device),
                           receivers, n_nodes)
        return s / torch.clamp_min(cnt, 1.0)[:, None]
    if mode == "max":
        out = torch.full((n_nodes, messages.shape[1]), float("-inf"),
                         dtype=messages.dtype, device=messages.device)
        idx = receivers[:, None].expand(-1, messages.shape[1])
        return out.scatter_reduce(0, idx, messages, reduce="amax",
                                  include_self=False)
    raise ValueError(mode)


# --------------------------------------------------------------------------
# Parameters
# --------------------------------------------------------------------------

def gnn_init(gen: torch.Generator | None, cfg: GNNConfig, *,
             device=None) -> dict:
    """The parameter tree on `device` (None = the card; "meta" gives
    shapes only), drawn from `gen` (a generator on the device seeded 0
    if None) in JAX's layout and scales, the processor's leaves stacked
    on a leading L. The values match JAX's in distribution only."""
    dev = _device_of(device)
    if dev.type != "meta" and gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    h = cfg.d_hidden
    node_enc = _mlp_init(gen, cfg.d_node_in, h, cfg, dev)
    edge_enc = _mlp_init(gen, cfg.d_edge_in, h, cfg, dev)
    layers = [{"edge_mlp": _mlp_init(gen, 3 * h, h, cfg, dev),
               "node_mlp": _mlp_init(gen, 2 * h, h, cfg, dev)}
              for _ in range(cfg.n_layers)]
    flat = [flatten_with_paths(lay) for lay in layers]
    processor = unflatten_like(layers[0], {
        k: torch.stack([f[k] for f in flat]) for k in flat[0]})
    return {"node_encoder": node_enc, "edge_encoder": edge_enc,
            "processor": processor,
            "decoder": _mlp_init(gen, h, cfg.d_out, cfg, dev)}


def gnn_logical_axes(cfg: GNNConfig) -> dict:
    """The parameter tree's logical axes (JAX's
    MeshGraphNet.logical_axes)."""
    m = _mlp_axes(cfg)
    proc = {name: {k: ("layers",) + v for k, v in m.items()}
            for name in ("edge_mlp", "node_mlp")}
    return {"node_encoder": dict(m), "edge_encoder": dict(m),
            "processor": proc, "decoder": dict(m)}


def gnn_from_numpy(tree, cfg: GNNConfig, *, device=None) -> dict:
    """A JAX `MeshGraphNet.init` tree (numpy arrays) as the port's
    parameters, in cfg.param_dtype."""
    dev = resolve_device(device)
    like = gnn_init(None, cfg, device="meta")
    src, ref = flatten_with_paths(tree), flatten_with_paths(like)
    if set(src) != set(ref):
        raise ValueError(f"parameter paths differ: "
                         f"{sorted(set(src) ^ set(ref))}")
    out = {}
    for k, r in ref.items():
        a = np.asarray(src[k])
        if tuple(a.shape) != tuple(r.shape):
            raise ValueError(f"{k}: {tuple(a.shape)} != {tuple(r.shape)}")
        out[k] = torch.from_numpy(np.array(a)).to(device=dev, dtype=r.dtype)
    return unflatten_like(like, out)


def gnn_state_numpy(params: dict) -> dict:
    """The parameter tree as numpy arrays in JAX's paths."""
    flat = flatten_with_paths(params)
    return unflatten_like(params, {
        k: v.detach().cpu().numpy() for k, v in flat.items()})


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _as_tensor(x, dev: torch.device, dtype=None) -> torch.Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.array(x))   # a writable copy
    return torch.as_tensor(x).to(device=dev, dtype=dtype)


def _param_device(params: dict) -> torch.device:
    return params["decoder"]["w0"].device


def _step_mlp(params: dict, name: str, step: int) -> dict:
    """Processor step `step`'s edge_mlp or node_mlp out of the stacked
    tree."""
    return {k: w[step] for k, w in params["processor"][name].items()}


_NODE_KEYS = ("nodes", "targets", "node_mask")
_EDGE_KEYS = ("edges", "senders", "receivers")


@dataclass(frozen=True)
class GraphPlan:
    """How the step splits a graph: `n` blocks over the mesh axes
    `axes`, a block of nodes and one of edges (or, for a batch of
    graphs, a block of whole graphs) on each. The global step is the
    plan of one block with no mesh, whose collectives are the
    identity."""
    mesh: Any
    axes: tuple
    n: int
    batched: bool


def graph_plan(graph: dict) -> GraphPlan | None:
    """The active mesh context's split of `graph`: the rules' 'nodes'
    and 'edges' entries (one entry, ('pod', 'data') in GNN_RULES), or
    for a batch of graphs its 'batch' entry. None, and the global step
    runs, when no context is active, the entry is missing or gives one
    block, or the blocks do not divide the nodes and edges (or the
    graphs), where JAX's drop_nondivisible would replicate them."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None:
        return None
    batched = len(graph["nodes"].shape) == 3
    names = ("batch",) if batched else ("nodes", "edges")
    entries = {rules.rules.get(k) for k in names}
    entry = entries.pop() if len(entries) == 1 else None
    if entry is None:
        return None
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    n = axis_size(mesh, axes)
    dims = (graph["nodes"].shape[0],) if batched else (
        graph["nodes"].shape[0], graph["senders"].shape[0])
    if n <= 1 or any(d % n for d in dims):
        return None
    return GraphPlan(mesh, axes, n, batched)


def _plan(graph: dict) -> GraphPlan:
    return graph_plan(graph) or GraphPlan(
        None, (), 1, len(graph["nodes"].shape) == 3)


def _each(plan: GraphPlan, dev: torch.device, body) -> list:
    """body(i, device) for each block i on its shard's device (one
    block: on `dev`), the outputs in block order."""
    if plan.mesh is None:
        return [body(0, dev)]
    return each_block(plan.mesh, plan.axes, body)


def _annotate(xs: list, name: str, plan: GraphPlan) -> list:
    """JAX's logical_shard of the global node or edge state (a block is
    a shard already)."""
    return [logical_shard(xs[0], name, None)] if plan.mesh is None else xs


def _replicas(params: dict, plan: GraphPlan, dev, *,
              detach: bool = False) -> list:
    """Each block's replica of the parameter tree on its device: the
    parameters themselves (a copy on another card), or with `detach`
    leaves of their own, whose gradients come out apart."""
    flat = flatten_with_paths(params)

    def body(i, d):
        if detach:
            return {k: place(v.detach(), d).requires_grad_(True)
                    for k, v in flat.items()}
        return {k: place(v, d) for k, v in flat.items()}
    return [unflatten_like(params, r) for r in _each(plan, dev, body)]


def _graph_blocks(graph: dict, cfg: GNNConfig, plan: GraphPlan,
                  dev) -> list:
    """Each block of the graph on its device: node rows i N / S onwards
    and edge rows i E / S onwards (senders and receivers keep their
    global node ids), features in cfg.dtype and ids in int64; or the
    graphs i B / S onwards as they are."""
    g = {k: _as_tensor(graph[k], None) for k in _NODE_KEYS + _EDGE_KEYS
         if k in graph}

    def body(i, d):
        out = {}
        for k, x in g.items():
            rows = x.shape[0] // plan.n
            blk = place(x if plan.n == 1 else x[i * rows:(i + 1) * rows], d)
            if plan.batched:
                out[k] = blk
            elif k in ("nodes", "edges"):
                out[k] = blk.to(cfg.dtype)
            elif k in ("senders", "receivers"):
                out[k] = blk.long()
            else:
                out[k] = blk
        return out
    return _each(plan, dev, body)


def _partial(e, receivers, n_nodes: int, mode: str) -> tuple:
    """A block's partial aggregate of its own edges into all n_nodes
    (and for mean its counts, for max its ties: how many of its edges
    reach each element's partial maximum)."""
    if mode == "sum":
        return (_segment_sum(e, receivers, n_nodes),)
    if mode == "mean":
        return (_segment_sum(e, receivers, n_nodes), _segment_sum(
            torch.ones((e.shape[0],), dtype=e.dtype, device=e.device),
            receivers, n_nodes))
    if mode == "max":
        part = aggregate(e, receivers, n_nodes, "max")
        with torch.no_grad():
            ties = _segment_sum((e == part[receivers]).to(e.dtype),
                                receivers, n_nodes)
        return part, ties
    raise ValueError(mode)


def _reduced(parts: list, mode: str, plan: GraphPlan) -> list:
    """The partials reduce-scattered to the node blocks: each block of
    the aggregate."""
    mesh, axes = plan.mesh, plan.axes
    if mode == "sum":
        return reduce_scatter_rows(mesh, axes, [p[0] for p in parts])
    if mode == "max":
        return reduce_scatter_rows(mesh, axes, [p[0] for p in parts], "max",
                                   counts=[p[1] for p in parts])
    sums = reduce_scatter_rows(mesh, axes, [p[0] for p in parts])
    counts = reduce_scatter_rows(mesh, axes, [p[1] for p in parts])
    return each_block(mesh, axes, lambda i, dev: sums[i] / torch.clamp_min(
        counts[i], 1.0)[:, None])


def _aggregate(e: list, blocks: list, n_nodes: int, mode: str,
               plan: GraphPlan) -> list:
    """Each node block's aggregate of every edge: `aggregate` on one
    block, else each block's partial over its own edges
    reduce-scattered to the node blocks."""
    if plan.mesh is None:
        return [aggregate(e[0], blocks[0]["receivers"], n_nodes, mode)]
    parts = each_block(plan.mesh, plan.axes, lambda i, dev: _partial(
        e[i], blocks[i]["receivers"], n_nodes, mode))
    return _reduced(parts, mode, plan)


def _proc_step(v, e, reps, step, blocks, n_nodes, cfg, plan):
    """Processor step `step` over the blocks (lists, one entry a block,
    each with its replica of the weights): all-gather the node latents,
    each block's edges' messages, their aggregate reduce-scattered to
    the node blocks, each block's node MLP on its own rows. A block's
    weights are selected inside its body, so their backward is the
    body's."""
    full = all_gather_rows(plan.mesh, plan.axes, v)
    rows, dev = v[0].shape[0], v[0].device

    def edges(i, d):
        b = blocks[i]
        msg_in = torch.cat([e[i], full[i][b["senders"]],
                            full[i][b["receivers"]]], dim=-1)
        return e[i] + _mlp_apply(_step_mlp(reps[i], "edge_mlp", step),
                                 msg_in, cfg)
    e = _each(plan, dev, edges)
    agg = _aggregate(e, blocks, n_nodes, cfg.aggregator, plan)

    def nodes(i, d):
        # on a mesh, the block's own rows of its gathered copy: the
        # block's only reader is the all-gather, so its gradient has
        # one source
        v_i = v[0] if plan.mesh is None else full[i][i * rows:(i + 1)
                                                     * rows]
        return v_i + _mlp_apply(_step_mlp(reps[i], "node_mlp", step),
                                torch.cat([v_i, agg[i]], dim=-1), cfg)
    v = _each(plan, dev, nodes)
    return _annotate(v, "nodes", plan), _annotate(e, "edges", plan)


def _predict(reps: list, blocks: list, cfg: GNNConfig, plan: GraphPlan,
             dev) -> list:
    """Each block's predictions: (N / S, d_out), or (B / S, N, d_out)
    for a batch of graphs, each block of which runs as one graph of
    B / S x N nodes and exchanges nothing."""
    if plan.batched:
        def graphs(i, d):
            b = blocks[i]
            B, N = b["nodes"].shape[:2]
            one = GraphPlan(None, (), 1, False)
            flat = _graph_blocks(flatten_batch(b), cfg, one, d)
            return _predict([reps[i]], flat, cfg, one, d)[0].reshape(
                B, N, -1)
        return _each(plan, dev, graphs)
    n_nodes = blocks[0]["nodes"].shape[0] * plan.n
    v = _annotate(_each(plan, dev, lambda i, d: _mlp_apply(
        reps[i]["node_encoder"], blocks[i]["nodes"], cfg)), "nodes", plan)
    e = _annotate(_each(plan, dev, lambda i, d: _mlp_apply(
        reps[i]["edge_encoder"], blocks[i]["edges"], cfg)), "edges", plan)
    remat = cfg.remat and torch.is_grad_enabled()
    for step in range(cfg.n_layers):
        if remat:
            v, e = checkpoint(_proc_step, v, e, reps, step, blocks, n_nodes,
                              cfg, plan, use_reentrant=False)
        else:
            v, e = _proc_step(v, e, reps, step, blocks, n_nodes, cfg, plan)
    return _each(plan, dev, lambda i, d: _mlp_apply(reps[i]["decoder"],
                                                    v[i], cfg))


def gnn_forward(params: dict, graph: dict, cfg: GNNConfig) -> torch.Tensor:
    """One graph {nodes (N, d_node_in), edges (E, d_edge_in), senders,
    receivers (E,)} -> (N, d_out) per-node predictions, on the
    parameters' device. Under a mesh context that splits the graph
    (graph_plan) the blocks' predictions are joined there."""
    plan, dev = _plan(graph), _param_device(params)
    preds = _predict(_replicas(params, plan, dev),
                     _graph_blocks(graph, cfg, plan, dev), cfg, plan, dev)
    return preds[0] if plan.mesh is None else torch.cat(
        [place(p, dev) for p in preds])


def flatten_batch(graph: dict) -> dict:
    """A batch of B graphs of N nodes and E edges each (tensors, leading
    B on every leaf) as one graph of B x N nodes: graph b's node ids
    offset by b x N, so no segment of one graph meets another's."""
    B, N = graph["nodes"].shape[:2]
    senders, receivers = graph["senders"].long(), graph["receivers"].long()
    off = (torch.arange(B, device=senders.device) * N)[:, None]
    return {"nodes": graph["nodes"].reshape(B * N, -1),
            "edges": graph["edges"].reshape(B * senders.shape[1], -1),
            "senders": (senders + off).reshape(-1),
            "receivers": (receivers + off).reshape(-1)}


def gnn_forward_batched(params: dict, graph: dict,
                        cfg: GNNConfig) -> torch.Tensor:
    """The molecule cell: every leaf has a leading batch dim; -> (B, N,
    d_out), JAX's vmap of forward over the batch."""
    return gnn_forward(params, graph, cfg)


def _loss(reps: list, blocks: list, cfg: GNNConfig, plan: GraphPlan,
          dev) -> list:
    """gnn_loss over the blocks, a copy on each block's device: each sums
    its own squared error (masked by node_mask where there is one); the
    psum of the sums over the count (with a mask the psum of its sums x
    d_out + 1e-9). Each copy seeds its own backward (the psum's backward
    is the identity), so every block's body runs the same ops."""
    preds = _predict(reps, blocks, cfg, plan, dev)
    masked = "node_mask" in blocks[0]

    def body(i, d):
        pred, b = preds[i], blocks[i]
        err = (pred - b["targets"].to(pred.dtype)) ** 2
        if not masked:
            return (torch.sum(err),)
        m = b["node_mask"].to(pred.dtype)
        return torch.sum(err * m[..., None]), torch.sum(m)
    parts = _each(plan, dev, body)
    total = psum(plan.mesh, plan.axes, [p[0] for p in parts], "identity")
    if not masked:
        n = preds[0].numel() * plan.n
        return _each(plan, dev, lambda i, d: total[i] / n)
    count = psum(plan.mesh, plan.axes, [p[1] for p in parts], "identity")
    return _each(plan, dev, lambda i, d: total[i] / (
        count[i] * preds[0].shape[-1] + 1e-9))


def gnn_loss(params: dict, graph: dict, cfg: GNNConfig):
    """Squared error -> (loss, {"loss": loss}): the mean over every
    prediction, or with a node_mask the masked sum over
    sum(mask) x d_out + 1e-9. Under a mesh context that splits the
    graph, the blocks' sums and counts are psum'd."""
    plan, dev = _plan(graph), _param_device(params)
    loss = place(_loss(_replicas(params, plan, dev),
                       _graph_blocks(graph, cfg, plan, dev), cfg, plan,
                       dev)[0], dev)
    return loss, {"loss": loss}


# --------------------------------------------------------------------------
# Training
# --------------------------------------------------------------------------

def gnn_adam_init(params: dict):
    """Adam's zero state over the flattened tree."""
    flat = flatten_with_paths(params)
    return adam_init({k: p.detach() for k, p in flat.items()},
                     device=_param_device(params))


def gnn_grads(params: dict, graph: dict, cfg: GNNConfig):
    """(loss, metrics, gradient tree), as jax.value_and_grad gives them.
    Under a mesh context that splits the graph, each block reads its
    own replica of the parameters and the replicas' gradients are
    summed in shard order onto the parameters' device."""
    plan, dev = _plan(graph), _param_device(params)
    reps = _replicas(params, plan, dev, detach=True)
    leaves = [flatten_with_paths(r) for r in reps]
    with torch.enable_grad():
        losses = _loss(reps, _graph_blocks(graph, cfg, plan, dev), cfg,
                       plan, dev)
        seeds = _each(plan, dev, lambda i, d: torch.ones_like(losses[i]))
        outs = list({id(x): (x, s) for x, s in zip(losses, seeds)}.values())
        g = torch.autograd.grad([o[0] for o in outs],
                                [t for f in leaves for t in f.values()],
                                [o[1] for o in outs], allow_unused=True)
    keys = list(leaves[0])
    per = [[torch.zeros_like(f[k]) if gk is None else gk
            for k, gk in zip(keys, g[i * len(keys):(i + 1) * len(keys)])]
           for i, f in enumerate(leaves)]
    grads = {k: sum_to(plan.mesh, plan.axes, [p[j] for p in per], dev)
             for j, k in enumerate(keys)}
    loss = place(losses[0].detach(), dev)
    return loss, {"loss": loss}, unflatten_like(params, grads)


def gnn_train_step(params: dict, opt_state, graph: dict, cfg: GNNConfig, *,
                   lr: float = 1e-3):
    """Gradients, clip at global norm 1, one Adam step: returns (new
    params, new opt state, {"loss", "grad_norm"}). The inputs are left
    as they are."""
    _, metrics, grads = gnn_grads(params, graph, cfg)
    grads, gnorm = clip_by_global_norm(grads, 1.0)
    flat = flatten_with_paths(params)
    new, opt_state = adam_update(
        flatten_with_paths(grads), opt_state,
        {k: p.detach() for k, p in flat.items()}, lr=lr)
    return unflatten_like(params, new), opt_state, dict(metrics,
                                                       grad_norm=gnorm)


class MeshGraphNet(nn.Module):
    """A GNNConfig's parameters as an nn.Module (parameter names are the
    tree's paths with '.' for '/'), over the functions above.

    Graph dict (tensors or numpy arrays):
      nodes     (N, d_node_in)   node features
      edges     (E, d_edge_in)   edge features
      senders   (E,) int         source node per edge
      receivers (E,) int         destination node per edge
      [targets  (N, d_out)]      regression targets (train)
      [node_mask (N,)]           1.0 for real nodes (the sampled seeds)
    """

    def __init__(self, cfg: GNNConfig, *, gen: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        _register(self, gnn_init(gen, cfg, device=device))

    def params(self) -> dict:
        """The parameter tree (nested dicts of parameters)."""
        return _tree_of(self)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def logical_axes(self) -> dict:
        return gnn_logical_axes(self.cfg)

    def load_numpy(self, tree) -> "MeshGraphNet":
        """Take a JAX `init` tree (numpy arrays) as the parameters."""
        new = flatten_with_paths(gnn_from_numpy(tree, self.cfg,
                                                device=self.device))
        with torch.no_grad():
            for k, p in flatten_with_paths(self.params()).items():
                p.copy_(new[k])
        return self

    def load_tree(self, params: dict) -> "MeshGraphNet":
        """Make `params` (a tree of this model's paths, on its device)
        the tensors the module reads, without a copy."""
        new = flatten_with_paths(params)
        for k, p in flatten_with_paths(self.params()).items():
            p.data = new[k].detach()
        return self

    def state_numpy(self) -> dict:
        return gnn_state_numpy(self.params())

    def forward(self, graph: dict) -> torch.Tensor:
        """-> (N, d_out) per-node predictions."""
        return gnn_forward(self.params(), graph, self.cfg)

    def forward_batched(self, graph: dict) -> torch.Tensor:
        """molecule cell: graph leaves have a leading batch dim."""
        return gnn_forward_batched(self.params(), graph, self.cfg)

    def loss(self, graph: dict):
        return gnn_loss(self.params(), graph, self.cfg)

    def init_opt(self):
        return gnn_adam_init(self.params())

    def grads(self, graph: dict):
        return gnn_grads(self.params(), graph, self.cfg)

    def train_step(self, opt_state, graph: dict, *, lr: float = 1e-3):
        """One gnn_train_step; the parameters are updated in place.
        Returns (opt_state, {"loss", "grad_norm"})."""
        new, opt_state, metrics = gnn_train_step(self.params(), opt_state,
                                                 graph, self.cfg, lr=lr)
        self.load_tree(new)
        return opt_state, metrics

    @torch.no_grad()
    def node_scores(self, graph: dict) -> torch.Tensor:
        """First output channel as a per-node 'utility': lets the
        constrained-ranking head consume GNN outputs."""
        return self.forward(graph)[:, 0]


# --------------------------------------------------------------------------
# Uniform-fanout neighbor sampler (minibatch_lg)
# --------------------------------------------------------------------------

def sampler_uniforms(gen: torch.Generator, n_seeds: int,
                     fanouts: tuple[int, ...]) -> list:
    """The sampler's draws: for layer l a (F_l, fanout_l) f32 tensor of
    uniforms in [0, 1) from `gen`, on its device, with F_0 = n_seeds and
    F_{l+1} = F_l x fanout_l."""
    out, F = [], n_seeds
    for f in fanouts:
        out.append(torch.rand((F, f), generator=gen, device=gen.device))
        F *= f
    return out


def sample_from_uniforms(indptr, indices, seeds, uniforms) -> dict:
    """neighbor_sample's deterministic body on given uniforms (one
    (F_l, fanout_l) array a layer). Layer l picks neighbour
    int32(u x max(deg, 1)) of each frontier node from the CSR rows
    (with replacement: duplicates keep the shapes static), a node of
    degree 0 picks itself; edges run child (new layer) -> parent.
    Indexes in int64; the gather index is clamped into the CSR's
    columns, as XLA's gather clamps it, so a node of degree 0 whose row
    is the last reads a column (which the self loop then replaces) and
    not past the end. Returns {node_ids (T,), senders, receivers (E,)
    int32 indices into node_ids, n_seeds}."""
    indptr = _as_tensor(indptr, None)
    dev = indptr.device
    indptr = indptr.long()
    indices = _as_tensor(indices, dev)
    idx_dtype = indices.dtype
    indices = indices.long()
    seeds = _as_tensor(seeds, dev)
    frontier = seeds.long()
    layers, edge_src, edge_dst = [frontier], [], []
    offset = 0
    for u in uniforms:
        u = _as_tensor(u, dev, torch.float32)
        n_par, f = u.shape
        if n_par != frontier.shape[0]:
            raise ValueError(f"uniforms of {n_par} rows for a frontier of "
                             f"{frontier.shape[0]}")
        start = indptr[frontier]
        deg = (indptr[frontier + 1] - start).to(torch.int32)
        pick = (u * torch.clamp_min(deg, 1)[:, None]).to(torch.int32)
        at = torch.clamp(start[:, None] + pick.long(), 0,
                         max(indices.shape[0] - 1, 0))
        nbr = indices[at]                                      # (F, f)
        nbr = torch.where(deg[:, None] > 0, nbr, frontier[:, None])
        child_off = offset + n_par
        edge_src.append(child_off + torch.arange(n_par * f, device=dev))
        edge_dst.append(offset + torch.arange(
            n_par, device=dev).repeat_interleave(f))
        frontier = nbr.reshape(-1)
        layers.append(frontier)
        offset = child_off
    return {"node_ids": torch.cat(layers).to(idx_dtype),
            "senders": torch.cat(edge_src).to(torch.int32),
            "receivers": torch.cat(edge_dst).to(torch.int32),
            "n_seeds": int(seeds.shape[0])}


def neighbor_sample(gen: torch.Generator, indptr, indices, seeds,
                    fanouts: tuple[int, ...] = (15, 10)) -> dict:
    """GraphSAGE-style uniform neighbor sampling with static shapes:
    F_0 = seeds (B,), F_{l+1} has |F_l| x fanout_l entries. The
    uniforms come from `gen` (sampler_uniforms), the rest is
    sample_from_uniforms. The caller gathers features for node_ids and
    runs the network on the block; seed predictions are
    node_ids[:B]."""
    uniforms = sampler_uniforms(gen, int(torch.as_tensor(seeds).shape[0]),
                                tuple(fanouts))
    return sample_from_uniforms(indptr, indices, seeds, uniforms)


def sampled_sizes(batch_nodes: int, fanouts: tuple[int, ...]
                  ) -> tuple[int, int]:
    """(n_sampled_nodes, n_sampled_edges) of a block."""
    n_nodes, n_edges, layer = batch_nodes, 0, batch_nodes
    for f in fanouts:
        n_edges += layer * f
        layer = layer * f
        n_nodes += layer
    return n_nodes, n_edges


def block_graph_from_sample(sample: dict, feats, d_edge: int) -> dict:
    """A MeshGraphNet graph dict from a neighbor_sample block. feats:
    (T, d_node_in) features for sample['node_ids']. Edge features are
    relative: x_src - x_dst over the first d_edge dims (a stand-in for
    mesh-relative coordinates)."""
    x = _as_tensor(feats, None)
    s = _as_tensor(sample["senders"], x.device)
    r = _as_tensor(sample["receivers"], x.device)
    diff = x[s.long(), :d_edge] - x[r.long(), :d_edge]
    return {"nodes": x, "edges": diff, "senders": s, "receivers": r}
