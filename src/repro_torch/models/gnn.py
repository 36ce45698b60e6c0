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
from repro_torch.distributed.sharding import logical_shard
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


def _layer(params: dict, i: int) -> dict:
    """Processor step i's parameters out of the stacked tree."""
    proc = params["processor"]
    flat = flatten_with_paths(proc)
    return unflatten_like(proc, {k: v[i] for k, v in flat.items()})


def _proc_step(v, e, p_layer, senders, receivers, n_nodes, cfg):
    msg_in = torch.cat([e, v[senders], v[receivers]], dim=-1)
    e = e + _mlp_apply(p_layer["edge_mlp"], msg_in, cfg)
    agg = aggregate(e, receivers, n_nodes, cfg.aggregator)
    v = v + _mlp_apply(p_layer["node_mlp"], torch.cat([v, agg], dim=-1),
                       cfg)
    return logical_shard(v, "nodes", None), logical_shard(e, "edges", None)


def gnn_forward(params: dict, graph: dict, cfg: GNNConfig) -> torch.Tensor:
    """One graph {nodes (N, d_node_in), edges (E, d_edge_in), senders,
    receivers (E,)} -> (N, d_out) per-node predictions, on the
    parameters' device."""
    dev = _param_device(params)
    nodes = _as_tensor(graph["nodes"], dev, cfg.dtype)
    edges = _as_tensor(graph["edges"], dev, cfg.dtype)
    senders = _as_tensor(graph["senders"], dev, torch.long)
    receivers = _as_tensor(graph["receivers"], dev, torch.long)
    N = nodes.shape[0]

    v = logical_shard(_mlp_apply(params["node_encoder"], nodes, cfg),
                      "nodes", None)
    e = logical_shard(_mlp_apply(params["edge_encoder"], edges, cfg),
                      "edges", None)
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.n_layers):
        p_layer = _layer(params, i)
        if remat:
            v, e = checkpoint(_proc_step, v, e, p_layer, senders, receivers,
                              N, cfg, use_reentrant=False)
        else:
            v, e = _proc_step(v, e, p_layer, senders, receivers, N, cfg)
    return _mlp_apply(params["decoder"], v, cfg)


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
    dev = _param_device(params)
    g = {k: _as_tensor(graph[k], dev)
         for k in ("nodes", "edges", "senders", "receivers")}
    B, N = g["nodes"].shape[:2]
    return gnn_forward(params, flatten_batch(g), cfg).reshape(B, N, -1)


def gnn_loss(params: dict, graph: dict, cfg: GNNConfig):
    """Squared error -> (loss, {"loss": loss}): the mean over every
    prediction, or with a node_mask the masked sum over
    sum(mask) x d_out + 1e-9."""
    dev = _param_device(params)
    batched = len(graph["nodes"].shape) == 3
    pred = (gnn_forward_batched if batched else gnn_forward)(
        params, graph, cfg)
    err = (pred - _as_tensor(graph["targets"], dev, pred.dtype)) ** 2
    mask = graph.get("node_mask")
    if mask is not None:
        mask = _as_tensor(mask, dev, pred.dtype)
        err = err * mask[..., None]
        denom = torch.sum(mask) * pred.shape[-1] + 1e-9
        loss = torch.sum(err) / denom
    else:
        loss = torch.mean(err)
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
    """(loss, metrics, gradient tree), as jax.value_and_grad gives them."""
    flat = flatten_with_paths(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    with torch.enable_grad():
        loss, _ = gnn_loss(unflatten_like(params, leaves), graph, cfg)
        g = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    g = {k: torch.zeros_like(v) if gk is None else gk
         for (k, v), gk in zip(leaves.items(), g)}
    loss = loss.detach()
    return loss, {"loss": loss}, unflatten_like(params, g)


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
    Indexes in int64. Returns {node_ids (T,), senders, receivers
    (E,) int32 indices into node_ids, n_seeds}."""
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
        nbr = indices[start[:, None] + pick.long()]            # (F, f)
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
