"""GNN-family (meshgraphnet) cells (counterpart of the non-lowering part
of repro.configs.gnn_family).

Shape cells span three data regimes:
  full_graph_sm   2 708 nodes / 10 556 edges / d_feat 1433 (full-batch)
  minibatch_lg    232 965-node graph, sampled blocks: 1 024 seeds x
                  fanout (15, 10) -> 169 984 nodes / 168 960 edges
                  (static shapes; the uniform sampler is
                  models/gnn.neighbor_sample)
  ogb_products    2 449 029 nodes / 61 859 140 edges / d_feat 100
                  (full-batch-large)
  molecule        128 x (30 nodes / 64 edges) batched small graphs

The MeshGraphNet core config (15 layers, d_hidden 128, sum aggregation,
2-layer MLPs) is fixed; encoder/decoder widths adapt per cell's feature
and target dims (dataclasses.replace).

`build_gnn(cfg, cell, mesh)` gives the cell's Program: gnn_train_step
on (params, AdamState, graph), the parameters replicated, the node and
edge arrays over the batch axes ('nodes', 'edges'), node and edge
counts padded to mesh-divisible sizes by pad_up (per graph for the
batched molecule cell). The program runs under its mesh and rules, so
where ('pod', 'data') holds more than one block the step runs as shard
bodies, one a block (models.gnn.graph_plan), as JAX's jit partitions
the annotated step over the mesh it runs under. `pad_graph` pads a graph the way the specs
expect: padding edges self-loop onto padding nodes whose features and
targets are zero.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from repro_torch.configs.registry import (
    Cell,
    Program,
    abstract_adam,
    abstract_like,
    pad_up,
    sds,
)
from repro_torch.distributed.sharding import (
    GNN_RULES,
    NamedSharding,
    filter_rules,
    param_shardings,
    use_mesh_rules,
)
from repro_torch.models.gnn import (
    GNNConfig,
    gnn_init,
    gnn_logical_axes,
    gnn_train_step,
    sampled_sizes,
)

GNN_CELLS = (
    Cell("full_graph_sm", "train",
         {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "d_out": 7}),
    Cell("minibatch_lg", "train_sampled",
         {"n_graph_nodes": 232_965, "batch_nodes": 1024,
          "fanouts": (15, 10), "d_feat": 602, "d_out": 41}),
    Cell("ogb_products", "train",
         {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100,
          "d_out": 47}),
    Cell("molecule", "train_batched",
         {"batch": 128, "n_nodes": 30, "n_edges": 64, "d_feat": 16,
          "d_out": 3}),
)

GNN_SMOKE_CELLS = (
    Cell("full_graph_sm", "train",
         {"n_nodes": 40, "n_edges": 120, "d_feat": 24, "d_out": 4}),
    Cell("minibatch_lg", "train_sampled",
         {"n_graph_nodes": 200, "batch_nodes": 8, "fanouts": (3, 2),
          "d_feat": 12, "d_out": 4}),
    Cell("ogb_products", "train",
         {"n_nodes": 60, "n_edges": 150, "d_feat": 10, "d_out": 5}),
    Cell("molecule", "train_batched",
         {"batch": 4, "n_nodes": 6, "n_edges": 10, "d_feat": 8, "d_out": 2}),
)

D_EDGE = 8  # relative-feature edge dim (mesh-relative coordinate stand-in)


def cell_config(cfg: GNNConfig, cell: Cell) -> GNNConfig:
    return replace(cfg, d_node_in=cell["d_feat"], d_edge_in=D_EDGE,
                   d_out=cell["d_out"])


def graph_sizes(cell: Cell) -> tuple[int, int]:
    """(nodes, edges) of one of the cell's graphs, before padding."""
    if cell.kind == "train_sampled":
        return sampled_sizes(cell["batch_nodes"], tuple(cell["fanouts"]))
    return cell["n_nodes"], cell["n_edges"]


def _graph_specs(cell: Cell, mesh, rules, *, batched: bool = False) -> dict:
    nodes_sh = NamedSharding(mesh, rules.resolve("nodes", None))
    edges_sh = NamedSharding(mesh, rules.resolve("edges", None))
    evec_sh = NamedSharding(mesh, rules.resolve("edges"))
    # graph loaders pad node/edge arrays to mesh-divisible sizes
    # (padding edges self-loop onto padding nodes with zero features)
    N, E = (pad_up(n) for n in graph_sizes(cell))
    f32, i32 = torch.float32, torch.int32
    g = {
        "nodes": sds((N, cell["d_feat"]), f32, nodes_sh),
        "edges": sds((E, D_EDGE), f32, edges_sh),
        "senders": sds((E,), i32, evec_sh),
        "receivers": sds((E,), i32, evec_sh),
        "targets": sds((N, cell["d_out"]), f32, nodes_sh),
    }
    if cell.kind == "train_sampled":
        g["node_mask"] = sds((N,), f32,
                             NamedSharding(mesh, rules.resolve("nodes")))
    if batched:
        B = cell["batch"]
        bsh3 = NamedSharding(mesh, rules.resolve("batch", None, None))
        bsh2 = NamedSharding(mesh, rules.resolve("batch", None))
        g = {k: sds((B,) + v.shape, v.dtype,
                    bsh3 if len(v.shape) == 2 else bsh2)
             for k, v in g.items()}
    return g


def pad_graph(graph: dict, n_nodes: int, n_edges: int) -> dict:
    """A graph (leaves with an optional leading batch dim) padded to
    n_nodes and n_edges: zero features, targets and mask on the padding
    nodes; padding edge j has zero features and self-loops onto padding
    node j mod (the padding nodes), so no real node receives it."""
    nodes = graph["nodes"]
    lead = nodes.shape[:-2]
    N, E = nodes.shape[-2], graph["senders"].shape[-1]
    if n_nodes < N or n_edges < E:
        raise ValueError(f"cannot pad {N} nodes / {E} edges down to "
                         f"{n_nodes} / {n_edges}")
    if n_edges > E and n_nodes == N:
        raise ValueError("padding edges need a padding node to loop on")
    dev = nodes.device

    def pad(x, n, axis):
        shape = list(x.shape)
        shape[axis] = n - x.shape[axis]
        return torch.cat([x, torch.zeros(shape, dtype=x.dtype, device=dev)],
                         dim=axis)

    loop = N + torch.arange(n_edges - E, device=dev) % max(n_nodes - N, 1)
    loop = loop.expand(lead + loop.shape)
    out = {}
    for k, v in graph.items():
        if k in ("senders", "receivers"):
            out[k] = torch.cat([v, loop.to(v.dtype)], dim=-1)
        elif k == "edges":
            out[k] = pad(v, n_edges, v.dim() - 2)
        elif k == "node_mask":
            out[k] = pad(v, n_nodes, v.dim() - 1)
        else:
            out[k] = pad(v, n_nodes, v.dim() - 2)
    return out


def build_gnn(cfg: GNNConfig, cell: Cell, mesh) -> Program:
    """The cell's program over `mesh`: gnn_train_step(params, opt,
    graph) at the cell's widths (cell_config) on the padded graph."""
    rules = filter_rules(GNN_RULES, mesh)
    ccfg = cell_config(cfg, cell)
    shard = param_shardings(gnn_logical_axes(ccfg), mesh, rules)
    params = abstract_like(gnn_init(None, ccfg, device="meta"), shard)
    opt = abstract_adam(params, shard, mesh)
    graph = _graph_specs(cell, mesh, rules,
                         batched=(cell.kind == "train_batched"))

    def fn(params, opt, graph):
        with use_mesh_rules(mesh, rules):
            return gnn_train_step(params, opt, graph, ccfg)

    return Program(fn=fn, args=(params, opt, graph), rules=rules)


def make_config(full: bool = True) -> GNNConfig:
    if full:
        return GNNConfig(name="meshgraphnet", n_layers=15, d_hidden=128,
                         mlp_layers=2, aggregator="sum", remat=True)
    return GNNConfig(name="meshgraphnet", n_layers=3, d_hidden=32,
                     mlp_layers=2, aggregator="sum", remat=False)
