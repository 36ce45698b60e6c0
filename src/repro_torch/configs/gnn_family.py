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
and target dims (dataclasses.replace). JAX's build_gnn, the cells'
programs over sharded abstract parameters with the graphs padded to
mesh-divisible sizes, waits for the mesh-context half of distribution
(ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

from dataclasses import replace

from repro_torch.configs.registry import Cell
from repro_torch.models.gnn import GNNConfig

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


def make_config(full: bool = True) -> GNNConfig:
    if full:
        return GNNConfig(name="meshgraphnet", n_layers=15, d_hidden=128,
                         mlp_layers=2, aggregator="sum", remat=True)
    return GNNConfig(name="meshgraphnet", n_layers=3, d_hidden=32,
                     mlp_layers=2, aggregator="sum", remat=False)
