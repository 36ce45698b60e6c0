"""meshgraphnet — encode-process-decode GNN [arXiv:2010.03409; unverified].

n_layers=15 d_hidden=128 aggregator=sum mlp_layers=2. Message passing is
a segment sum over an explicit edge list (models/gnn.py's aggregate, the
port's scatter substrate).

Paper-technique applicability: the constrained-ranking head does not
apply to a physics rollout (no ranking decision), so the arch is
implemented WITHOUT the technique; API compatibility (node_scores ->
ranking head) is exercised in tests and chip_smoke.py's phase G only.
"""

from repro_torch.configs.gnn_family import GNN_CELLS, build_gnn, make_config
from repro_torch.configs.registry import ArchSpec, register

SPEC = register(ArchSpec(
    name="meshgraphnet", family="gnn",
    cells=GNN_CELLS,
    make_config=make_config,
    build=build_gnn,
    notes="paper technique inapplicable (no ranking decision); "
          "implemented without it per instructions.",
))
