"""Distribution of the port (counterpart of repro.distributed): the
logical-axis rule tables and the distributed top-k merge over a mesh of
torch.devices driven by one process (launch/mesh.py).

Of JAX's exports, current_mesh, current_rules, logical_shard,
logical_spec, param_shardings and use_mesh_rules (the mesh-context half
of sharding.py) wait for the workload zoo that calls them, with
runner.py's FaultTolerantRunner (ROADMAP Queue 1 item 5). compat.py is
a JAX shim and has no counterpart.
"""

from repro_torch.distributed.sharding import RULES_BY_FAMILY, AxisRules
from repro_torch.distributed.topk import distributed_top_k, sharded_knn_topk

__all__ = ["AxisRules", "RULES_BY_FAMILY", "distributed_top_k",
           "sharded_knn_topk"]
