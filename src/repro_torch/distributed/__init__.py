"""Distribution of the port (counterpart of repro.distributed): the
logical-axis rule tables, the distributed top-k merge over a mesh of
torch.devices driven by one process (launch/mesh.py) and the
fault-tolerant training runner (runner.py).

Of JAX's exports, current_mesh, current_rules, logical_shard,
logical_spec, param_shardings and use_mesh_rules (the mesh-context half
of sharding.py) wait for the sharded training that calls them (ROADMAP
Queue 1 item 4). compat.py is a JAX shim and has no counterpart.
"""

from repro_torch.distributed.runner import FaultTolerantRunner, RunnerReport
from repro_torch.distributed.sharding import RULES_BY_FAMILY, AxisRules
from repro_torch.distributed.topk import distributed_top_k, sharded_knn_topk

__all__ = ["AxisRules", "FaultTolerantRunner", "RULES_BY_FAMILY",
           "RunnerReport", "distributed_top_k", "sharded_knn_topk"]
