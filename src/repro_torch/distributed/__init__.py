"""Distribution of the port (counterpart of repro.distributed): the
logical-axis rule tables and the mesh context that resolves the
models' annotations (sharding.py), the distributed top-k merge over a
mesh of torch.devices driven by one process (launch/mesh.py) and the
fault-tolerant training runner (runner.py). Every name
repro.distributed.sharding defines is exported here, with the port's
NamedSharding. compat.py is a JAX shim and has no counterpart.
"""

from repro_torch.distributed.runner import FaultTolerantRunner, RunnerReport
from repro_torch.distributed.sharding import (
    GNN_RULES,
    LM_RULES,
    PAPER_RULES,
    RECSYS_RULES,
    RULES_BY_FAMILY,
    AxisRules,
    NamedSharding,
    current_mesh,
    current_rules,
    drop_nondivisible,
    eval_shape_with_sharding,
    filter_rules,
    logical_shard,
    logical_spec,
    named_sharding,
    param_shardings,
    use_mesh_rules,
)
from repro_torch.distributed.topk import distributed_top_k, sharded_knn_topk

__all__ = ["AxisRules", "FaultTolerantRunner", "GNN_RULES", "LM_RULES",
           "NamedSharding", "PAPER_RULES", "RECSYS_RULES", "RULES_BY_FAMILY",
           "RunnerReport", "current_mesh", "current_rules",
           "distributed_top_k", "drop_nondivisible",
           "eval_shape_with_sharding", "filter_rules", "logical_shard",
           "logical_spec", "named_sharding", "param_shardings",
           "sharded_knn_topk", "use_mesh_rules"]
