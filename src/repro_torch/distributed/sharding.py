"""Logical-axis sharding rules (counterpart of the rules half of
repro.distributed.sharding): a table per architecture family maps
logical axis names ('batch', 'users_db', 'items', ...) to mesh axes.

`AxisRules.resolve` gives one mesh-axis entry per tensor dimension (a
name, a tuple of names, or None: replicated), the tuple JAX's
PartitionSpec holds; the port's sharded functions take it to decide
which dimension a mesh axis splits. `filter_rules` drops the axes a
mesh does not have, so ('pod', 'data') also serves the single-pod mesh.

The mesh-context half (use_mesh_rules, current_mesh, current_rules,
logical_spec, logical_shard, named_sharding, param_shardings,
drop_nondivisible, eval_shape_with_sharding) annotates the zoo's
models and the dry run and waits for them (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping


@dataclass(frozen=True)
class AxisRules:
    """Mapping logical axis name -> mesh axis name(s) (or None = replicate)."""

    rules: Mapping[str, Any] = field(default_factory=dict)

    def resolve(self, *logical: str | None) -> tuple:
        """Logical axis names (one per tensor dim; None = replicated dim) ->
        one mesh-axis entry per dim. Unknown names replicate."""
        return tuple(self.rules.get(name) if name else None
                     for name in logical)

    def override(self, **updates) -> "AxisRules":
        """New AxisRules with some logical names remapped."""
        merged = dict(self.rules)
        merged.update(updates)
        return AxisRules(merged)


def _filter_entry(entry, mesh_axes: frozenset[str]):
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry if entry in mesh_axes else None
    kept = tuple(a for a in entry if a in mesh_axes)
    return kept if kept else None


def filter_rules(rules: AxisRules, mesh) -> AxisRules:
    """`rules` with every mesh axis that `mesh` lacks dropped."""
    axes = frozenset(mesh.axis_names)
    return AxisRules({k: _filter_entry(v, axes) for k, v in rules.rules.items()})


# --------------------------------------------------------------------------
# Per-family rule tables (data, as JAX's)
# --------------------------------------------------------------------------

LM_RULES = AxisRules({
    # activations
    "batch": ("pod", "data"),
    "seq": None,                 # sequence replicated by default (SP optional)
    "seq_shard": "model",        # KV-cache sequence sharding (decode cells)
    "seq_attn": "model",         # attention-score q-seq sharding (dense path)
    "heads": "model",
    "kv_heads": "model",
    "embed": None,               # activation d_model dim replicated
    "mlp": "model",              # activation d_ff dim (TP)
    "kv_batch": ("pod", "data"),
    # params: FSDP shards the non-TP dim over 'data'; TP dim over 'model'
    "embed_fsdp": "data",
    "vocab": "model",
    "qkv_in": "data",            # wq/wk/wv input dim (FSDP all-gather per layer)
    "qkv_out": "model",          # column parallel
    "o_in": "model",             # row parallel
    "o_out": "data",
    "ffn_in": "data",
    "ffn_out": "model",
    "ffn_down_in": "model",
    "ffn_down_out": "data",
    "experts": "model",          # EP
    # FSDP inside each expert shard. ('pod','data') = ZeRO-3 across pods:
    # required to FIT 1T-param optimizer state (DESIGN.md §4 records the
    # DCN cost; the single-pod mesh simply filters 'pod' away).
    "expert_in": ("pod", "data"),
    "expert_out": None,
    # dispatch-buffer capacity axis (sort-dispatch §Perf variant)
    "expert_cap": ("pod", "data"),
    "layers": None,              # scan-stacked leading dim, never sharded
    "norm": None,
})

RECSYS_RULES = AxisRules({
    "batch": ("pod", "data"),
    "seq": None,
    "heads": None,
    "embed": None,
    "mlp": None,
    "table_rows": "model",       # the tables ARE the model: row-sharded
    "table_dim": None,
    "candidates": ("data", "model"),  # retrieval: 10^6 candidates sharded
    "dense_in": None,            # small dense MLP replicated
    "dense_out": None,
    "norm": None,
    "layers": None,
    "vocab": "model",
})

GNN_RULES = AxisRules({
    "nodes": ("pod", "data"),
    "edges": ("pod", "data"),
    "batch": ("pod", "data"),
    "feat": None,
    "mlp_in": None,
    "mlp_out": None,
    "norm": None,
    "layers": None,
})

PAPER_RULES = AxisRules({
    # The ranking-under-constraints serving fleet (DESIGN.md §4): users over
    # (pod, data); the KNN train-user DB and item catalog over 'model'.
    "batch": ("pod", "data"),
    "users_db": "model",
    "items": "model",
    "covariates": None,
    "constraints": None,
    "embed": None,
    "mlp": None,
    "norm": None,
    "layers": None,
})

RULES_BY_FAMILY = {
    "lm": LM_RULES,
    "recsys": RECSYS_RULES,
    "gnn": GNN_RULES,
    "paper": PAPER_RULES,
}
