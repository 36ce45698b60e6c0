"""Logical-axis sharding rules and the mesh context (counterpart of
repro.distributed.sharding): a table per architecture family maps
logical axis names ('batch', 'heads', 'table_rows', 'users_db', ...) to
mesh axes, and a thread-local (mesh, rules) context resolves the
models' annotations against it.

`AxisRules.resolve` gives one mesh-axis entry per tensor dimension (a
name, a tuple of names, or None: replicated), the tuple JAX's
PartitionSpec holds; `NamedSharding(mesh, spec)` pairs it with a
launch.mesh.Mesh. `filter_rules` drops the axes a mesh does not have,
so ('pod', 'data') also serves the single-pod mesh.

The port has no SPMD partitioner: one process drives the mesh
(launch/mesh.py). Where JAX writes a shard body with shard_map
(layers.moe_apply_shmap, optim.compression), the port writes it over
distributed.topk.map_shards. The GNN's step and the dense LM programs,
which JAX only annotates, the port partitions by hand
(models.gnn.graph_plan, models.transformer.lm_plan: shard bodies and
distributed.topk's collectives). Elsewhere, where JAX only annotates
and leaves the rest to GSPMD, the port resolves the same specs but runs
the program on global tensors: `logical_shard` under an active context checks the
spec against the tensor and relaxes it as `drop_nondivisible` does,
and returns x unchanged in value, as with_sharding_constraint does;
with no context it is the identity, as JAX's is. So the specs match
JAX's, and placement is enforced only where there is a shard body
(`launch.mesh.shard` places a tensor by a spec; a checkpoint restores
onto a mesh through it).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from typing import Any, ClassVar, Mapping

import torch

from repro_torch.checkpoint.store import _is_record
from repro_torch.launch.mesh import Mesh, axis_size

_ctx = threading.local()


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


# --------------------------------------------------------------------------
# Shardings and trees of them
# --------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class NamedSharding:
    """A spec (one mesh-axis entry per leading dim, as AxisRules.resolve
    gives it) on a launch.mesh.Mesh: JAX's NamedSharding(mesh, P(*spec))."""

    tree_leaf: ClassVar[bool] = True    # a leaf of a tree of shardings

    mesh: Mesh
    spec: tuple

    def __eq__(self, other):
        return (isinstance(other, NamedSharding) and other.mesh is self.mesh
                and tuple(other.spec) == tuple(self.spec))

    def __hash__(self):
        return hash((id(self.mesh), tuple(self.spec)))


def tree_map(fn, tree, *rest, is_leaf=None):
    """fn over the leaves of `tree` (dicts, lists, tuples and dataclass
    records are nodes, as checkpoint.store walks them; None is an empty
    subtree), with the matching leaves of the `rest` trees, which share
    tree's structure at least down to its leaves."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if _is_record(tree):
        return type(tree)(**{
            f: tree_map(fn, getattr(tree, f), *(getattr(r, f) for r in rest),
                        is_leaf=is_leaf)
            for f in tree.__dataclass_fields__})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest),
                                   is_leaf=is_leaf)
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


# --------------------------------------------------------------------------
# Context + constraint helpers
# --------------------------------------------------------------------------

@contextlib.contextmanager
def use_mesh_rules(mesh: Mesh | None, rules: AxisRules | None):
    """Activate (mesh, rules) for `logical_shard` within the block (on
    this thread)."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, filter_rules(rules, mesh)) if (mesh and rules) \
        else None
    try:
        yield
    finally:
        _ctx.state = prev


def current_mesh() -> Mesh | None:
    st = getattr(_ctx, "state", None)
    return st[0] if st else None


def current_rules() -> AxisRules | None:
    st = getattr(_ctx, "state", None)
    return st[1] if st else None


def logical_spec(*logical: str | None) -> tuple:
    rules = current_rules()
    if rules is None:
        return ()
    return rules.resolve(*logical)


def drop_nondivisible(spec, shape, mesh: Mesh) -> tuple:
    """Relax a spec: replicate any dim whose size is not an exact
    multiple of its mesh-axis product (e.g. 40 heads on a 16-way 'model'
    axis, or batch 1), and drop repeated mesh axes (a spec may map each
    axis to at most one dim: the first use is kept). Returns one entry
    per dim of `shape`."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    used: set = set()
    for dim, entry in zip(shape, entries):
        if dim % axis_size(mesh, entry) != 0:
            entry = None
        if entry is not None:
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            if any(a in used for a in axes):
                entry = None
            else:
                used.update(axes)
        out.append(entry)
    return tuple(out)


def logical_shard(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """JAX's with_sharding_constraint against the active (mesh, rules):
    the spec is resolved and relaxed against x's shape as
    drop_nondivisible does; x comes back unchanged (the port runs the
    program on global tensors). The identity when no context is
    active."""
    st = getattr(_ctx, "state", None)
    if st is None:
        return x
    mesh, rules = st
    drop_nondivisible(rules.resolve(*logical), x.shape, mesh)
    return x


def named_sharding(*logical: str | None) -> NamedSharding | None:
    st = getattr(_ctx, "state", None)
    if st is None:
        return None
    mesh, rules = st
    return NamedSharding(mesh, rules.resolve(*logical))


# --------------------------------------------------------------------------
# Param shardings from logical-axis annotations
# --------------------------------------------------------------------------

def param_shardings(logical_axes: Any, mesh: Mesh, rules: AxisRules) -> Any:
    """Map a tree of per-dim logical-axis tuples to NamedShardings.

    `logical_axes` mirrors the params tree; each leaf is a tuple of
    logical axis names (or None), one per tensor dimension."""
    rules = filter_rules(rules, mesh)
    return tree_map(lambda axes: NamedSharding(mesh, rules.resolve(*axes)),
                    logical_axes, is_leaf=lambda x: isinstance(x, tuple))


def eval_shape_with_sharding(fn, logical_axes_fn, mesh, rules, *args):
    """jax.eval_shape + attach shardings (dry-run parameter stand-ins):
    fn(*args) runs on the meta device (nothing is allocated), and each
    output leaf comes back as a configs.registry.ArgSpec with its
    NamedSharding from logical_axes_fn()."""
    from repro_torch.configs.registry import ArgSpec

    with torch.device("meta"):
        shapes = fn(*args)
    shardings = param_shardings(logical_axes_fn(), mesh, rules)
    return tree_map(lambda s, sh: ArgSpec(tuple(s.shape), s.dtype, sh),
                    shapes, shardings)
