"""Architecture registry of the port (counterpart of
repro.configs.registry without XLA lowering): every registered arch is a
selectable config (``--arch <id>``) with its own shape-cell set.

Each ArchSpec provides make_config(full): the published config
(full=True) or a reduced same-family smoke config (full=False), its
cells, and `build(cfg, cell, mesh) -> Program`: the cell's program as a
callable on tensors, with its arguments as trees of ArgSpec (shape,
dtype and the NamedSharding JAX's Lowerable would carry, each relaxed
per leaf by drop_nondivisible as JAX's `sds` and `abstract_like` relax
it) and the rules it was built under. Nothing is materialised: a
build's parameter shapes come from the meta device. The program runs
on global tensors on one device; a caller that enters
`use_mesh_rules(mesh, program.rules)` gets the mesh-aware paths (the
'shmap' MoE); build_gnn's and build_lm's programs enter their own, and
the GNN's and the dense LMs' run partitioned. Donation (JAX's donate_argnums) has no meaning in eager
PyTorch and is left out.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, ClassVar, Mapping

import numpy as np
import torch

from repro_torch.checkpoint.store import flatten_with_paths
from repro_torch.distributed.sharding import (
    AxisRules,
    NamedSharding,
    drop_nondivisible,
    tree_map,
)
from repro_torch.optim import AdamState


@dataclass(frozen=True)
class Cell:
    """One assigned input shape for an architecture."""

    name: str                   # e.g. 'train_batch'
    kind: str                   # train | prefill | decode | serve | retrieval
    params: Mapping[str, Any] = field(default_factory=dict)

    def __getitem__(self, k):
        return self.params[k]


@dataclass(frozen=True)
class ArchSpec:
    name: str
    family: str                                  # lm | gnn | recsys | paper
    cells: tuple[Cell, ...]
    make_config: Callable[[bool], Any]
    build: Callable | None = None    # (cfg, cell, mesh) -> Program, or None
    notes: str = ""
    # name -> () -> the variant's full-scale config
    variants: Mapping[str, Callable[[], Any]] = field(default_factory=dict)

    def cell(self, name: str) -> Cell:
        for c in self.cells:
            if c.name == name:
                return c
        raise KeyError(f"{self.name}: no cell {name!r}; have "
                       f"{[c.name for c in self.cells]}")


@dataclass(frozen=True)
class ArgSpec:
    """The shape, dtype and sharding (None: no placement constraint) of
    one argument leaf of a Program: JAX's ShapeDtypeStruct."""

    tree_leaf: ClassVar[bool] = True    # a leaf of an argument tree

    shape: tuple[int, ...]
    dtype: torch.dtype
    sharding: NamedSharding | None = None


@dataclass(frozen=True)
class Program:
    """A cell's program: `fn` takes tensors (trees of them) of the
    shapes and dtypes of `args`, positionally, on one device; `rules`
    are the axis rules it was built under."""

    fn: Callable
    args: tuple
    rules: AxisRules | None = None


ARCH_REGISTRY: dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    ARCH_REGISTRY[spec.name] = spec
    return spec


def get_arch(name: str) -> ArchSpec:
    # import side-effect registration on first use
    import repro_torch.configs  # noqa: F401
    if name not in ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(ARCH_REGISTRY)}")
    return ARCH_REGISTRY[name]


def all_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401
    return sorted(ARCH_REGISTRY)


def args_from_numpy(spec, arrays, *, device=None):
    """An argument of a Program as tensors: `spec` its tree of ArgSpec,
    `arrays` a tree of the same paths (a JAX init's, say) or a flat
    {path: array} dict, each leaf checked against its ArgSpec's shape
    and cast to its dtype, on `device` (None = the card): the
    carry-across of the models' load_numpy / lm_from_numpy for a cell's
    arguments."""
    from repro_torch.checkpoint.store import unflatten_like
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    want = flatten_with_paths(spec)
    flat = (arrays if isinstance(arrays, dict) and set(arrays) == set(want)
            else flatten_with_paths(arrays))
    if set(flat) != set(want):
        raise ValueError(f"argument paths differ: "
                         f"{sorted(set(flat) ^ set(want))[:5]}")
    out = {}
    for path, a in want.items():
        v = flat[path]
        if tuple(np.shape(v)) != tuple(a.shape):
            raise ValueError(f"{path}: {tuple(np.shape(v))} != {a.shape}")
        out[path] = torch.from_numpy(np.array(v)).to(device=dev,
                                                     dtype=a.dtype)
    return unflatten_like(spec, out)


def pad_up(n: int, mult: int = 512) -> int:
    """Data-pipeline padding: n rounded up to a multiple of `mult`."""
    return -(-n // mult) * mult


# ---------------------------------------------------------------------------
# Shared abstract-arg helpers
# ---------------------------------------------------------------------------

def sds(shape, dtype, sharding=None) -> ArgSpec:
    """An ArgSpec, its NamedSharding relaxed to `shape` by
    drop_nondivisible."""
    shape = tuple(int(n) for n in shape)
    if isinstance(sharding, NamedSharding):
        sharding = NamedSharding(sharding.mesh, drop_nondivisible(
            sharding.spec, shape, sharding.mesh))
    return ArgSpec(shape, dtype, sharding)


def abstract_adam(params, shard, mesh, moment_dtype=torch.float32):
    """Adam's state over `params` (a tree of ArgSpec) as the port keeps
    it (optim.adam_init: moments over the flattened tree), each moment
    with its parameter's sharding, and a replicated step."""
    flat_p, flat_s = flatten_with_paths(params), flatten_with_paths(shard)
    mu = {k: sds(p.shape, moment_dtype, flat_s[k]) for k, p in flat_p.items()}
    return AdamState(step=sds((), torch.int32, NamedSharding(mesh, ())),
                     mu=mu, nu=dict(mu))


def abstract_like(tree, shardings=None):
    """A tree of tensors (meta ones too) or ArgSpecs -> ArgSpecs with the
    matching tree of shardings attached (None: no placement
    constraint); non-divisible dims are relaxed per leaf."""
    if shardings is None:
        return tree_map(lambda x: ArgSpec(tuple(x.shape), x.dtype), tree)
    return tree_map(lambda x, s: sds(x.shape, x.dtype, s), tree, shardings)
