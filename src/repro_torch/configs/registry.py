"""Architecture registry of the port (counterpart of the non-lowering
part of repro.configs.registry): every registered arch is a selectable
config (``--arch <id>``) with its own shape-cell set.

Each ArchSpec provides make_config(full): the published config
(full=True) or a reduced same-family smoke config (full=False), and its
cells. `build(cfg, cell, mesh) -> Program` gives a cell's program as a
callable on tensors with its arguments' shapes and dtypes (the JAX
package's Lowerable without shardings or lowering): paper-ranking has
one. The LM, recsys and GNN archs' JAX `build` gives their cells'
programs over sharded abstract parameters for the dry run, which waits
for the mesh-context half of distribution (ROADMAP Queue 1 item 4):
theirs is None.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

import torch


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
    """The shape and dtype of one argument of a Program."""

    shape: tuple[int, ...]
    dtype: torch.dtype


@dataclass(frozen=True)
class Program:
    """A cell's program: `fn` takes tensors of the shapes and dtypes of
    `args`, positionally, on one device."""

    fn: Callable
    args: tuple[ArgSpec, ...]


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


def pad_up(n: int, mult: int = 512) -> int:
    """Data-pipeline padding: n rounded up to a multiple of `mult`."""
    return -(-n // mult) * mult
