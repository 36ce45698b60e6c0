"""Device meshes of the port (counterpart of repro.launch.mesh).

A `Mesh` is a grid of torch.devices with JAX's axis names. One process
drives it: the shard bodies of core.serving_dist and distributed.topk
run from the calling thread, each on its shard's device, and only each
shard's k (or m2) candidates are gathered to the merging device, as
FAISS's GPU IndexShards serves a sharded index. A function, not a
module constant: importing this module touches no device.

Devices may repeat. A virtual mesh lays every shard on one device:
make_smoke_mesh's (2, 4) over cuda:0 is the counterpart of JAX's
--xla_force_host_platform_device_count=8, and on a machine with one
card it is the only way to run more than one shard. Times taken on
such a mesh measure the cost of splitting the work on one card, not an
interconnect.

Placement: `shard(mesh, x, spec)` lays a tensor over the mesh by a
spec (one mesh-axis entry per dim, the tuple AxisRules.resolve gives)
as a `Sharded`, each block placed once a physical device and a view
where the tensor already lies there; `Sharded.gather` puts the blocks
back into one tensor. `shard_rows` is the row-split case the KNN
database takes.

Mesh axes, as JAX's:
  single-pod  (16, 16)      ('data', 'model')
  multi-pod   (2, 16, 16)   ('pod', 'data', 'model')
  smoke       (2, 4) or (2, 2, 2), virtual on one device
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import ClassVar

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True, eq=False)
class Mesh:
    """A grid of torch.devices: `devices` (an object array whose shape is
    the mesh's), named by `axis_names`. `shape` maps each axis name to
    its size, as jax.sharding.Mesh.shape does."""

    devices: np.ndarray
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        if len(set(self.axis_names)) != len(self.axis_names):
            raise ValueError(f"repeated mesh axis in {self.axis_names}")

    def __repr__(self):
        return (f"Mesh({dict(zip(self.axis_names, self.devices.shape))}, "
                f"{list(self.physical_devices)})")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def axis_sizes(self) -> tuple[int, ...]:
        return tuple(self.devices.shape)

    @property
    def physical_devices(self) -> tuple[torch.device, ...]:
        """The distinct devices, in mesh order."""
        return tuple(dict.fromkeys(self.devices.flat))


def make_mesh(shape, axes, *, devices=None) -> Mesh:
    """A mesh of `shape` named `axes` over `devices` (any that resolve,
    repeats allowed), laid out in row-major order; None takes every
    visible card and raises when there are fewer than the shape needs."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = math.prod(shape)
    if devices is None:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < n:
            raise RuntimeError(f"a mesh of shape {shape} needs {n} cards; "
                               f"{found} visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [resolve_device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"a mesh of shape {shape} needs {n} devices, got "
                         f"{len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(devices=grid.reshape(shape), axis_names=axes)


def virtual_mesh(shape, axes, device=None) -> Mesh:
    """A mesh of `shape` whose every position is the one `device` (None =
    the card)."""
    dev = resolve_device(device)
    return make_mesh(shape, axes, devices=[dev] * math.prod(shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """JAX's production shapes over as many cards; raises on a machine
    with fewer."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_smoke_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """Tiny meshes for plumbing tests: (2, 4) ('data', 'model'), or
    (2, 2, 2) ('pod', 'data', 'model'), virtual on `device` (None = the
    card)."""
    shape = (2, 2, 2) if multi_pod else (2, 4)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return virtual_mesh(shape, axes, device)


# -- placement ---------------------------------------------------------------

def axis_size(mesh: Mesh, axes) -> int:
    """Product of the sizes of `axes` (a name, a tuple of names or None)."""
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    return math.prod(mesh.shape[a] for a in axes)


def split_dim(n: int, parts: int, what: str) -> int:
    """The size of each of `parts` equal blocks of a dimension of n; a
    dimension the mesh axis does not divide raises, as shard_map does."""
    if n % parts:
        raise ValueError(f"{what}: dimension {n} is not divisible by the "
                         f"mesh axis size {parts}")
    return n // parts


def shard_device(mesh: Mesh, coords: dict[str, int]) -> torch.device:
    """The device at the mesh position whose named axes are at `coords`
    and every other axis at 0."""
    return mesh.devices[tuple(coords.get(a, 0) for a in mesh.axis_names)]


def block_coords(mesh: Mesh, axes: tuple[str, ...], block: int) -> dict:
    """The positions on `axes` of the `block`-th block of a dimension
    split over them (row-major: the first axis is the slowest)."""
    sizes = [mesh.shape[a] for a in axes]
    return dict(zip(axes, np.unravel_index(block, sizes) if sizes else ()))


def place(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """x on `device`: itself where it lies there, else one copy."""
    return x if x.device == device else x.to(device, non_blocking=True)


def spec_entries(spec, ndim: int) -> tuple:
    """`spec` (one mesh-axis entry per leading dim: a name, a tuple of
    names or None) padded with None to `ndim` entries, each entry a
    tuple of names (() = replicated). More entries than dims, or a mesh
    axis named twice, raise, as NamedSharding does."""
    spec = tuple(spec)
    if len(spec) > ndim:
        raise ValueError(f"spec {spec} has more entries than the tensor's "
                         f"{ndim} dimensions")
    out, used = [], set()
    for entry in spec + (None,) * (ndim - len(spec)):
        axes = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        if used & set(axes):
            raise ValueError(f"spec {spec} names a mesh axis twice")
        used |= set(axes)
        out.append(axes)
    return tuple(out)


def block_of(mesh: Mesh, entries: tuple, pos: tuple) -> tuple:
    """The block index (one per dim) that the mesh position `pos` holds
    under `entries` (spec_entries' form): a dim split over axes (a, b)
    takes block pos[a] * size(b) + pos[b], the first axis slowest, as
    JAX tiles it; a replicated dim takes block 0."""
    out = []
    for axes in entries:
        i = 0
        for a in axes:
            j = mesh.axis_names.index(a)
            i = i * mesh.devices.shape[j] + pos[j]
        out.append(i)
    return tuple(out)


@dataclass(frozen=True, eq=False)
class Sharded:
    """A tensor of `shape` laid over a mesh by `spec` (one entry per
    dim: a mesh-axis name, a tuple of names or None), placed once:
    `blocks` maps each block index (one per dim) to {device: the block
    there}, with one copy a physical device that holds the block (a
    view where the tensor already lay there, so a virtual mesh copies
    nothing). JAX's jax.Array with a NamedSharding, as one process
    drives the port's mesh."""

    tree_leaf: ClassVar[bool] = True    # a leaf of a parameter tree

    mesh: Mesh
    spec: tuple
    shape: tuple
    dtype: torch.dtype
    blocks: dict

    @property
    def grid(self) -> tuple[int, ...]:
        """Blocks along each dim."""
        return tuple(axis_size(self.mesh, axes) for axes in
                     spec_entries(self.spec, len(self.shape)))

    def block_shape(self) -> tuple[int, ...]:
        return tuple(n // g for n, g in zip(self.shape, self.grid))

    def at(self, pos: tuple) -> torch.Tensor:
        """The block the mesh position `pos` holds, on that position's
        device."""
        blk = block_of(self.mesh, spec_entries(self.spec, len(self.shape)),
                       tuple(pos))
        return self.blocks[blk][self.mesh.devices[tuple(pos)]]

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on `device` (None = the mesh's first device):
        each block copied once into its place."""
        dev = self.mesh.devices.flat[0] if device is None else \
            resolve_device(device)
        if len(self.blocks) == 1:
            return place(next(iter(next(iter(self.blocks.values()))
                                   .values())), dev)
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        bs = self.block_shape()
        for blk, copies in self.blocks.items():
            piece = next(iter(copies.values()))
            out[tuple(slice(i * b, (i + 1) * b) for i, b in zip(blk, bs))
                ].copy_(piece)
        return out


def _place_blocks(mesh: Mesh, x: torch.Tensor, spec) -> dict:
    entries = spec_entries(spec, x.dim())
    bs = tuple(split_dim(n, axis_size(mesh, axes),
                         f"dim {i} over {axes}")
               for i, (n, axes) in enumerate(zip(x.shape, entries)))
    blocks: dict = {}
    for pos in np.ndindex(*mesh.devices.shape):
        blk = block_of(mesh, entries, pos)
        dev = mesh.devices[pos]
        copies = blocks.setdefault(blk, {})
        if dev not in copies:
            copies[dev] = place(x[tuple(slice(i * b, (i + 1) * b)
                                        for i, b in zip(blk, bs))], dev)
    return blocks


def shard(mesh: Mesh, x: torch.Tensor, spec) -> Sharded:
    """x laid over `mesh` by `spec` (JAX's jax.device_put(x,
    NamedSharding(mesh, P(*spec)))): each block placed once a physical
    device, a view where x lies there. A dim its mesh axes do not
    divide raises, as shard_map does."""
    spec = tuple(spec)
    return Sharded(mesh=mesh, spec=spec, shape=tuple(x.shape),
                   dtype=x.dtype, blocks=_place_blocks(mesh, x, spec))


@dataclass(frozen=True, eq=False)
class ShardedRows(Sharded):
    """A Sharded split by rows over one mesh axis (spec (axis,)): shard
    i holds rows offsets[i]:offsets[i] + rows on every device of the
    mesh whose `axis` position is i."""

    @property
    def axis(self) -> str:
        return self.spec[0]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def rows(self) -> int:
        return self.shape[0] // self.mesh.shape[self.axis]

    @property
    def copies(self) -> tuple[dict, ...]:
        """Per shard: device -> its rows there."""
        rest = (0,) * (len(self.shape) - 1)
        return tuple(self.blocks[(i,) + rest]
                     for i in range(self.mesh.shape[self.axis]))

    @property
    def offsets(self) -> tuple[int, ...]:
        return tuple(i * self.rows for i in range(len(self.copies)))

    def local(self, i: int, device: torch.device) -> torch.Tensor:
        return self.copies[i][device]


def shard_rows(mesh: Mesh, x, axis: str = "model") -> ShardedRows:
    """Place x's rows on `axis`'s shards, once: JAX's in_spec P(axis,
    None). A row count the axis does not divide raises. An already
    placed ShardedRows of this mesh and axis is returned as it is."""
    if isinstance(x, ShardedRows):
        if x.mesh is not mesh or x.axis != axis:
            raise ValueError(f"rows placed over {x.axis!r} of another mesh")
        return x
    split_dim(x.shape[0], mesh.shape[axis], f"rows over {axis!r}")
    return ShardedRows(mesh=mesh, spec=(axis,), shape=tuple(x.shape),
                       dtype=x.dtype, blocks=_place_blocks(mesh, x, (axis,)))
