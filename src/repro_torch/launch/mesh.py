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

Mesh axes, as JAX's:
  single-pod  (16, 16)      ('data', 'model')
  multi-pod   (2, 16, 16)   ('pod', 'data', 'model')
  smoke       (2, 4) or (2, 2, 2), virtual on one device
"""

from __future__ import annotations

import math
from dataclasses import dataclass

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


@dataclass(frozen=True, eq=False)
class ShardedRows:
    """A tensor split by rows over one mesh axis, placed once: shard i
    holds rows offsets[i]:offsets[i] + rows on every device of the mesh
    whose `axis` position is i (one copy a physical device; a view where
    the tensor already lies there)."""

    mesh: Mesh
    axis: str
    n_rows: int
    rows: int
    copies: tuple[dict, ...]     # per shard: device -> its rows there

    @property
    def offsets(self) -> tuple[int, ...]:
        return tuple(i * self.rows for i in range(len(self.copies)))

    @property
    def shape(self) -> tuple[int, ...]:
        first = next(iter(self.copies[0].values()))
        return (self.n_rows,) + tuple(first.shape[1:])

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.copies[0].values())).dtype

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
    S = mesh.shape[axis]
    rows = split_dim(x.shape[0], S, f"rows over {axis!r}")
    copies = []
    for i in range(S):
        piece = x[i * rows:(i + 1) * rows]
        devs = dict.fromkeys(np.take(
            mesh.devices, [i], axis=mesh.axis_names.index(axis)).flat)
        copies.append({d: place(piece, d) for d in devs})
    return ShardedRows(mesh=mesh, axis=axis, n_rows=x.shape[0], rows=rows,
                       copies=tuple(copies))

