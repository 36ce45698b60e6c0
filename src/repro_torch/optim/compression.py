"""Gradient compression for cross-pod data parallelism (counterpart of
repro.optim.compression): an int8 quantized all-reduce with a
per-tensor scale, and error feedback (the residual carried to the next
step).

JAX writes `compressed_psum` against jax.lax.psum inside shard_map. The
port has no SPMD partitioner: one process drives the mesh
(launch/mesh.py), so the collectives are shard bodies over a mesh axis.
Each takes one block a shard along `axis_name` (a name or a tuple of
names; the blocks in the shard order of distributed.topk.map_shards,
each on its shard's device) and returns one result a shard, on that
shard's device. The pmax gathers each shard's scale to the first
shard's device and the psum each shard's int32 accumulators, summed in
shard order there; the result goes back to every shard. The psum is an
int32 sum, so it is exact.

Everything here is elementwise IEEE arithmetic (true division, every
divisor a tensor, torch.round half to even as jnp.round) or exact, so it
gives JAX's bits, on the card too.
Plain torch ops: JAX has no Pallas kernel for it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.launch.mesh import (
    Mesh,
    axis_size,
    block_coords,
    place,
    shard_device,
)


def compress_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale ())."""
    amax = torch.max(torch.abs(x)) + 1e-12
    # a tensor divisor: on the card a Python scalar one takes PyTorch's
    # multiply-by-the-reciprocal path, which rounds otherwise
    scale = amax / torch.full_like(amax, 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _axes(mesh: Mesh, axis_name, n: int) -> tuple[str, ...]:
    axes = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    missing = [a for a in axes if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"the mesh has no axis {missing}")
    if n != axis_size(mesh, axes):
        raise ValueError(f"{n} blocks for the {axis_size(mesh, axes)} "
                         f"shards of {axes}")
    return axes


def _each_shard(mesh: Mesh, axes, n: int, body) -> list:
    """body(i, device) for the n shards along `axes`, over
    distributed.topk.map_shards (the axes as its block axes, no shard
    axis): each body on its shard's device, its outputs gathered to the
    first shard's device, in shard order."""
    # imported here: distributed.topk imports the kernel dispatcher,
    # whose predictors import this package
    from repro_torch.distributed.topk import map_shards

    root = shard_device(mesh, block_coords(mesh, axes, 0))
    return [parts[0] for _, parts in map_shards(
        mesh, None, axes, n, lambda rows, si, dev: body(rows.start, dev),
        root)]


def _to_shards(mesh: Mesh, axes, values) -> list[torch.Tensor]:
    """values[i] on the device of shard i along `axes`."""
    return [place(v, shard_device(mesh, block_coords(mesh, axes, i)))
            for i, v in enumerate(values)]


def _psum_root(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return s


def compressed_psum(xs: Sequence[torch.Tensor], axis_name,
                    mesh: Mesh) -> list[torch.Tensor]:
    """int8-quantized psum over `axis_name` (e.g. the cross-pod axis):
    xs holds one block a shard. Quantize locally against the shards'
    largest scale (pmax), all-reduce the int32 accumulators, dequantize.
    The error is bounded by scale/2 per element per shard; callers pair
    it with error feedback."""
    axes = _axes(mesh, axis_name, len(xs))
    n = len(xs)
    scales = _each_shard(mesh, axes, n, lambda i, dev: compress_int8(
        place(xs[i], dev))[1])
    scale_max = scales[0]
    for s in scales[1:]:
        scale_max = torch.maximum(scale_max, s)
    acc = _psum_root(_each_shard(mesh, axes, n, lambda i, dev: torch.clamp(
        torch.round(place(xs[i], dev) / place(scale_max, dev)), -127, 127)
        .to(torch.int8).to(torch.int32)))
    return _to_shards(mesh, axes, _each_shard(
        mesh, axes, n, lambda i, dev: place(acc, dev).to(torch.float32)
        * place(scale_max, dev)))


def psum_with_error_feedback(xs: Sequence[torch.Tensor],
                             residuals: Sequence[torch.Tensor], axis_name,
                             mesh: Mesh):
    """Compressed psum with error feedback: returns (each shard's mean
    gradient, each shard's new residual), one a shard."""
    axes = _axes(mesh, axis_name, len(xs))
    xc = _to_shards(mesh, axes, _each_shard(
        mesh, axes, len(xs), lambda i, dev: place(xs[i], dev)
        + place(residuals[i], dev)))
    new_residual = _to_shards(mesh, axes, _each_shard(
        mesh, axes, len(xs), lambda i, dev: xc[i] - decompress_int8(
            *compress_int8(xc[i]))))
    summed = compressed_psum(xc, axes, mesh)
    n = _psum_root([torch.ones((), dtype=x.dtype, device=x.device)
                    for x in xc])
    return [s / place(n, s.device) for s in summed], new_residual
