"""The embedding_bag kernel's wrapper (counterpart of
repro.kernels.embedding_bag.embedding_bag_pallas), its card geometry and
its plain version.

The kernel (csrc/embedding_bag.cu) reads a row in vectors of up to 16
bytes a lane. `bag_geometry`, a pure function of the row's width, the
table's item size and the pointers' alignment, picks the vector, the
lanes a row takes, the bags a warp serves and the column passes; every
width gets a plan. A warp's lane groups serve rounds of consecutive
bags, read their (bag, slot) pairs' indices and weights a batch at a
time, one a lane, and keep a chunk of rows in flight before adding them
in slot order in f32. On a CPU tensor the wrapper runs the plain version
(`ref.embedding_bag_ref`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor
from repro_torch.kernels.ref import embedding_bag_ref

__all__ = ["BagGeometry", "bag_geometry", "embedding_bag_cuda",
           "embedding_bag_ref"]

VECTOR_BYTES = (16, 8, 4, 2)    # the loads a lane may issue, widest first
_MAX_INDEX = 2**31 - 1          # the largest int32 index


class BagGeometry(NamedTuple):
    """The embedding_bag kernel's shape on the card."""
    vec: int          # bytes a lane reads of a row at a time
    lanes: int        # lanes one pass over a row takes (at most 32)
    groups: int       # lane groups of a warp, each serving one bag at a time
    rounds: int       # bags a lane group serves in turn
    passes: int       # column passes over a row, each a warp of its own


@functools.lru_cache(maxsize=256)
def bag_geometry(D: int, itemsize: int, ptr_align: int,
                 bag: int) -> BagGeometry:
    """The plan for rows of D >= 1 items of `itemsize` bytes, read from
    and written to pointers aligned to `ptr_align` bytes, in bags of
    `bag` slots: the widest vector of VECTOR_BYTES (at least an item)
    that divides both the row's bytes and the alignment, so every row
    starts on a vector; a row of n vectors takes n lanes where n < 32,
    and a warp then serves 32 // n bags side by side, else 32 lanes in
    ceil(n / 32) passes; a lane group serves lanes // bag bags in turn
    (at least one), so that one batch of `lanes` indices, one a lane,
    covers several short bags."""
    row = D * itemsize
    vec = max((v for v in VECTOR_BYTES
               if v >= itemsize and row % v == 0 and ptr_align % v == 0),
              default=itemsize)
    n_vec = max(1, row // vec)
    lanes = min(32, n_vec)
    return BagGeometry(vec, lanes, 32 // lanes, max(1, lanes // max(bag, 1)),
                       -(-n_vec // 32))


def _alignment(ptr: int) -> int:
    """The largest power of two up to 16 that divides `ptr`."""
    return min(16, ptr & -ptr) if ptr else 16


def embedding_bag_cuda(table, indices, weights=None, *, device=None):
    """Sum-mode EmbeddingBag: table (V, D) f32 or bf16, indices
    (n_bags, bag) int32 (< 0 is padding; an index >= V reads row V - 1,
    as the JAX oracle's clamped gather does), weights (n_bags, bag) f32
    or None (all ones), contiguous on `device` (None = the card) ->
    (n_bags, D) in table.dtype. A table of no rows has none to gather
    (the JAX oracle refuses it too). One launch per call; every launch
    adds one to `embedding_bag_cuda.launches`."""
    dev = resolve_device(device)
    if table.dim() != 2 or table.dtype not in (torch.float32,
                                               torch.bfloat16):
        raise ValueError(f"table must be (V, D) f32 or bf16, got "
                         f"{tuple(table.shape)} {table.dtype}")
    V, D = table.shape
    n_bags, bag = indices.shape
    check_tensor("table", table, (V, D), table.dtype, dev)
    check_tensor("indices", indices, (n_bags, bag), torch.int32, dev)
    if weights is not None:
        check_tensor("weights", weights, (n_bags, bag), torch.float32, dev)
    if V == 0 and indices.numel():
        raise ValueError("the table has no rows to gather")
    if dev.type == "cpu":
        return embedding_bag_ref(table, indices, weights)
    out = torch.empty((n_bags, D), dtype=table.dtype, device=dev)
    if n_bags and D:
        geo = bag_geometry(D, table.element_size(),
                           min(_alignment(table.data_ptr()),
                               _alignment(out.data_ptr())), bag)
        build.launch(
            "embedding_bag", table.data_ptr(), indices.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            n_bags, bag, D, min(V, _MAX_INDEX + 1) - 1,
            int(table.dtype == torch.bfloat16), *geo,
            torch.cuda.current_stream(dev).cuda_stream)
        embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
