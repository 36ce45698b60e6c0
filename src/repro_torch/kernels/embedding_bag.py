"""The embedding_bag kernel's wrapper (counterpart of
repro.kernels.embedding_bag.embedding_bag_pallas), beside its plain
version.

The kernel (csrc/embedding_bag.cu) gives each bag a warp whose lanes lie
over the row's columns, and adds the valid slots' rows in slot order in
f32. On a CPU tensor the wrapper runs the plain version
(`ref.embedding_bag_ref`).
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor
from repro_torch.kernels.ref import embedding_bag_ref

__all__ = ["embedding_bag_cuda", "embedding_bag_ref"]


def embedding_bag_cuda(table, indices, weights=None, *, device=None):
    """Sum-mode EmbeddingBag: table (V, D) f32 or bf16, indices
    (n_bags, bag) int32 (< 0 is padding; every other entry must be < V:
    the kernel does not check), weights (n_bags, bag) f32 or None (all
    ones), contiguous on `device` (None = the card) -> (n_bags, D) in
    table.dtype. One launch per call; every launch adds one to
    `embedding_bag_cuda.launches`."""
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
    if dev.type == "cpu":
        return embedding_bag_ref(table, indices, weights)
    out = torch.empty((n_bags, D), dtype=table.dtype, device=dev)
    if n_bags and D:
        build.launch(
            "embedding_bag", table.data_ptr(), indices.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            n_bags, bag, D, int(table.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
        embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
