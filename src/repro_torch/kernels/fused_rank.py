"""The rank kernels' wrappers (counterparts of
repro.kernels.fused_rank.fused_rank_pallas, rank_audited_pallas and
linear_rank_audited_pallas), beside their plain versions.

All three kernels (csrc/fused_rank.cu, csrc/rank_audited.cu,
csrc/linear_rank_audited.cu) rank a row with csrc/rank_audit.cuh's
rank_row, on one block or, when the batch is smaller than the card, on
a cluster of `rank_split` blocks; the two audited ones then audit the
row, and linear_rank_audited first forms lambda-hat = X W^T + c in its
prologue. On a CPU tensor a wrapper runs the plain version
(`ref.fused_rank_ref`, `ref.rank_audited_ref`,
`ref.linear_rank_audited_ref`), which takes any K and m2 <= m1; the
kernels take m2 <= MAX_KERNEL_M2 and any K whose shared memory fits.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.ranking import AUDIT_TOL
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.common import check_tensor
from repro_torch.kernels.ref import (
    fused_rank_ref,
    linear_rank_audited_ref,
    rank_audited_ref,
)

__all__ = ["MAX_KERNEL_M2", "check_rank_kernel", "fused_rank_cuda",
           "fused_rank_ref", "linear_rank_audited_cuda",
           "linear_rank_audited_ref", "rank_audited_cuda",
           "rank_audited_ref", "rank_split"]

MAX_KERNEL_M2 = 128
# rank_audit.cuh's staging buffer (kStage pairs); the blocks one row may
# be split over (a portable cluster) and the fewest candidates a split
# block takes; the dynamic shared memory a rank block may take (an H100
# block's opt-in 227 KB less room for the kernels' static arrays).
RANK_STAGE = 2048
MAX_SPLIT = 8
MIN_SLICE = 256
RANK_SMEM_MAX = 224 * 1024


def rank_smem_bytes(K: int, m2: int) -> int:
    """Dynamic shared memory of a rank block (rank_audit.cuh's
    smem_bytes): coef, the top-L, the staging buffer, the warp counts."""
    L = 1 << (m2 - 1).bit_length()
    return 4 * (K + 2 * L + 2 * RANK_STAGE + 16)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rank_split(n: int, m1: int, dev: torch.device) -> int:
    """Blocks each row's candidates are split over: 1 when the n rows
    alone give two blocks per SM, else enough for about four (at most
    MAX_SPLIT, each slice at least MIN_SLICE candidates)."""
    sms = _sm_count(torch.cuda.current_device() if dev.index is None
                    else dev.index)
    if n >= 2 * sms:
        return 1
    return max(1, min(MAX_SPLIT, -(-4 * sms // max(n, 1)),
                      m1 // MIN_SLICE))


def check_rank_args(u, a, b, lam, gamma, m2: int, dev: torch.device):
    """Validate the rank inputs (shapes, dtype, device, contiguity and
    1 <= m2 <= m1), which the plain versions and the kernels share;
    returns (n, m1, K). b and gamma are None for the unaudited
    fused_rank."""
    n, m1 = u.shape
    K = a.shape[1]
    if not 1 <= m2 <= m1:
        raise ValueError(f"need 1 <= m2 <= m1, got m2={m2}, m1={m1}")
    f32 = torch.float32
    check_tensor("u", u, (n, m1), f32, dev)
    check_tensor("a", a, (n, K, m1), f32, dev)
    if b is not None:
        check_tensor("b", b, (n, K), f32, dev)
    if gamma is not None:
        check_tensor("gamma", gamma, (n, m2), f32, dev)
    if lam is not None:
        check_tensor("lam", lam, (n, K), f32, dev)
    return n, m1, K


def check_rank_kernel(K: int, m2: int) -> None:
    """The rank kernels' own limits, checked on the card only: m2 <=
    MAX_KERNEL_M2, and K's coefficients beside the rank routine's buffers
    within one block's shared memory."""
    if m2 > MAX_KERNEL_M2:
        raise ValueError(f"the kernel takes m2 <= {MAX_KERNEL_M2}, got {m2}")
    if K < 1 or rank_smem_bytes(K, m2) > RANK_SMEM_MAX:
        raise ValueError(f"K={K}: the rank kernel needs 1 <= K and its "
                         f"shared memory within {RANK_SMEM_MAX} bytes")


def fused_rank_cuda(u, a, lam, *, m2: int, eps: float = 1e-4, device=None):
    """Adjusted-score top-m2: u (n, m1), a (n, K, m1), lam (n, K), all f32
    and contiguous on `device` (None = the card) -> (vals (n, m2) desc,
    idx (n, m2) int32), ties to the lower item index. One launch per
    call, whatever the split; every launch adds one to
    `fused_rank_cuda.launches`."""
    dev = resolve_device(device)
    n, m1, K = check_rank_args(u, a, None, lam, None, m2, dev)
    if dev.type == "cpu":
        return fused_rank_ref(u, a, lam, m2, eps)
    check_rank_kernel(K, m2)
    vals = torch.empty((n, m2), dtype=torch.float32, device=dev)
    idx = torch.empty((n, m2), dtype=torch.int32, device=dev)
    if n:
        build.launch(
            "fused_rank", u.data_ptr(), a.data_ptr(), lam.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), n, m1, K, m2,
            rank_split(n, m1, dev), float(np.float32(1.0 + eps)),
            torch.cuda.current_stream(dev).cuda_stream)
        fused_rank_cuda.launches += 1
    return vals, idx


fused_rank_cuda.launches = 0


def rank_audited_cuda(u, a, b, lam, gamma, *, m2: int, eps: float = 1e-4,
                      tol: float | None = None, device=None):
    """Rank + audit: u (n, m1), a (n, K, m1), b (n, K), lam (n, K),
    gamma (n, m2), all f32 and contiguous on `device` (None = the card)
    -> (vals (n, m2) desc, idx (n, m2) int32, utility (n,),
    exposure (n, K), compliant (n,) bool). One launch per call; every
    launch adds one to `rank_audited_cuda.launches`."""
    dev = resolve_device(device)
    tol = AUDIT_TOL if tol is None else tol
    n, m1, K = check_rank_args(u, a, b, lam, gamma, m2, dev)
    if dev.type == "cpu":
        return rank_audited_ref(u, a, b, lam, gamma, m2, eps, tol)
    check_rank_kernel(K, m2)
    vals = torch.empty((n, m2), dtype=torch.float32, device=dev)
    idx = torch.empty((n, m2), dtype=torch.int32, device=dev)
    util = torch.empty((n,), dtype=torch.float32, device=dev)
    expo = torch.empty((n, K), dtype=torch.float32, device=dev)
    comp = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        build.launch(
            "rank_audited", u.data_ptr(), a.data_ptr(), b.data_ptr(),
            lam.data_ptr(), gamma.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), util.data_ptr(), expo.data_ptr(),
            comp.data_ptr(), n, m1, K, m2, rank_split(n, m1, dev),
            float(np.float32(1.0 + eps)), float(tol),
            torch.cuda.current_stream(dev).cuda_stream)
        rank_audited_cuda.launches += 1
    return vals, idx, util, expo, comp != 0


rank_audited_cuda.launches = 0


def linear_rank_audited_cuda(u, a, b, X, W, c, gamma, *, m2: int,
                             eps: float = 1e-4, tol: float | None = None,
                             relu: bool = True, device=None):
    """Affine predict + rank + audit: lambda-hat = X W^T + c (clamped at 0
    if `relu`), then rank + audit. u (n, m1), a (n, K, m1), b (n, K),
    X (n, d), W (K, d), c (K,), gamma (n, m2), all f32 and contiguous on
    `device` (None = the card) -> (vals, idx int32, utility, exposure,
    compliant bool, lam (n, K)). One launch per call; every launch adds
    one to `linear_rank_audited_cuda.launches`."""
    dev = resolve_device(device)
    tol = AUDIT_TOL if tol is None else tol
    n, m1, K = check_rank_args(u, a, b, None, gamma, m2, dev)
    if X.dim() != 2 or X.shape[1] < 1:
        raise ValueError(f"X must be (n, d) with d >= 1, got "
                         f"{tuple(X.shape)}")
    d = X.shape[1]
    f32 = torch.float32
    check_tensor("X", X, (n, d), f32, dev)
    check_tensor("W", W, (K, d), f32, dev)
    check_tensor("c", c, (K,), f32, dev)
    if dev.type == "cpu":
        return linear_rank_audited_ref(u, a, b, X, W, c, gamma, m2, eps, tol,
                                       relu)
    check_rank_kernel(K, m2)
    vals = torch.empty((n, m2), dtype=f32, device=dev)
    idx = torch.empty((n, m2), dtype=torch.int32, device=dev)
    util = torch.empty((n,), dtype=f32, device=dev)
    expo = torch.empty((n, K), dtype=f32, device=dev)
    comp = torch.empty((n,), dtype=torch.int32, device=dev)
    lam = torch.empty((n, K), dtype=f32, device=dev)
    if n:
        build.launch(
            "linear_rank_audited", u.data_ptr(), a.data_ptr(), b.data_ptr(),
            X.data_ptr(), W.data_ptr(), c.data_ptr(), gamma.data_ptr(),
            vals.data_ptr(), idx.data_ptr(), util.data_ptr(),
            expo.data_ptr(), comp.data_ptr(), lam.data_ptr(), n, d, m1, K,
            m2, rank_split(n, m1, dev), int(bool(relu)),
            float(np.float32(1.0 + eps)), float(tol),
            torch.cuda.current_stream(dev).cuda_stream)
        linear_rank_audited_cuda.launches += 1
    return vals, idx, util, expo, comp != 0, lam


linear_rank_audited_cuda.launches = 0
