"""The rank + audit kernels' wrappers (counterparts of
repro.kernels.fused_rank.rank_audited_pallas and
linear_rank_audited_pallas), beside their plain versions.

Both kernels (csrc/rank_audited.cu, csrc/linear_rank_audited.cu) rank
one row per block; linear_rank_audited first forms lambda-hat = X W^T + c
in its prologue. On a CPU tensor a wrapper runs the plain version
(`ref.rank_audited_ref`, `ref.linear_rank_audited_ref`).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ranking import AUDIT_TOL
from repro_torch.device import resolve_device
from repro_torch.kernels import build
from repro_torch.kernels.common import MAX_KERNEL_K, SORT_MAX, check_tensor
from repro_torch.kernels.ref import linear_rank_audited_ref, rank_audited_ref

__all__ = ["MAX_KERNEL_M2", "linear_rank_audited_cuda",
           "linear_rank_audited_ref", "rank_audited_cuda",
           "rank_audited_ref", "sort_width"]

MAX_KERNEL_M2 = 128


def sort_width(m1: int, m2: int) -> int:
    """Pairs one bitonic sort holds: a power of two covering m1 (up to
    SORT_MAX) and at least twice m2, so a later tile always has room
    beside the running top-m2."""
    return min(SORT_MAX, 1 << (max(m1, 2 * m2) - 1).bit_length())


def check_rank_args(u, a, b, lam, gamma, m2: int, dev: torch.device):
    """Validate the rank+audit inputs of both kernels; returns (n, m1, K)."""
    n, m1 = u.shape
    K = a.shape[1]
    if not 1 <= m2 <= min(m1, MAX_KERNEL_M2):
        raise ValueError(f"the kernel needs 1 <= m2 <= min(m1, "
                         f"{MAX_KERNEL_M2}), got m2={m2}, m1={m1}")
    if not 1 <= K <= MAX_KERNEL_K:
        raise ValueError(f"the kernel takes 1 <= K <= {MAX_KERNEL_K}, "
                         f"got K={K}")
    f32 = torch.float32
    check_tensor("u", u, (n, m1), f32, dev)
    check_tensor("a", a, (n, K, m1), f32, dev)
    check_tensor("b", b, (n, K), f32, dev)
    check_tensor("gamma", gamma, (n, m2), f32, dev)
    if lam is not None:
        check_tensor("lam", lam, (n, K), f32, dev)
    return n, m1, K


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
            comp.data_ptr(), n, m1, K, m2, sort_width(m1, m2),
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
            m2, sort_width(m1, m2), int(bool(relu)),
            float(np.float32(1.0 + eps)), float(tol),
            torch.cuda.current_stream(dev).cuda_stream)
        linear_rank_audited_cuda.launches += 1
    return vals, idx, util, expo, comp != 0, lam


linear_rank_audited_cuda.launches = 0
