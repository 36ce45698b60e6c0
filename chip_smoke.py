"""Drives the PyTorch port's paths on one CUDA card and checks them.

  python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before a result is printed):
  1. build the six CUDA kernels from src/repro_torch/kernels/csrc with
     nvcc, one process per source, all started together, and print each
     one's registers and spills;
  2. hold each kernel against its plain PyTorch version on the card at
     the engine bucket of the paper's serve_online cell (B=32, m1=1024,
     K=8, m2=64, d=20, n_db=1,048,576, k=10; the affine kernel with a
     K_pred=5 predictor padded to K=8), at m2=128 and at a ragged n_db:
     perm and compliant exact, utility/exposure within rtol=1e-5,
     atol=1e-5, lambda-hat within rtol=1e-5, atol=1e-6; knn_lambda's
     lambda-hat bitwise equal to knn_rank_audited's. The two quantized
     kernels likewise, over the int8 and the bf16 pack of the same db,
     with idx and guard exact and knn_lambda_quant's lambda-hat and
     guard bitwise knn_rank_audited_quant's; on a db the int8 pack holds
     exactly (the 0.5 grid, 63.5 in every slab) the quantized outputs
     equal knn_rank_audited's bitwise and an exact-match query returns
     its row's lambda; the share of rows whose guard fired is logged;
  O. the offline stage at the paper-ranking offline_dual width: a
     MovieLens-like problem (Table 1a constraints, 8192 train users,
     m1=1024, K=5, m2=50, d=20) through fit_pipeline (300 dual
     iterations) on the card, then the Fig. 2 strategies on 8192
     holdout users through the kernels (backend="kernel"), the knn_chain
     route, and the fitted KNN predictor quantized to int8 and to bf16
     (fused and chain), each batch's perm held against its plain version;
  3. serve 192 KNN, 64 int8 KNN, 32 bf16 KNN, 64 linear, 64 mean and 64
     lambda-given requests at serve_online widths (m1 jittered in
     512-1024) through ServingEngine(device="cuda"), check every result
     against the plain version on the same padded batch, and check that
     each wrapper's launch counter equals the batches of its route times
     the route's launches;
  4. time the six kernels (CUDA events, medians) at the bucket shape and
     at a large batch (the quantized ones in both modes), beside the
     plain version, a library yardstick that only this script calls,
     and the card's bound; then split each KNN lambda-hat kernel's
     device time at the bucket between its sweep and its merge
     (torch.profiler).
The launch counters are set to 0 just before the offline phase's
holdout path and the serving path and read just after each.
Prints the kernel table as one JSON line, the card's name and power
limit, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
DOT_OP_PER_S = {"int8": 1979e12, "bf16": 989e12}  # dense tensor-core peaks
D, K_PRED, KNN_K, EPS = 20, 5, 10, 1e-4
N_DB = 1_048_576
BUCKET = dict(B=32, m1=1024, K=8, m2=64)
LARGE_RANK_B = 8192           # the serve_online cell's full batch
LARGE_KNN_B = 1024            # cut from 8192: see PERF.md
OFFLINE = dict(n=8192, m1=1024, K=5, m2=50, iters=300, n_items=4096)
TOL = dict(rtol=1e-5, atol=1e-5)
LAM_TOL = dict(rtol=1e-5, atol=1e-6)
KERNELS = ("rank_audited", "knn_rank_audited", "linear_rank_audited",
           "knn_lambda", "knn_lambda_quant", "knn_rank_audited_quant")
MODES = ("int8", "bf16")
QUANT_EXTRA = 8
SERVE_MIX = {"knn": 192, "knn_int8": 64, "knn_bf16": 32, "linear": 64,
             "mean": 64, "_lam": 64}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg: str):
    print(msg, flush=True)


def rank_inputs(gen, dev, B, m1, K, m2):
    u = torch.rand((B, m1), generator=gen, device=dev) * 4.0 + 1.0
    a = (torch.rand((B, K, m1), generator=gen, device=dev) < 0.15).float()
    lam = torch.rand((B, K), generator=gen, device=dev)
    b = torch.rand((B, K), generator=gen, device=dev) * 2.0
    g = 1.0 / torch.log2(torch.arange(2, m2 + 2, device=dev,
                                      dtype=torch.float32))
    return u, a, b, lam, g.expand(B, m2).contiguous()


def affine_inputs(gen, dev, B, K, relu):
    """X (B, D) and a K_PRED-wide predictor padded to K rows: the linear
    family (relu) or the mean family (W = 0, a negative price in c)."""
    X = torch.randn((B, D), generator=gen, device=dev)
    W = torch.zeros((K, D), device=dev)
    c = torch.zeros((K,), device=dev)
    if relu:
        W[:K_PRED] = torch.randn((K_PRED, D), generator=gen, device=dev) * 0.3
        c[:K_PRED] = torch.randn((K_PRED,), generator=gen, device=dev) * 0.3
    else:
        c[:K_PRED] = torch.rand((K_PRED,), generator=gen, device=dev) - 0.3
        c[0] = -0.25
    return X, W, c


def knn_db(gen, dev, n_db):
    X_db = torch.randn((n_db, D), generator=gen, device=dev)
    lam_db = torch.randn((n_db, K_PRED), generator=gen, device=dev).abs()
    return X_db, lam_db * 0.5


def compare(name, got, want, lam_at=None):
    """perm/compliant exact, floats within tolerance; returns the max
    abs difference over the float outputs."""
    vals, idx, util, expo, comp = got[:5]
    w_vals, w_idx, w_util, w_expo, w_comp = want[:5]
    if not torch.equal(idx, w_idx):
        fail(f"{name}: perm differs from the plain version in "
             f"{int((idx != w_idx).sum())} slots")
    if not torch.equal(comp, w_comp):
        fail(f"{name}: compliant differs from the plain version")
    err = 0.0
    pairs = [(vals, w_vals, TOL), (util, w_util, TOL), (expo, w_expo, TOL)]
    if lam_at is not None:
        pairs.append((got[lam_at], want[lam_at], LAM_TOL))
    for g, w, tol in pairs:
        if not torch.allclose(g, w, **tol):
            fail(f"{name}: floats outside {tol}")
        err = max(err, float((g - w).abs().max()))
    return err


def time_ms(fn, reps, groups=5):
    """ms per call: CUDA events around `reps` back-to-back calls, so the
    card, not the host's enqueue of one call, sets the time; the median
    over `groups` such runs."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / reps)
    return float(np.median(times))


def device_split(fns, reps=5):
    """ms per call of each kernel that each function launches, by kernel
    name, from torch.profiler's device times; the reason instead where
    the profiler gives none."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for label, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            out[label] = {
                ev.key.split("(")[0].replace("void ", ""):
                    ev.device_time_total / 1e3 / reps
                for ev in prof.key_averages() if ev.device_time_total > 0}
        except (RuntimeError, AssertionError) as exc:
            out[label] = f"not measured: {str(exc)[:120]}"
    return out


def rank_work(B, m1, K, m2):
    """(bytes, fp32 flops) of rank+audit: inputs read once, outputs
    written once; the score axpy and the audit sums."""
    read = 4 * (B * m1 + B * K * m1 + 2 * B * K + B * m2)
    write = 4 * (2 * B * m2 + B + B * K + B)
    return read + write, 2 * B * K * m1 + 2 * B * (K + 1) * m2


def linear_work(B, m1, K, m2):
    """rank+audit, with X, W and c read in place of lambda, lambda-hat
    written, and the prologue's 2 B K d flops."""
    rb, rf = rank_work(B, m1, K, m2)
    return rb + 4 * (B * D + K * D + K), rf + 2 * B * K * D


def sweep_work(B, n_db):
    """(bytes, fp32 flops) of the KNN predictor: the db and queries read
    once, the k winners' lambda rows, lambda-hat written; distances
    B * n_db * (2d+3) plus |x|^2 per db row."""
    nbytes = 4 * (n_db * D + B * D + B * KNN_K * K_PRED + B * K_PRED)
    return nbytes, B * n_db * (2 * D + 3) + 2 * n_db * D


def knn_work(B, n_db, m1, K, m2):
    """The KNN stage: the sweep, then rank+audit (lambda-hat written at
    the bucket's K)."""
    rb, rf = rank_work(B, m1, K, m2)
    sb, sf = sweep_work(B, n_db)
    return rb + sb + 4 * B * (K - K_PRED), rf + sf


def bound(nbytes, flops, dot_ops=0, mode="int8"):
    """The least time in ms for the work and what bounds it: bytes at the
    memory rate against operations, fp32 flops at the fp32 rate plus
    `dot_ops` of a quantized dot at the tensor-core peak of `mode`."""
    t_b = nbytes / HBM_BYTES_PER_S
    t_f = flops / FP32_FLOP_PER_S + dot_ops / DOT_OP_PER_S[mode]
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def quant_sweep_work(B, n_db, mode):
    """(bytes, fp32 flops, dot ops) of the quantized KNN predictor: the
    pack (1 or 2 bytes a coordinate, 4 for each row's y2, 4 for each
    slab's scale) and the queries read once, the k winners' lambda rows
    read, lambda-hat and the guard written; the dot's 2d operations a
    (query, row) pair, and its fp32 epilogue, 5 operations a pair in
    int8 (scale product, scaling, subtract, add, clamp) and 4 in bf16."""
    n_pad = -(-n_db // 512) * 512
    width = 1 if mode == "int8" else 2
    nbytes = (n_pad * D * width + 4 * n_pad + 4 * (n_pad // 512)
              + 4 * (B * D + B * KNN_K * K_PRED + B * K_PRED + B))
    return (nbytes, B * n_pad * (5 if mode == "int8" else 4),
            2 * B * n_pad * D)


def quant_knn_work(B, n_db, m1, K, m2, mode):
    """The quantized KNN stage: the quantized sweep, then rank+audit."""
    rb, rf = rank_work(B, m1, K, m2)
    sb, sf, dot = quant_sweep_work(B, n_db, mode)
    return rb + sb + 4 * B * (K - K_PRED), rf + sf, dot


def reset_counters(wrappers):
    for w in wrappers.values():
        w.launches = 0


def read_counters(wrappers):
    return {name: w.launches for name, w in wrappers.items()}


def movielens_users(gen, dev, n, m1, K, m2, n_items):
    """MovieLens-like users as repro.data.synthetic builds them: items
    with latent factors V, 4 topics at a 5% rate and a release-year
    delta; users with latent factors X (the covariates, d=20) and a
    random slate of m1 distinct items; u = 3 + 1.8 X.V + noise (the
    ratings of make_interactions, unrounded). Table 1a: each topic's
    exposure >= 0.10 sum(gamma), the year row >= 0."""
    V = torch.randn((n_items, D), generator=gen, device=dev)
    topics = (torch.rand((4, n_items), generator=gen, device=dev)
              < 0.05).float()
    age = torch.floor(torch.empty(n_items, device=dev).exponential_(
        generator=gen) * 12.0)
    delta = (torch.clamp(2019.0 - age, 1950.0, 2019.0) - 1990.0) / 100.0
    X = torch.randn((n, D), generator=gen, device=dev) / math.sqrt(D)
    slate = torch.argsort(torch.rand((n, n_items), generator=gen,
                                     device=dev), dim=1)[:, :m1]
    u = torch.gather(3.0 + 1.8 * (X @ V.T), 1, slate)
    u = u + 0.35 * torch.randn((n, m1), generator=gen, device=dev)
    a = torch.cat([topics[:, slate].permute(1, 0, 2), delta[slate][:, None]],
                  dim=1).contiguous()
    gamma = 1.0 / torch.log2(torch.arange(2, m2 + 2, device=dev,
                                          dtype=torch.float32))
    b = torch.tensor([0.10 * float(gamma.sum())] * 4 + [0.0], device=dev)
    assert a.shape == (n, K, m1)
    return X, u.contiguous(), a, b, gamma


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core import ranking
    from repro_torch.core.predictors import KNNLambdaPredictor, pack_knn_db
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.common import quantize_query
    from repro_torch.kernels.fused_rank import (
        linear_rank_audited_cuda,
        rank_audited_cuda,
    )
    from repro_torch.kernels.knn_topk import (
        knn_lambda_cuda,
        knn_lambda_quant_cuda,
        knn_rank_audited_cuda,
        knn_rank_audited_quant_cuda,
    )
    from repro_torch.serving.engine import RankRequest, ServingEngine

    wrappers = {"rank_audited": rank_audited_cuda,
                "knn_rank_audited": knn_rank_audited_cuda,
                "linear_rank_audited": linear_rank_audited_cuda,
                "knn_lambda": knn_lambda_cuda,
                "knn_lambda_quant": knn_lambda_quant_cuda,
                "knn_rank_audited_quant": knn_rank_audited_quant_cuda}
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    t_start = time.perf_counter()

    # -- phase 1: build ----------------------------------------------------
    t0 = time.perf_counter()
    logs = build.build_all()
    log(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t0:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # -- phase 2: each kernel against its plain version --------------------
    B, m1, K, m2 = BUCKET["B"], BUCKET["m1"], BUCKET["K"], BUCKET["m2"]
    X_db, lam_db = knn_db(gen, dev, N_DB)
    err = {name: 0.0 for name in KERNELS}
    for mm2 in (m2, 128):
        u, a, b, lam, g = rank_inputs(gen, dev, B, m1, K, mm2)
        got = rank_audited_cuda(u, a, b, lam, g, m2=mm2, eps=EPS)
        torch.cuda.synchronize()
        e = compare(f"rank_audited m2={mm2}", got,
                    ref.rank_audited_ref(u, a, b, lam, g, mm2, EPS))
        if mm2 == m2:
            err["rank_audited"] = e
        for relu in (True, False):
            X, W, c = affine_inputs(gen, dev, B, K, relu)
            got = linear_rank_audited_cuda(u, a, b, X, W, c, g, m2=mm2,
                                           eps=EPS, relu=relu)
            torch.cuda.synchronize()
            e = compare(f"linear_rank_audited m2={mm2} relu={relu}", got,
                        ref.linear_rank_audited_ref(u, a, b, X, W, c, g, mm2,
                                                    EPS, relu=relu),
                        lam_at=5)
            if not relu and not (got[5][:, 0] < 0).all():
                fail("the mean route clamped a negative price")
            if mm2 == m2:
                err["linear_rank_audited"] = max(
                    err["linear_rank_audited"], e)
        xq = torch.randn((B, D), generator=gen, device=dev)
        xq[0] = X_db[N_DB - 1]                   # an exact match
        for n_db in (N_DB, N_DB - 4093):         # and a ragged db
            xdb, ldb = X_db[:n_db], lam_db[:n_db]
            got = knn_rank_audited_cuda(xq, xdb, ldb, u, a, b, g, k=KNN_K,
                                        m2=mm2, eps=EPS)
            torch.cuda.synchronize()
            want = ref.knn_rank_audited_ref(xq, xdb, ldb, u, a, b, g,
                                            k=KNN_K, m2=mm2, eps=EPS)
            e = compare(f"knn_rank_audited m2={mm2} n_db={n_db}", got, want,
                        lam_at=5)
            if mm2 == m2 and n_db == N_DB:
                err["knn_rank_audited"] = e
                if not torch.equal(got[5][0, :K_PRED], lam_db[N_DB - 1]):
                    fail("exact-match query did not return its row's lambda")
            if mm2 == m2:
                lam_hat = knn_lambda_cuda(xq, xdb, ldb, k=KNN_K)
                torch.cuda.synchronize()
                plain = want[5][:, :K_PRED]
                if not torch.allclose(lam_hat, plain, **LAM_TOL):
                    fail(f"knn_lambda n_db={n_db}: outside {LAM_TOL}")
                err["knn_lambda"] = max(
                    err["knn_lambda"], float((lam_hat - plain).abs().max()))
                if not torch.equal(lam_hat, got[5][:, :K_PRED]):
                    fail(f"knn_lambda n_db={n_db}: lambda-hat differs from "
                         f"knn_rank_audited's")
    # the quantized kernels over the int8 and bf16 packs of the same db
    packs = {(mode, n_db): pack_knn_db(X_db[:n_db], mode=mode, device=dev)
             for mode in MODES for n_db in (N_DB, N_DB - 4093)}
    guard_share = {}
    for mm2 in (m2, 128):
        u, a, b, lam, g = rank_inputs(gen, dev, B, m1, K, mm2)
        xq = torch.randn((B, D), generator=gen, device=dev)
        for (mode, n_db), pack in packs.items():
            ldb = lam_db[:n_db]
            name = f"knn_rank_audited_quant {mode} m2={mm2} n_db={n_db}"
            got = knn_rank_audited_quant_cuda(xq, *pack, ldb, u, a, b, g,
                                              k=KNN_K, mode=mode, m2=mm2,
                                              eps=EPS)
            torch.cuda.synchronize()
            want = ref.knn_rank_audited_quant_ref(
                xq, *pack, ldb, u, a, b, g, k=KNN_K, mode=mode, m2=mm2,
                eps=EPS)
            e = compare(name, got, want, lam_at=5)
            if not torch.equal(got[6], want[6]):
                fail(f"{name}: guard differs from the plain version")
            if mm2 != m2:
                continue
            err["knn_rank_audited_quant"] = max(
                err["knn_rank_audited_quant"], e)
            lam_hat, guard = knn_lambda_quant_cuda(xq, *pack, ldb, k=KNN_K,
                                                   mode=mode)
            torch.cuda.synchronize()
            plain = want[5][:, :K_PRED]
            if not torch.allclose(lam_hat, plain, **LAM_TOL) or \
                    not torch.equal(guard, want[6]):
                fail(f"knn_lambda_quant {mode} n_db={n_db}: differs from "
                     f"the plain version")
            err["knn_lambda_quant"] = max(
                err["knn_lambda_quant"],
                float((lam_hat - plain).abs().max()))
            if not (torch.equal(lam_hat, got[5][:, :K_PRED])
                    and torch.equal(guard, got[6])):
                fail(f"knn_lambda_quant {mode} n_db={n_db}: lambda-hat or "
                     f"guard differs from knn_rank_audited_quant's")
            if n_db == N_DB:
                guard_share[mode] = float(guard.float().mean())
    # a db the int8 pack holds exactly: the 0.5 grid, 63.5 in every slab
    X_ll = torch.round((torch.rand((N_DB, D), generator=gen, device=dev)
                        * 126.0 - 63.0) * 2.0) / 2.0
    X_ll[::512] = 63.5
    u, a, b, lam, g = rank_inputs(gen, dev, B, m1, K, m2)
    xq = torch.round(torch.randn((B, D), generator=gen, device=dev)
                     * 20.0) / 2.0
    xq[0] = X_ll[N_DB - 1]                       # an exact match
    want = knn_rank_audited_cuda(xq, X_ll, lam_db, u, a, b, g, k=KNN_K,
                                 m2=m2, eps=EPS)
    for mode in MODES:
        pack = pack_knn_db(X_ll, mode=mode, device=dev)
        if mode == "int8" and not bool((pack[1] == 0.5).all()):
            fail("the 0.5-grid db did not pack at scale 0.5")
        got = knn_rank_audited_quant_cuda(xq, *pack, lam_db, u, a, b, g,
                                          k=KNN_K, mode=mode, m2=m2, eps=EPS)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(got[:6], want)):
            fail(f"lossless {mode} pack: knn_rank_audited_quant differs from "
                 f"knn_rank_audited")
        if not torch.equal(got[5][0, :K_PRED], lam_db[N_DB - 1]):
            fail(f"lossless {mode} pack: exact-match query did not return "
                 f"its row's lambda")
    del X_ll
    log(f"phase 2: kernels equal their plain versions, max abs err {err}; "
        f"knn_lambda's lambda-hat is bitwise knn_rank_audited's, "
        f"knn_lambda_quant's lambda-hat and guard bitwise "
        f"knn_rank_audited_quant's; on the lossless pack both modes equal "
        f"knn_rank_audited bitwise; guard fired on {guard_share} of rows "
        f"at n_db={N_DB}")

    # -- offline phase: fit_pipeline, then the Fig. 2 strategies -----------
    o = OFFLINE
    X_all, u_all, a_all, b_off, gamma_off = movielens_users(
        gen, dev, 2 * o["n"], o["m1"], o["K"], o["m2"], o["n_items"])
    tr, ho = slice(0, o["n"]), slice(o["n"], 2 * o["n"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe = ranking.fit_pipeline(X_all[tr], u_all[tr], a_all[tr], b_off,
                                gamma_off, m2=o["m2"], num_iters=o["iters"],
                                device=dev)
    torch.cuda.synchronize()
    offline_s = time.perf_counter() - t0
    sol = pipe.train_solution
    if not (torch.isfinite(sol.lam).all() and (sol.lam >= 0).all()):
        fail("offline: shadow prices not finite and >= 0")
    train_comp = float(sol.compliant.float().mean())
    X_h, u_h, a_h = X_all[ho], u_all[ho], a_all[ho]
    b_rows = b_off.expand(o["n"], o["K"]).contiguous()
    g_rows = gamma_off.expand(o["n"], o["m2"]).contiguous()
    reset_counters(wrappers)
    fig2 = {}
    for strategy in ("none", "optimal", "mean", "linear", "knn"):
        fig2[strategy] = ranking.rank_with_strategy(
            pipe, strategy, X_h, u_h, a_h, b_off, dual_iters=o["iters"],
            backend="kernel", device=dev)
    chain = ops.predict_rank_audited(X_h, pipe.predictors["knn"], u_h, a_h,
                                     b_off, gamma_off, m2=o["m2"],
                                     eps=pipe.eps, knn_chain=True,
                                     device=dev)
    # the fitted KNN predictor over its int8 and bf16 pack, fused and chain
    qchains = {}
    for mode in MODES:
        name = f"knn_{mode}"
        pipe = ranking.with_predictor(
            pipe, name, pipe.predictors["knn"].quantized(mode, device=dev))
        fig2[name] = ranking.rank_with_strategy(
            pipe, name, X_h, u_h, a_h, b_off, backend="kernel", device=dev)
        qchains[name] = ops.predict_rank_audited(
            X_h, pipe.predictors[name], u_h, a_h, b_off, gamma_off,
            m2=o["m2"], eps=pipe.eps, knn_chain=True, device=dev)
    torch.cuda.synchronize()
    offline_launches = read_counters(wrappers)
    for strategy, out in fig2.items():
        if strategy in ("none", "optimal"):
            eps = 0.0 if strategy == "none" else pipe.eps
            want = ref.rank_audited_ref(u_h, a_h, b_rows, out.lam, g_rows,
                                        o["m2"], eps)
        else:
            want = ref.predict_rank_audited_ref(
                X_h, pipe.predictors[strategy], u_h, a_h, b_rows, g_rows,
                o["m2"], pipe.eps)
        got = (want[0], out.perm, out.utility, out.exposure, out.compliant,
               out.lam)
        compare(f"offline holdout {strategy}", got, want,
                lam_at=None if strategy in ("none", "optimal") else 5)
    for name, out in [("knn", chain)] + list(qchains.items()):
        if not (torch.equal(out.perm, fig2[name].perm)
                and torch.equal(out.lam, fig2[name].lam)):
            fail(f"offline: the {name} chain differs from its fused route")
    expect = {"rank_audited": 5, "linear_rank_audited": 2,
              "knn_rank_audited": 2, "knn_lambda": 2,
              "knn_rank_audited_quant": 4, "knn_lambda_quant": 4}
    if offline_launches != expect:
        fail(f"offline launch counters {offline_launches} != {expect}")
    opt_util = float(fig2["optimal"].utility.mean())
    fig2_row = {s: {"compliance": float(out.compliant.float().mean()),
                    "utility_vs_optimal": float(out.utility.mean())
                    / opt_util}
                for s, out in fig2.items()}
    log(f"offline: fit_pipeline on {o['n']} users x m1={o['m1']} x "
        f"K={o['K']} x m2={o['m2']}, {o['iters']} iterations, in "
        f"{offline_s:.3f} s; train compliance {train_comp}; eps "
        f"{pipe.eps}; holdout {json.dumps(fig2_row)}; launches "
        f"{offline_launches}")

    # -- phase 3: the engine serves four routes -----------------------------
    rng = np.random.default_rng(args.seed)
    knn = KNNLambdaPredictor(X_db=X_db, lam_db=lam_db, k=KNN_K)
    predictors = {"knn": knn, "linear": pipe.predictors["linear"],
                  "mean": pipe.predictors["mean"]}
    for mode in MODES:
        predictors[f"knn_{mode}"] = knn.quantized(mode, device=dev)
    gamma50 = (1.0 / np.log2(np.arange(2, 52))).astype(np.float32)
    kinds = rng.permutation([kind for kind, count in SERVE_MIX.items()
                             for _ in range(count)])
    reqs = []
    for rid, kind in enumerate(kinds):
        mm1 = int(rng.integers(512, 1025))
        kw = dict(rid=rid, m2=50, gamma=gamma50,
                  u=rng.uniform(1.0, 5.0, mm1).astype(np.float32),
                  a=(rng.random((K_PRED, mm1)) < 0.15).astype(np.float32),
                  b=np.full(K_PRED, 0.06 * gamma50.sum(), np.float32))
        if kind == "_lam":
            kw.update(lam=rng.exponential(0.5, K_PRED).astype(np.float32))
        else:
            kw.update(X=(rng.normal(size=D) / math.sqrt(D)).astype(
                np.float32), tag=str(kind))
        reqs.append(RankRequest(**kw))

    class CheckedEngine(ServingEngine):
        """Keeps each batch's padded inputs and outputs for the check."""

        def __init__(self, **kw):
            super().__init__(**kw)
            self.captured = []

        def _materialize_batch(self, pending):
            super()._materialize_batch(pending)
            staged = self._staging[pending.bucket]
            self.captured.append(
                (pending.bucket, {k: v.copy() for k, v in staged.items()},
                 [r.rid for r, _ in pending.entries], pending.out))

    eng = CheckedEngine(max_batch=32, max_wait_ms=2.0, eps=EPS, device="cuda")
    for tag, p in predictors.items():
        eng.register_predictor(tag, p, d_cov=D)
    warm = eng.warmup(reqs)
    torch.cuda.synchronize()
    eng.captured.clear()
    reset_counters(wrappers)
    t0 = time.perf_counter()
    results = eng.serve_stream(reqs)
    serve_s = time.perf_counter() - t0
    serve_launches = read_counters(wrappers)
    by_rid = {r.rid: r for r in results}
    if sorted(by_rid) != list(range(len(reqs))):
        fail(f"served {len(by_rid)} of {len(reqs)} requests")
    n_batches = {tag: 0 for tag in SERVE_MIX}
    for bucket, staged, rids, out in eng.captured:
        n_batches[bucket.tag] += 1
        t = {k: torch.tensor(v, device=dev) for k, v in staged.items()}
        if bucket.tag == "_lam":
            want = ref.rank_audited_ref(t["u"], t["a"], t["b"], t["lam"],
                                        t["gamma"], bucket.m2, EPS)
        else:
            want = ref.predict_rank_audited_ref(
                t["X"], predictors[bucket.tag], t["u"], t["a"], t["b"],
                t["gamma"], bucket.m2, EPS)
        got = [torch.tensor(np.asarray(x), device=dev) for x in
               (out.perm, out.perm, out.utility, out.exposure,
                out.compliant, out.lam)]
        got[0] = want[0]                         # vals are not served
        compare(f"served batch {bucket.name}", got, want,
                lam_at=None if bucket.tag == "_lam" else 5)
        for i, rid in enumerate(rids):
            res, req = by_rid[rid], reqs[rid]
            perm = res.perm
            if perm.shape != (req.m2,) or len(set(perm.tolist())) != req.m2 \
                    or perm.min() < 0 or perm.max() >= req.u.shape[0]:
                fail(f"request {rid}: malformed perm")
            if not np.array_equal(perm, want[1][i, :req.m2].cpu().numpy()):
                fail(f"request {rid}: served perm differs from the plain "
                     f"version")
            if not np.isfinite(res.utility) or \
                    not np.isfinite(res.exposure).all():
                fail(f"request {rid}: non-finite audit")
    per_batch = {tag: ops.kernel_launch_count(predictors.get(tag), 64)
                 for tag in n_batches}
    expect = {"rank_audited": n_batches["_lam"] * per_batch["_lam"],
              "knn_rank_audited": n_batches["knn"] * per_batch["knn"],
              "linear_rank_audited": n_batches["linear"] * per_batch["linear"]
              + n_batches["mean"] * per_batch["mean"],
              "knn_lambda": 0,
              "knn_rank_audited_quant":
                  n_batches["knn_int8"] * per_batch["knn_int8"]
                  + n_batches["knn_bf16"] * per_batch["knn_bf16"],
              "knn_lambda_quant": 0}
    if serve_launches != expect or eng.metrics.kernel_launches != sum(
            expect.values()) or per_batch["knn_int8"] != 2:
        fail(f"launch counters {serve_launches} != batches x route launches "
             f"{expect} (metrics {eng.metrics.kernel_launches})")
    for name in ("rank_audited", "knn_rank_audited", "linear_rank_audited",
                 "knn_rank_audited_quant"):
        if serve_launches[name] == 0:
            fail(f"{name} never launched on the serving path")
    summary = eng.metrics.summary()
    log(f"phase 3: served {len(results)} requests in {serve_s:.3f} s over "
        f"{summary['batches']} batches {n_batches}, buckets "
        f"{warm['buckets']}, launches {serve_launches}, compliance "
        f"{summary['compliance']}, latency_ms {summary['latency_ms']}")
    del eng, X_all, u_all, a_all, pipe, fig2, chain, qchains

    # -- phase 4: timing ---------------------------------------------------
    timing = {}
    c_eps = float(np.float32(1.0 + EPS))
    for label, Bt in (("bucket", B), ("large", LARGE_RANK_B)):
        u, a, b, lam, g = rank_inputs(gen, dev, Bt, m1, K, m2)
        reps = 20 if Bt == B else 5
        s = u + c_eps * torch.einsum("nk,nkm->nm", lam, a)
        bms, by = bound(*rank_work(Bt, m1, K, m2))
        timing[("rank_audited", label)] = dict(
            batch=Bt,
            ms=time_ms(lambda: rank_audited_cuda(u, a, b, lam, g, m2=m2,
                                                 eps=EPS), reps),
            plain_ms=time_ms(lambda: ref.rank_audited_ref(
                u, a, b, lam, g, m2, EPS), 2, groups=3),
            library_ms=time_ms(lambda: torch.topk(s, m2), reps),
            bound_ms=bms, bound_by=by)
        X, W, c = affine_inputs(gen, dev, Bt, K, True)
        bms, by = bound(*linear_work(Bt, m1, K, m2))
        timing[("linear_rank_audited", label)] = dict(
            batch=Bt,
            ms=time_ms(lambda: linear_rank_audited_cuda(
                u, a, b, X, W, c, g, m2=m2, eps=EPS), reps),
            plain_ms=time_ms(lambda: ref.linear_rank_audited_ref(
                u, a, b, X, W, c, g, m2, EPS), 2, groups=3),
            library_ms=time_ms(lambda: torch.topk(torch.baddbmm(
                u[:, None], torch.addmm(c, X, W.T)[:, None], a,
                alpha=c_eps)[:, 0], m2), reps),
            bound_ms=bms, bound_by=by)
    y2 = (X_db * X_db).sum(1)
    for label, Bt in (("bucket", B), ("large", LARGE_KNN_B)):
        u, a, b, lam, g = rank_inputs(gen, dev, Bt, m1, K, m2)
        xq = torch.randn((Bt, D), generator=gen, device=dev)
        reps = 10 if Bt == B else 2
        library_ms = time_ms(lambda: torch.topk(
            torch.addmm(y2, xq, X_db.T, alpha=-2.0), KNN_K, largest=False),
            reps)
        bms, by = bound(*knn_work(Bt, N_DB, m1, K, m2))
        timing[("knn_rank_audited", label)] = dict(
            batch=Bt,
            ms=time_ms(lambda: knn_rank_audited_cuda(
                xq, X_db, lam_db, u, a, b, g, k=KNN_K, m2=m2, eps=EPS), reps),
            plain_ms=time_ms(lambda: ref.knn_rank_audited_ref(
                xq, X_db, lam_db, u, a, b, g, k=KNN_K, m2=m2, eps=EPS),
                1, groups=3),
            library_ms=library_ms, bound_ms=bms, bound_by=by)
        bms, by = bound(*sweep_work(Bt, N_DB))
        timing[("knn_lambda", label)] = dict(
            batch=Bt,
            ms=time_ms(lambda: knn_lambda_cuda(xq, X_db, lam_db, k=KNN_K),
                       reps),
            plain_ms=time_ms(lambda: ref.knn_lambda_ref(xq, X_db, lam_db,
                                                        KNN_K), 1, groups=3),
            library_ms=library_ms, bound_ms=bms, bound_by=by)
    library = {}
    for mode in MODES:
        pack = packs[(mode, N_DB)]
        n_pad = pack[0].shape[0]
        if mode == "int8":
            # the int8 product wants whole 8-byte rows: pad d to 24
            db8 = torch.zeros((n_pad, 24), dtype=torch.int8, device=dev)
            db8[:, :D] = pack[0]
            library[mode] = ("torch._int_mm on the int8 query and db padded "
                             "to d=24, then torch.topk(k+8)")
        else:
            y2b = pack[2][:, 0].to(torch.bfloat16)
            library[mode] = ("torch.addmm on bf16 operands, then "
                             "torch.topk(k+8)")
        for label, Bt in (("bucket", B), ("large", LARGE_KNN_B)):
            u, a, b, lam, g = rank_inputs(gen, dev, Bt, m1, K, m2)
            xq = torch.randn((Bt, D), generator=gen, device=dev)
            reps = 10 if Bt == B else 2
            if mode == "int8":
                q8 = torch.zeros((Bt, 24), dtype=torch.int8, device=dev)
                q8[:, :D] = quantize_query(xq)[0].to(torch.int8)
                lib_fn = lambda: torch.topk(  # noqa: E731
                    torch._int_mm(q8, db8.t()), KNN_K + QUANT_EXTRA)
            else:
                xb = xq.to(torch.bfloat16)
                lib_fn = lambda: torch.topk(  # noqa: E731
                    torch.addmm(y2b, xb, pack[0].T, alpha=-2.0),
                    KNN_K + QUANT_EXTRA, largest=False)
            try:
                library_ms = time_ms(lib_fn, reps)
            except RuntimeError as exc:        # the reason it would not run
                library_ms = None
                library[mode] += f" (did not run: {str(exc)[:160]})"
            bms, by = bound(*quant_knn_work(Bt, N_DB, m1, K, m2, mode),
                            mode=mode)
            timing[("knn_rank_audited_quant", label, mode)] = dict(
                batch=Bt,
                ms=time_ms(lambda: knn_rank_audited_quant_cuda(
                    xq, *pack, lam_db, u, a, b, g, k=KNN_K, mode=mode, m2=m2,
                    eps=EPS), reps),
                plain_ms=time_ms(lambda: ref.knn_rank_audited_quant_ref(
                    xq, *pack, lam_db, u, a, b, g, k=KNN_K, mode=mode, m2=m2,
                    eps=EPS), 1, groups=3),
                library_ms=library_ms, bound_ms=bms, bound_by=by)
            bms, by = bound(*quant_sweep_work(Bt, N_DB, mode), mode=mode)
            timing[("knn_lambda_quant", label, mode)] = dict(
                batch=Bt,
                ms=time_ms(lambda: knn_lambda_quant_cuda(
                    xq, *pack, lam_db, k=KNN_K, mode=mode), reps),
                plain_ms=time_ms(lambda: ref.knn_lambda_quant_ref(
                    xq, *pack, lam_db, KNN_K, mode=mode), 1, groups=3),
                library_ms=library_ms, bound_ms=bms, bound_by=by)
        if mode == "int8":
            del db8
    for key, tm in timing.items():
        log(f"phase 4: {' '.join(key)} {json.dumps(tm)}")
    # where a KNN lambda-hat kernel's time goes: the sweep against the merge
    xq = torch.randn((B, D), generator=gen, device=dev)
    split = device_split({
        "f32": lambda: knn_lambda_cuda(xq, X_db, lam_db, k=KNN_K),
        **{mode: (lambda mode=mode: knn_lambda_quant_cuda(
            xq, *packs[(mode, N_DB)], lam_db, k=KNN_K, mode=mode))
           for mode in MODES}})
    log(f"phase 4: device ms per call by kernel at the bucket "
        f"{json.dumps(split)}")

    csrc = "src/repro_torch/kernels/csrc/"
    sources = {"rank_audited": (csrc + "rank_audited.cu",
                                "src/repro/kernels/fused_rank.py:261"),
               "knn_rank_audited": (csrc + "knn_rank_audited.cu",
                                    "src/repro/kernels/knn_topk.py:574"),
               "linear_rank_audited": (csrc + "linear_rank_audited.cu",
                                       "src/repro/kernels/fused_rank.py:384"),
               "knn_lambda": (csrc + "knn_lambda.cu",
                              "src/repro/kernels/knn_topk.py:253"),
               "knn_lambda_quant": (csrc + "knn_lambda_quant.cu",
                                    "src/repro/kernels/knn_topk.py:426"),
               "knn_rank_audited_quant": (
                   csrc + "knn_rank_audited_quant.cu",
                   "src/repro/kernels/knn_topk.py:731")}
    rows = []
    for name, (source, replaces) in sources.items():
        quant = name.endswith("_quant")
        # a quantized kernel's headline numbers are its int8 mode's
        main_t = timing[(name, "bucket") + (("int8",) if quant else ())]
        shape = {"batch": B, "m1": m1, "K": K, "m2": m2}
        if name == "linear_rank_audited":
            shape.update(d=D, K_pred=K_PRED)
        elif name == "knn_lambda":
            shape = {"batch": B, "n_db": N_DB, "d": D, "k": KNN_K,
                     "K_pred": K_PRED}
        elif name == "knn_lambda_quant":
            shape = {"batch": B, "n_db": N_DB, "d": D, "k": KNN_K,
                     "k_keep": KNN_K + QUANT_EXTRA, "K_pred": K_PRED,
                     "mode": "int8"}
        elif name == "knn_rank_audited":
            shape.update(n_db=N_DB, d=D, k=KNN_K)
        elif name == "knn_rank_audited_quant":
            shape.update(n_db=N_DB, d=D, k=KNN_K,
                         k_keep=KNN_K + QUANT_EXTRA, mode="int8")
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": offline_launches[name] + serve_launches[name],
            "launches_by_path": {"offline_holdout": offline_launches[name],
                                 "serving": serve_launches[name]},
            "max_abs_err": err[name], "ms": main_t["ms"],
            "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
            "bound_by": main_t["bound_by"],
            "library_ms": main_t["library_ms"], "shape": shape})
        if quant:
            rows[-1].update(
                modes={mode: {label: timing[(name, label, mode)]
                              for label in ("bucket", "large")}
                       for mode in MODES},
                library=library, guard_share_at_n_db=guard_share)
            if name == "knn_lambda_quant":
                rows[-1]["split_ms"] = {m: split[m] for m in MODES}
        else:
            rows[-1]["large"] = timing[(name, "large")]
            if name == "knn_lambda":
                rows[-1]["split_ms"] = split["f32"]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
