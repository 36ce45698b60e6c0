"""Drives the PyTorch port's main path on one CUDA card and checks it.

  python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero before a result is printed):
  1. build both CUDA kernels from src/repro_torch/kernels/csrc with nvcc;
  2. hold each kernel against its plain PyTorch version on the card at
     the engine bucket of the paper's serve_online cell (B=32, m1=1024,
     K=8, m2=64, d=20, n_db=1,048,576, k=10), at m2=128 and at a ragged
     n_db: perm and compliant exact, utility/exposure within rtol=1e-5,
     atol=1e-5, lambda-hat within rtol=1e-5, atol=1e-6;
  3. serve 256 KNN and 64 lambda-given requests at serve_online widths
     (m1 jittered in 512-1024) through ServingEngine(device="cuda"),
     check every result against the plain version on the same padded
     batch, and check that each wrapper's launch counter equals the
     batches of its route times the route's launches;
  4. time both kernels (CUDA events, medians) at the bucket shape and at
     a large batch, beside the plain version, a library yardstick that
     only this script calls, and the card's bound.
Prints the kernel table as one JSON line, the card's name and power
limit, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_FLOP_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
D, K_PRED, KNN_K, EPS = 20, 5, 10, 1e-4
N_DB = 1_048_576
BUCKET = dict(B=32, m1=1024, K=8, m2=64)
LARGE_RANK_B = 8192           # the serve_online cell's full batch
LARGE_KNN_B = 1024            # cut from 8192: see PERF.md
TOL = dict(rtol=1e-5, atol=1e-5)
LAM_TOL = dict(rtol=1e-5, atol=1e-6)


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


def rank_work(B, m1, K, m2):
    """(bytes, fp32 flops) of rank+audit: inputs read once, outputs
    written once; the score axpy and the audit sums."""
    read = 4 * (B * m1 + B * K * m1 + 2 * B * K + B * m2)
    write = 4 * (2 * B * m2 + B + B * K + B)
    return read + write, 2 * B * K * m1 + 2 * B * (K + 1) * m2


def knn_work(B, n_db, m1, K, m2):
    """(bytes, fp32 flops) of the KNN stage: the db read once, the k
    winners' lambda rows, the rank inputs; distances B * n_db * (2d+3)
    plus |x|^2 per db row, then rank+audit."""
    rb, rf = rank_work(B, m1, K, m2)
    db = 4 * (n_db * D + B * D + B * KNN_K * K_PRED + B * K)
    flops = B * n_db * (2 * D + 3) + 2 * n_db * D
    return rb + db, rf + flops


def bound(nbytes, flops):
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels.fused_rank import rank_audited_cuda
    from repro_torch.kernels.knn_topk import knn_rank_audited_cuda
    from repro_torch.core.predictors import KNNLambdaPredictor
    from repro_torch.serving.engine import RankRequest, ServingEngine

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
    err = {"rank_audited": 0.0, "knn_rank_audited": 0.0}
    for mm2 in (m2, 128):
        u, a, b, lam, g = rank_inputs(gen, dev, B, m1, K, mm2)
        got = rank_audited_cuda(u, a, b, lam, g, m2=mm2, eps=EPS)
        torch.cuda.synchronize()
        e = compare(f"rank_audited m2={mm2}", got,
                    ref.rank_audited_ref(u, a, b, lam, g, mm2, EPS))
        if mm2 == m2:
            err["rank_audited"] = e
        xq = torch.randn((B, D), generator=gen, device=dev)
        xq[0] = X_db[N_DB - 1]                   # an exact match
        for n_db in (N_DB, N_DB - 4093):         # and a ragged db
            xdb, ldb = X_db[:n_db], lam_db[:n_db]
            got = knn_rank_audited_cuda(xq, xdb, ldb, u, a, b, g, k=KNN_K,
                                        m2=mm2, eps=EPS)
            torch.cuda.synchronize()
            e = compare(f"knn_rank_audited m2={mm2} n_db={n_db}", got,
                        ref.knn_rank_audited_ref(xq, xdb, ldb, u, a, b, g,
                                                 k=KNN_K, m2=mm2, eps=EPS),
                        lam_at=5)
            if mm2 == m2 and n_db == N_DB:
                err["knn_rank_audited"] = e
                if not torch.equal(got[5][0, :K_PRED], lam_db[N_DB - 1]):
                    fail("exact-match query did not return its row's lambda")
    log(f"phase 2: kernels equal their plain versions, max abs err {err}")

    # -- phase 3: the engine serves the main path ---------------------------
    rng = np.random.default_rng(args.seed)
    knn = KNNLambdaPredictor(X_db=X_db, lam_db=lam_db, k=KNN_K)
    gamma50 = (1.0 / np.log2(np.arange(2, 52))).astype(np.float32)
    kinds = rng.permutation([1] * 256 + [0] * 64)
    reqs = []
    for rid, kind in enumerate(kinds):
        mm1 = int(rng.integers(512, 1025))
        kw = dict(rid=rid, m2=50, gamma=gamma50,
                  u=rng.uniform(1.0, 5.0, mm1).astype(np.float32),
                  a=(rng.random((K_PRED, mm1)) < 0.15).astype(np.float32),
                  b=np.full(K_PRED, 0.06 * gamma50.sum(), np.float32))
        if kind:
            kw.update(X=rng.normal(size=D).astype(np.float32), tag="knn")
        else:
            kw.update(lam=rng.exponential(0.5, K_PRED).astype(np.float32))
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
    eng.register_predictor("knn", knn, d_cov=D)
    warm = eng.warmup(reqs)
    torch.cuda.synchronize()
    eng.captured.clear()
    rank_audited_cuda.launches = 0
    knn_rank_audited_cuda.launches = 0
    t0 = time.perf_counter()
    results = eng.serve_stream(reqs)
    serve_s = time.perf_counter() - t0
    launches = {"rank_audited": rank_audited_cuda.launches,
                "knn_rank_audited": knn_rank_audited_cuda.launches}
    by_rid = {r.rid: r for r in results}
    if sorted(by_rid) != list(range(len(reqs))):
        fail(f"served {len(by_rid)} of {len(reqs)} requests")
    n_batches = {"_lam": 0, "knn": 0}
    for bucket, staged, rids, out in eng.captured:
        n_batches[bucket.tag] += 1
        t = {k: torch.tensor(v, device=dev) for k, v in staged.items()}
        if bucket.tag == "_lam":
            want = ref.rank_audited_ref(t["u"], t["a"], t["b"], t["lam"],
                                        t["gamma"], bucket.m2, EPS)
        else:
            want = ref.knn_rank_audited_ref(
                t["X"], X_db, lam_db, t["u"], t["a"], t["b"], t["gamma"],
                k=KNN_K, m2=bucket.m2, eps=EPS)
        got = [torch.tensor(np.asarray(x), device=dev) for x in
               (out.perm, out.perm, out.utility, out.exposure,
                out.compliant, out.lam)]
        got[0] = want[0]                         # vals are not served
        compare(f"served batch {bucket.name}", got, want,
                lam_at=5 if bucket.tag == "knn" else None)
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
    expect = {"rank_audited": n_batches["_lam"] * ops.kernel_launch_count(
                  None, 64),
              "knn_rank_audited": n_batches["knn"] * ops.kernel_launch_count(
                  knn, 64)}
    if launches != expect or eng.metrics.kernel_launches != sum(
            expect.values()):
        fail(f"launch counters {launches} != batches x route launches "
             f"{expect} (metrics {eng.metrics.kernel_launches})")
    for name, n in launches.items():
        if n == 0:
            fail(f"{name} never launched on the main path")
    summary = eng.metrics.summary()
    log(f"phase 3: served {len(results)} requests in {serve_s:.3f} s over "
        f"{summary['batches']} batches {n_batches}, buckets "
        f"{warm['buckets']}, launches {launches}, compliance "
        f"{summary['compliance']}, latency_ms {summary['latency_ms']}")

    # -- phase 4: timing ---------------------------------------------------
    rows = []
    timing = {}
    for label, Bt in (("bucket", B), ("large", LARGE_RANK_B)):
        u, a, b, lam, g = rank_inputs(gen, dev, Bt, m1, K, m2)
        reps = 20 if Bt == B else 5
        c = float(np.float32(1.0 + EPS))
        s = u + c * torch.einsum("nk,nkm->nm", lam, a)
        nbytes, flops = rank_work(Bt, m1, K, m2)
        bms, by = bound(nbytes, flops)
        timing[("rank_audited", label)] = dict(
            batch=Bt,
            ms=time_ms(lambda: rank_audited_cuda(u, a, b, lam, g, m2=m2,
                                                 eps=EPS), reps),
            plain_ms=time_ms(lambda: ref.rank_audited_ref(
                u, a, b, lam, g, m2, EPS), 2, groups=3),
            library_ms=time_ms(lambda: torch.topk(s, m2), reps),
            bound_ms=bms, bound_by=by)
    y2 = (X_db * X_db).sum(1)
    for label, Bt in (("bucket", B), ("large", LARGE_KNN_B)):
        u, a, b, lam, g = rank_inputs(gen, dev, Bt, m1, K, m2)
        xq = torch.randn((Bt, D), generator=gen, device=dev)
        reps = 10 if Bt == B else 2
        nbytes, flops = knn_work(Bt, N_DB, m1, K, m2)
        bms, by = bound(nbytes, flops)
        timing[("knn_rank_audited", label)] = dict(
            batch=Bt,
            ms=time_ms(lambda: knn_rank_audited_cuda(
                xq, X_db, lam_db, u, a, b, g, k=KNN_K, m2=m2, eps=EPS), reps),
            plain_ms=time_ms(lambda: ref.knn_rank_audited_ref(
                xq, X_db, lam_db, u, a, b, g, k=KNN_K, m2=m2, eps=EPS),
                1, groups=3),
            library_ms=time_ms(lambda: torch.topk(
                torch.addmm(y2, xq, X_db.T, alpha=-2.0), KNN_K,
                largest=False), reps),
            bound_ms=bms, bound_by=by)
    for key, tm in timing.items():
        log(f"phase 4: {key[0]} {key[1]} {json.dumps(tm)}")

    sources = {"rank_audited": ("src/repro_torch/kernels/csrc/rank_audited.cu",
                                "src/repro/kernels/fused_rank.py:261"),
               "knn_rank_audited": (
                   "src/repro_torch/kernels/csrc/knn_rank_audited.cu",
                   "src/repro/kernels/knn_topk.py:574")}
    for name, (source, replaces) in sources.items():
        main_t = timing[(name, "bucket")]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err[name], "ms": main_t["ms"],
            "plain_ms": main_t["plain_ms"], "bound_ms": main_t["bound_ms"],
            "bound_by": main_t["bound_by"],
            "library_ms": main_t["library_ms"],
            "shape": {"batch": B, "m1": m1, "K": K, "m2": m2,
                      **({"n_db": N_DB, "d": D, "k": KNN_K}
                         if name == "knn_rank_audited" else {})},
            "large": timing[(name, "large")]})
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
