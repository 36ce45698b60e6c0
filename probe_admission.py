"""Repeats chip_smoke.py phase S's admission pass on one CUDA card and
says where the serving process stalls.

  python3 probe_admission.py [--passes 24] [--heap 441444] [--off]
                             [--sample] [--seed 0]

Phase S's stream, engine and controller (chip_smoke.load_stream,
load_engine, watched_admission) at 0.25 x the closed-loop capacity C
measured first. The heap is first grown to `--heap` tracked objects,
the size chip_smoke.py's heap has when phase S starts (its
gc_tracked_objects_at_start), so a full collection costs what it costs
there. Passes alternate between the collector as it is and a frozen
heap (chip_smoke.heap_frozen, as phase S runs its pass; with --off the
collector is also turned off there). Each pass
prints one JSON line: its sheds and degrades, the controller's summary,
the collections and the largest, and the modules first imported during
the pass. With --sample a thread also samples the main thread's
innermost frames every millisecond, and each queueing-lag sample over
15 ms gets the window it covers: the collections in it, the sampler's
largest gap there (a gap means the sampler could not run either) and
where the main thread was. Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import sys
import threading
import time
from pathlib import Path

import torch

STALL_MS = 15.0


class Sampler(threading.Thread):
    """Every `period_s`, the innermost frames of thread `ident`."""

    def __init__(self, ident, period_s=1e-3):
        super().__init__(daemon=True)
        self.target, self.period_s = ident, period_s
        self.samples, self.stop = [], threading.Event()

    def run(self):
        while not self.stop.wait(self.period_s):
            f = sys._current_frames().get(self.target)
            where = []
            while f is not None and len(where) < 6:
                where.append(f"{Path(f.f_code.co_filename).name}:"
                             f"{f.f_code.co_name}:{f.f_lineno}")
                f = f.f_back
            self.samples.append((time.perf_counter(), " < ".join(where)))


def stalls(lags, samples, pauses):
    """Each lag sample over STALL_MS with what its window holds."""
    out = []
    for t, lag in lags:
        if lag <= STALL_MS:
            continue
        lo = t - lag / 1e3
        times = [u for u, _ in samples if lo <= u <= t]
        gaps = [b - a for a, b in zip([lo] + times, times + [t])]
        out.append({
            "lag_ms": lag,
            "gc_ms": [((b - a) * 1e3, g) for a, b, g in pauses
                      if b >= lo and a <= t],
            "sampler_gap_ms": max(gaps) * 1e3,
            "main_thread": collections.Counter(
                w for u, w in samples if lo <= u <= t).most_common(4)})
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--passes", type=int, default=24)
    ap.add_argument("--heap", type=int, default=441_444)
    ap.add_argument("--off", action="store_true")
    ap.add_argument("--sample", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is false: this probe needs a card",
              file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parent
    sys.path.insert(0, str(root))
    sys.path.insert(0, str(root / "src"))
    import chip_smoke as cs
    from repro_torch.core.predictors import (
        KNNLambdaPredictor,
        MeanLambdaPredictor,
    )
    from repro_torch.kernels import build
    from repro_torch.serving import poisson_arrivals, serve_open_loop

    dev = torch.device("cuda")
    build.build_all()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    X_db, lam_db = cs.knn_db(gen, dev, cs.N_DB)
    knn = KNNLambdaPredictor(X_db=X_db, lam_db=lam_db, k=cs.KNN_K)
    mean = MeanLambdaPredictor.fit(X_db[:8192], lam_db[:8192], device=dev)
    stream = cs.load_stream(args.seed)

    eng = cs.load_engine(stream, dev, knn, mean)
    t0 = time.perf_counter()
    eng.serve_stream(stream, warmup=False)
    capacity = len(stream) / (time.perf_counter() - t0)
    eng.metrics.summary()
    eng.close()
    qps = cs.SERVE_LOAD["fracs"][0] * capacity
    arrivals = poisson_arrivals(len(stream), qps, seed=args.seed + 1)
    ballast = [[] for _ in range(max(0, args.heap - len(gc.get_objects())))]
    print(json.dumps({"capacity_qps": capacity, "offered_qps": qps,
                      "gc_tracked_objects": len(gc.get_objects()),
                      "ballast": len(ballast)}))
    pauses, started = [], []

    def on_gc(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        else:
            pauses.append((started.pop(), time.perf_counter(),
                           info["generation"]))

    for i in range(args.passes):
        arm = ("heap_frozen", "collector_on")[i % 2]
        ctrl = cs.watched_admission()
        eng = cs.load_engine(stream, dev, knn, mean, admission=ctrl)
        modules = set(sys.modules)
        sampler = Sampler(threading.get_ident())
        if args.sample:
            sampler.start()
        frozen = cs.heap_frozen() if arm == "heap_frozen" else None
        if frozen is not None:
            frozen.__enter__()
            if args.off:
                gc.disable()
        pauses.clear()
        gc.callbacks.append(on_gc)
        try:
            serve_open_loop(eng, stream, arrivals)
        finally:
            gc.callbacks.remove(on_gc)
            if frozen is not None:
                gc.enable()
                frozen.__exit__(None, None, None)
            if args.sample:
                sampler.stop.set()
                sampler.join()
        eng.close()
        d = eng.metrics.summary()["deadline"]
        print(json.dumps({
            "pass": i, "arm": arm, "sheds": d["sheds"],
            "degrades": d["degrades"], **ctrl.summary(),
            "collections": len(pauses),
            "gc_max_ms": max(((b - a) * 1e3 for a, b, _ in pauses),
                             default=0.0),
            "new_modules": sorted(set(sys.modules) - modules),
            "stalls": stalls(ctrl.lags, sampler.samples, pauses)[:3]}),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
