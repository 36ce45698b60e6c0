"""Times the rank, KNN and embedding_bag kernels of one checkout of the
port on one CUDA card.

  python3 bench_rank.py [--tree DIR] [--seed N] [--out FILE]

Imports repro_torch from DIR/src (default: this checkout), builds its
CUDA kernels there, and runs chip_smoke.rank_timings over
chip_smoke.RANK_CASES: fused_rank at the bucket and at 64 x m1 =
100,000; rank_audited at the bucket, at B = 8192 and at the paper's
serve_retrieval cell (256 x m1 = 1,048,576); linear_rank_audited at the
bucket and at B = 8192; knn_rank_audited at serve_retrieval; then
chip_smoke.knn_timings over a 1,048,576-row db and its int8 and bf16
packs: knn_topk, knn_lambda and knn_rank_audited, knn_lambda_quant and
knn_rank_audited_quant in both modes, each at the bucket (B = 32) and
at B = 1024, with the profiler's split of the f32 kernels and of
knn_lambda_quant between their sweep and their second launch; then
chip_smoke.bag_timings over chip_smoke.BAG_SHAPES: embedding_bag with an
f32 and a bf16 table at kernel_bench's shape (1,000,000 x 64, 4096 bags
of 32), MIND's at serve_bulk (262,144 bags of 50) and DeepFM's at
serve_bulk (10,223,616 one-slot bags over 39,000,000 x 10), with its
cold (fresh index sets), device and host times, its bound and its
sector count (slot_ms), on indices every tree's kernel takes (none
past the table). Each case reports the kernel's ms, a library
yardstick's, the card's bound and whether the outputs equal the plain
version's bit for bit (the rank cases also the plain version's ms).
Prints the card's name and power limit, then one JSON line, also
written to FILE.

To compare two checkouts, run both in one call on one card, in turns:
the parent, this tree, this tree, the parent (each in its own process,
since both packages are named repro_torch).
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import torch

HERE = Path(__file__).resolve().parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=HERE)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", flush=True)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    sys.path.insert(0, str(args.tree.resolve() / "src"))
    from repro_torch.kernels import build, ref
    from repro_torch.kernels.fused_rank import (
        fused_rank_cuda,
        linear_rank_audited_cuda,
        rank_audited_cuda,
    )
    from repro_torch.core.predictors import pack_knn_db
    # the module, not the entry point of the same name the package exports
    bag_mod = importlib.import_module("repro_torch.kernels.embedding_bag")
    from repro_torch.kernels.knn_topk import (
        knn_lambda_cuda,
        knn_lambda_quant_cuda,
        knn_rank_audited_cuda,
        knn_rank_audited_quant_cuda,
        knn_topk_cuda,
    )

    build.build_all()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    timing = cs.rank_timings(SimpleNamespace(
        fused_rank_cuda=fused_rank_cuda, rank_audited_cuda=rank_audited_cuda,
        linear_rank_audited_cuda=linear_rank_audited_cuda,
        knn_rank_audited_cuda=knn_rank_audited_cuda, ref=ref), gen, dev)
    X_db, lam_db = cs.knn_db(gen, dev, cs.N_DB)
    knn, _ = cs.knn_timings(SimpleNamespace(
        knn_topk_cuda=knn_topk_cuda, knn_lambda_cuda=knn_lambda_cuda,
        knn_rank_audited_cuda=knn_rank_audited_cuda,
        knn_lambda_quant_cuda=knn_lambda_quant_cuda,
        knn_rank_audited_quant_cuda=knn_rank_audited_quant_cuda, ref=ref),
        gen, dev, X_db, lam_db,
        {m: pack_knn_db(X_db, mode=m, device=dev) for m in cs.MODES},
        plain=False)
    timing.update(knn)
    timing.update(cs.bag_timings(SimpleNamespace(
        embedding_bag_cuda=bag_mod.embedding_bag_cuda,
        bag_geometry=getattr(bag_mod, "bag_geometry", None), ref=ref),
        gen, dev, plain=False))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    line = json.dumps({"tree": str(args.tree), "card": smi,
                       "cases": {" ".join(key): row
                                 for key, row in timing.items()}})
    print(smi)
    print(line, flush=True)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    return 0 if all(row["bitwise"] for row in timing.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
