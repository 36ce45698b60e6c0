"""End-to-end serving driver on the PyTorch port (the twin of
examples/serve_recsys.py; the paper's deployment scenario).

Trains a small SASRec retrieval backbone, fits the constrained-ranking
head (Algorithm 1 offline stage) on top of its scores/covariates, then
serves a stream of individual, shape-heterogeneous requests through the
pipelined micro-batching engine (repro_torch.serving): backbone scores
-> shape bucket -> micro-batch -> KNN shadow prices -> constrained
top-k, one `knn_rank_audited` kernel call per batch on the card's own
stream, every bucket warmed before the stream so nothing is allocated
on the dispatch path, and batch N+1 assembled while batch N's outputs
come back.

  PYTHONPATH=src python examples/serve_recsys_torch.py [--requests 200] \
      [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core.constraints import dcg_discount
from repro_torch.core.dual_solver import solve_dual_batch
from repro_torch.core.predictors import KNNLambdaPredictor, MeanLambdaPredictor
from repro_torch.data.batches import make_seqrec_batch
from repro_torch.device import resolve_device
from repro_torch.models.recsys import RecsysConfig, SASRec
from repro_torch.serving import RankRequest, RankResult, ServingEngine


def _seeded(seed, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=200)
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--max-wait-ms", type=float, default=2.0)
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="0 = synchronous engine (pre-pipeline behavior)")
    ap.add_argument("--admission", action="store_true",
                    help="deadline-aware admission control with a "
                         "KNN -> mean degradation ladder")
    ap.add_argument("--budget-ms", type=float, default=50.0,
                    help="per-request latency budget (the paper's SLA)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # ---- 1. train the backbone --------------------------------------------
    cfg = RecsysConfig(kind="sasrec", n_items=2000, embed_dim=32,
                       n_blocks=2, n_heads=1, seq_len=20)
    model = SASRec(cfg, gen=_seeded(0, dev), device=dev)
    opt = model.init_opt()

    print("training sasrec backbone (100 steps)...")
    for step in range(100):
        batch = make_seqrec_batch(_seeded(step, dev), batch=64,
                                  seq_len=cfg.seq_len, n_items=cfg.n_items,
                                  n_neg=15, kind="sasrec", device=dev)
        opt, metrics = model.train_step(opt, batch, lr=3e-3)
    print(f"  final loss {float(metrics['loss']):.3f}")

    # ---- 2. constrained-ranking head: offline stage -----------------------
    m1, m2, K = 512, 50, 4
    gamma = dcg_discount(m2).numpy()
    cand_ids = torch.arange(m1, device=dev)
    # item topics (e.g. content categories needing exposure quotas)
    topics = (torch.rand((K, m1), generator=_seeded(7, dev), device=dev)
              < 0.15).to(torch.float32).cpu().numpy()
    b = (0.08 * gamma.sum() * np.ones(K, np.float32)).astype(np.float32)

    def score(seqs):
        return (model.retrieval_scores(seqs, cand_ids),
                model.user_covariates(seqs))

    n_offline = 256
    seqs = make_seqrec_batch(_seeded(1000, dev), batch=n_offline,
                             seq_len=cfg.seq_len, n_items=cfg.n_items,
                             n_neg=1, kind="sasrec", device=dev)["seq"]
    u_off, X_off = score(seqs)
    print(f"offline: solving {n_offline} duals (m1={m1}, K={K})...")
    sol = solve_dual_batch(u_off, torch.as_tensor(topics, device=dev),
                           torch.as_tensor(b, device=dev),
                           torch.as_tensor(gamma, device=dev), m2=m2,
                           num_iters=300)
    print(f"  offline compliance "
          f"{float(sol.compliant.float().mean()):.2f}")
    knn = KNNLambdaPredictor.fit(X_off, sol.lam, k=10, device=dev)

    # ---- 3. streaming online serving --------------------------------------
    engine = ServingEngine(max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms,
                           pipeline_depth=args.pipeline_depth,
                           admission=args.admission,
                           default_budget_s=args.budget_ms / 1e3,
                           device=dev)
    engine.register_predictor("sasrec", knn, d_cov=cfg.embed_dim)
    if args.admission:
        mean = MeanLambdaPredictor.fit(X_off, sol.lam, device=dev)
        engine.register_predictor("sasrec_mean", mean, d_cov=cfg.embed_dim)
        engine.set_degradation_ladder("sasrec", ["sasrec_mean"])

    # arrival stream: score in chunks, then one request per user with a
    # jittered candidate count (live retrieval returns varying sets).
    rng = np.random.default_rng(0)
    requests, chunk = [], 64
    for c in range(-(-args.requests // chunk)):
        seqs = make_seqrec_batch(_seeded(5000 + c, dev), batch=chunk,
                                 seq_len=cfg.seq_len, n_items=cfg.n_items,
                                 n_neg=1, kind="sasrec", device=dev)["seq"]
        u, X = score(seqs)
        u, X = u.cpu().numpy(), X.cpu().numpy()
        for i in range(min(chunk, args.requests - c * chunk)):
            n_c = int(rng.integers(m1 // 2, m1 + 1))
            m2_req = min(m2, n_c)
            requests.append(RankRequest(
                rid=c * chunk + i, u=u[i, :n_c], a=topics[:, :n_c], b=b,
                m2=m2_req, X=X[i], tag="sasrec", gamma=gamma[:m2_req]))

    warm = engine.warmup(requests)
    print(f"warmed {len(warm['buckets'])} buckets "
          f"({warm['compiles']} compiles): {warm['buckets']}")

    results = engine.serve_stream(requests)
    engine.close()

    served = [r for r in results if isinstance(r, RankResult)]
    s = engine.metrics.summary()
    lat = s["latency_ms"]
    print(f"served {len(served)}/{len(results)} requests through "
          f"{s['batches']} micro-batches ({s['buckets_used']} buckets, "
          f"fill rate {s['fill_rate']:.0%}):")
    print(f"  latency  p50 {lat['p50']:7.2f} ms   p95 {lat['p95']:7.2f} ms   "
          f"p99 {lat['p99']:7.2f} ms  (per request, enqueue -> result)")
    print(f"  compliance {s['compliance']:.2f}")
    p = s["pipeline"]
    print(f"  pipeline depth {args.pipeline_depth}: overlap "
          f"{p['overlap_ratio']:.0%}, max in-flight {p['queue_depth_max']}, "
          f"exec p50 {p['exec_ms_per_batch']['p50']:.2f} ms/batch")
    print(f"  recompiles after warmup: {s['compiles_post_warmup']}")
    d = s["deadline"]
    print(f"  deadline ({args.budget_ms:.0f} ms budget): hit rate "
          f"{d['hit_rate']:.1%}, sheds {d['sheds']}, "
          f"degrades {d['degrades']}")
    print(f"  within the {args.budget_ms:.0f} ms budget: "
          f"{lat['p99'] <= args.budget_ms}")
    return s


if __name__ == "__main__":
    main()
