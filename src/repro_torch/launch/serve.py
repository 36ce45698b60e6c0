"""Serving driver of the port: ``python -m repro_torch.launch.serve
--arch <recsys-id>`` (counterpart of repro.launch.serve).

The deployment shape of the paper's system: train a retrieval backbone,
run Algorithm 1's offline stage (a batched dual solve on a user sample,
then the KNN predictor's fit) on its scores and covariates, then serve
a STREAM of heterogeneous requests through the shape-bucketed,
pipelined micro-batching engine (repro_torch.serving) and report
per-request latency percentiles, compliance, pipeline overlap and the
engine's post-warmup ring allocations (`compiles_post_warmup`, which
steady state keeps at 0). --pipeline-depth 0 serves synchronously.

Backbone scoring runs a fixed-shape batch per arrival chunk of 64; each
user then becomes an individual RankRequest whose candidate count is
jittered (live retrieval returns varying candidate sets), exercising
the engine's bucket lattice the way live traffic would. With
--replicas N the stream goes through a FleetRouter over N engines.

The flags and the JSON report's keys are the JAX launcher's.
--executor picks the engine's executor: "fused" (the default here, the
engine's: the CUDA kernels on the card, their plain PyTorch versions
with --device cpu) or "xla" (JAX's default: the predictor's predict,
then the einsum, sort and audit as torch ops, no kernel launch); the
report's "executor" carries the flag's value, as JAX's does. --device
(the card by default; "cpu" for the plain path) has no JAX counterpart;
without a card the default raises and nothing falls back to the CPU.
Weights are drawn from fixed seeds; main() serves the arch's SMOKE
config, `run` takes any config (chip_smoke.py passes the published
one).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch sasrec \
      --requests 256 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.core.constraints import dcg_discount
from repro_torch.core.dual_solver import DualSolution, solve_dual_batch
from repro_torch.core.predictors import KNNLambdaPredictor, MeanLambdaPredictor
from repro_torch.data.batches import make_deepfm_batch, make_seqrec_batch
from repro_torch.device import resolve_device
from repro_torch.models.recsys import RECSYS_REGISTRY
from repro_torch.serving import FleetRouter, RankRequest, RankResult, ServingEngine

ARRIVAL_CHUNK = 64       # users scored per backbone call on the stream
SCORE_CHUNK = 1024       # users scored per call in the offline sample
TRAIN_BATCH, TRAIN_LR = 64, 3e-3


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="sasrec",
                    choices=["deepfm", "sasrec", "bert4rec", "mind"])
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--candidates", type=int, default=512)
    ap.add_argument("--m2", type=int, default=50)
    ap.add_argument("--constraints", type=int, default=5)
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--offline-users", type=int, default=256)
    ap.add_argument("--max-batch", type=int, default=32,
                    help="engine micro-batch capacity")
    ap.add_argument("--max-wait-ms", type=float, default=2.0,
                    help="micro-batch assembly deadline")
    ap.add_argument("--executor", default="fused", choices=["xla", "fused"],
                    help="fused: the CUDA kernels; xla: JAX's two-stage "
                         "body as torch ops, no kernel launch")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="in-flight micro-batch window; 1 = double "
                         "buffering, 0 = synchronous engine")
    ap.add_argument("--m1-jitter", type=float, default=0.5,
                    help="per-request candidate-count jitter in "
                         "[1-jitter, 1] * --candidates")
    ap.add_argument("--admission", action="store_true",
                    help="enable deadline-aware admission control with a "
                         "KNN -> mean degradation ladder")
    ap.add_argument("--budget-ms", type=float, default=50.0,
                    help="per-request latency budget (the paper's SLA)")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through a fault-tolerant FleetRouter "
                         "over N engine replicas (health-checked "
                         "consistent-hash routing, hedged retries, "
                         "supervised restart); 1 = single engine")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs "
                         "the plain PyTorch path)")
    return ap


def _seeded(seed: int, dev: torch.device) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def request_batch(cfg, B: int, seed: int, dev: torch.device) -> torch.Tensor:
    """The backbone's input for B users drawn from `seed`: DeepFM's
    (B, n_sparse) field ids, a sequence model's (B, seq_len) items."""
    gen = _seeded(seed, dev)
    if cfg.kind == "deepfm":
        return make_deepfm_batch(gen, batch=B, n_sparse=cfg.n_sparse,
                                 field_vocab=cfg.field_vocab,
                                 device=dev)["ids"]
    return make_seqrec_batch(gen, batch=B, seq_len=cfg.seq_len,
                             n_items=cfg.n_items, n_neg=1, kind=cfg.kind,
                             device=dev)["seq"]


def train_batch(cfg, step: int, dev: torch.device) -> dict:
    """Training step `step`'s batch of TRAIN_BATCH, drawn from `step`."""
    gen = _seeded(step, dev)
    if cfg.kind == "deepfm":
        return make_deepfm_batch(gen, batch=TRAIN_BATCH,
                                 n_sparse=cfg.n_sparse,
                                 field_vocab=cfg.field_vocab, device=dev)
    return make_seqrec_batch(gen, batch=TRAIN_BATCH, seq_len=cfg.seq_len,
                             n_items=cfg.n_items, n_neg=15, kind=cfg.kind,
                             device=dev)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@dataclass
class Deployment:
    """A trained backbone and its offline stage: the candidate set, the
    constraints (K topic rows over the candidates, thresholds b), the
    slot discounts, the duals of the offline users and the predictors
    fitted on them. `timings` holds the stages' wall seconds; `served`
    the last `serve` call's results and the engines that served them."""

    cfg: object
    device: torch.device
    model: object
    cand_ids: torch.Tensor
    topics: np.ndarray          # (K, n_cand) f32 0/1
    b: np.ndarray               # (K,)
    gamma: np.ndarray           # (m2,)
    m2: int
    # the offline stage's, filled by deploy once the sample is scored
    sol: DualSolution | None = None
    X_off: torch.Tensor | None = None    # (offline users, d_cov)
    knn: KNNLambdaPredictor | None = None
    mean: MeanLambdaPredictor | None = None
    timings: dict = field(default_factory=dict)
    served: dict = field(default_factory=dict)

    @property
    def n_cand(self) -> int:
        return int(self.cand_ids.shape[0])

    @property
    def d_cov(self) -> int:
        return int(self.X_off.shape[1])

    def score(self, req):
        """Backbone inference for a batch of users: (utilities over the
        whole candidate set (B, n_cand), covariates (B, d_cov))."""
        user_in = req[:, 1:] if self.cfg.kind == "deepfm" else req
        u = self.model.retrieval_scores(user_in, self.cand_ids)
        return u, self.model.user_covariates(req)


def deploy(cfg, args, device=None) -> Deployment:
    """Train the backbone (--train-steps at batch 64, lr 3e-3, weights
    from seed 0), then the offline stage over --offline-users users."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    model = RECSYS_REGISTRY[cfg.kind](cfg, gen=_seeded(0, dev), device=dev)
    opt = model.init_opt()
    for step in range(args.train_steps):
        opt, _ = model.train_step(opt, train_batch(cfg, step, dev),
                                  lr=TRAIN_LR)
    _sync(dev)
    train_s = time.perf_counter() - t0

    n_cand = min(args.candidates, cfg.n_items)
    m2, K = min(args.m2, n_cand), args.constraints
    gamma = dcg_discount(m2).numpy()
    cand_ids = torch.arange(n_cand, device=dev)
    topics = (torch.rand((K, n_cand), generator=_seeded(7, dev), device=dev)
              < 0.15).to(torch.float32).cpu().numpy()
    b = (0.08 * gamma.sum() * np.ones(K, np.float32)).astype(np.float32)
    dep = Deployment(cfg=cfg, device=dev, model=model, cand_ids=cand_ids,
                     topics=topics, b=b, gamma=gamma, m2=m2)
    t0 = time.perf_counter()
    off_req = request_batch(cfg, args.offline_users, 10_000, dev)
    parts = [dep.score(off_req[i:i + SCORE_CHUNK])
             for i in range(0, off_req.shape[0], SCORE_CHUNK)]
    u_off = torch.cat([p[0] for p in parts])
    dep.X_off = torch.cat([p[1] for p in parts])
    _sync(dev)
    score_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dep.sol = solve_dual_batch(u_off, torch.as_tensor(topics, device=dev),
                               torch.as_tensor(b, device=dev),
                               torch.as_tensor(gamma, device=dev), m2=m2,
                               num_iters=300)
    dep.knn = KNNLambdaPredictor.fit(dep.X_off, dep.sol.lam, k=10,
                                     device=dev)
    dep.mean = MeanLambdaPredictor.fit(dep.X_off, dep.sol.lam, device=dev)
    _sync(dev)
    dep.timings.update(train_s=train_s, offline_score_s=score_s,
                       offline_solve_s=time.perf_counter() - t0)
    return dep


def request_stream(dep: Deployment, args) -> list:
    """The arrival stream: backbone scoring per chunk of 64 users, then
    one RankRequest per user over a jittered prefix of the candidates
    (m1 in [max(m2, (1 - jitter) * n_cand), n_cand])."""
    rng = np.random.default_rng(0)
    requests = []
    m2 = dep.m2
    m1_lo = max(m2, int(dep.n_cand * (1.0 - args.m1_jitter)))
    chunk = ARRIVAL_CHUNK
    for c in range(-(-args.requests // chunk)):
        req_in = request_batch(dep.cfg, chunk, 20_000 + c, dep.device)
        u, X = dep.score(req_in)
        u, X = u.cpu().numpy(), X.cpu().numpy()
        for i in range(min(chunk, args.requests - c * chunk)):
            m1 = int(rng.integers(m1_lo, dep.n_cand + 1))
            m2_req = min(m2, m1)
            requests.append(RankRequest(
                rid=c * chunk + i, u=u[i, :m1], a=dep.topics[:, :m1],
                b=dep.b, m2=m2_req, X=X[i], tag=args.arch,
                gamma=dep.gamma[:m2_req]))
    return requests


def make_engine_factory(dep: Deployment, args, engine_cls=ServingEngine):
    """An engine per call: the arch's KNN predictor under its tag and,
    with --admission, the mean predictor as its one degradation rung
    (pre-warmed like every other bucket, so degrading never allocates
    on the dispatch path)."""

    def make_engine(_name=None):
        eng = engine_cls(max_batch=args.max_batch,
                         max_wait_ms=args.max_wait_ms,
                         executor=args.executor,
                         pipeline_depth=args.pipeline_depth,
                         admission=args.admission,
                         default_budget_s=args.budget_ms / 1e3,
                         device=dep.device)
        eng.register_predictor(args.arch, dep.knn, d_cov=dep.d_cov)
        if args.admission:
            eng.register_predictor(f"{args.arch}_mean", dep.mean,
                                   d_cov=dep.d_cov)
            eng.set_degradation_ladder(args.arch, [f"{args.arch}_mean"])
        return eng

    return make_engine


def serve(dep: Deployment, requests, args, engine_cls=ServingEngine) -> dict:
    """Serve `requests` through one engine, or a FleetRouter over
    --replicas engines; returns the JAX launcher's report."""
    make_engine = make_engine_factory(dep, args, engine_cls)
    report = {
        "arch": args.arch,
        "n_candidates": dep.n_cand, "m2": dep.m2, "K": args.constraints,
        "executor": args.executor,
        "max_batch": args.max_batch, "max_wait_ms": args.max_wait_ms,
        "pipeline_depth": args.pipeline_depth,
        "admission": args.admission, "budget_ms": args.budget_ms,
        "replicas": args.replicas,
        "offline_compliance": round(
            float(dep.sol.compliant.to(torch.float32).mean()), 3),
    }
    if args.replicas > 1:
        # fleet path: health-checked consistent-hash routing over N
        # replica engines, each warming only its bucket subset (+ backup)
        router = FleetRouter(make_engine, args.replicas)
        warm = router.warmup(requests)
        results = router.serve_stream(requests, warmup=False)
        router.close()
        served = [r for r in results if isinstance(r, RankResult)]
        s = router.fleet_summary()
        lat = s.get("latency_ms", {"p99": float("nan")})
        report.update({
            "requests": len(results),
            "served": len(served), "shed": len(results) - len(served),
            "buckets": {n: w["buckets"] for n, w in warm.items()},
            "compiles_post_warmup": sum(
                r["compiles_post_warmup"] for r in s["replicas"].values()),
            "latency_ms": lat,
            "fleet": {k: s[k] for k in (
                "failovers", "hedges", "duplicates_deduped", "retries",
                "crashes", "restarts", "lost", "orphaned_futures")},
            "replica_states": {n: r["state"]
                               for n, r in s["replicas"].items()},
            "within_budget": bool(lat["p99"] <= args.budget_ms),
        })
        engines = [rep.engine for rep in router.replicas]
    else:
        engine = make_engine()
        warm = engine.warmup(requests)
        results = engine.serve_stream(requests)
        engine.close()
        served = [r for r in results if isinstance(r, RankResult)]
        s = engine.metrics.summary()
        report.update({
            "requests": len(results),
            "served": len(served), "shed": len(results) - len(served),
            "buckets": warm["buckets"],
            "compiles": s["compiles"],
            "compiles_post_warmup": s["compiles_post_warmup"],
            "fill_rate": s["fill_rate"],
            "latency_ms": s["latency_ms"],
            "queue_wait_ms": s["queue_wait_ms"],
            "pipeline": s["pipeline"],
            "online_compliance": s["compliance"],
            "deadline": s["deadline"],
            "within_budget": bool(s["latency_ms"]["p99"] <= args.budget_ms),
        })
        engines = [engine]
    dep.served = {"results": results, "engines": engines}
    return report


def run(cfg, args, device=None, engine_cls=ServingEngine) -> dict:
    """The whole driver for one config: deploy, stream, serve."""
    dep = deploy(cfg, args, device)
    return serve(dep, request_stream(dep, args), args, engine_cls)


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    cfg = get_arch(args.arch).make_config(full=False)
    report = run(cfg, args, device=args.device)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
