"""Training driver of the port: ``python -m repro_torch.launch.train
--arch <id> [...]`` (counterpart of repro.launch.train).

Runs real steps through the fault-tolerant runner (checkpoint/restart,
deterministic batch replay, straggler accounting) for the three
trainable families: an LM (lm_train_step, Adam moments in the config's
moment_dtype), a recsys backbone (its train_step) and the GNN
(gnn_train_step on a make_random_graph of 64 nodes / 160 edges with
--smoke, else 2048 / 8192; d_node 16, d_edge 8, d_out 3). The state is
(params, AdamState) and every step is functional: it reads only the
state it is given, so a restored checkpoint is all a replayed step
depends on. Step s's batch comes from a generator seeded s. The flags
and the JSON report's keys are the JAX launcher's; --device (the card
by default, "cpu" for the plain path) has none there. Weights are
drawn from a generator seeded 0.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \
      --steps 50 --smoke --ckpt-dir build/ckpt [--device cpu]
  PYTHONPATH=src python -m repro_torch.launch.train --arch meshgraphnet \
      --steps 20 --smoke --fail-at 7 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from dataclasses import replace

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.checkpoint.store import flatten_with_paths, unflatten_like
from repro_torch.configs import get_arch
from repro_torch.data.batches import (
    make_deepfm_batch,
    make_lm_batch,
    make_random_graph,
    make_seqrec_batch,
)
from repro_torch.device import resolve_device
from repro_torch.distributed.runner import FaultTolerantRunner

GNN_SIZES = {True: (64, 160), False: (2048, 8192)}   # smoke: (N, E)


def _seeded(seed: int, dev: torch.device) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def build_training(arch_name: str, *, smoke: bool, batch: int | None,
                   seq: int | None, device=None):
    """-> (state, step_fn, batch_fn, describe) on `device` (None = the
    card)."""
    dev = resolve_device(device)
    spec = get_arch(arch_name)
    cfg = spec.make_config(not smoke)
    gen = _seeded(0, dev)

    if spec.family == "lm":
        from repro_torch.models.transformer import (
            lm_adam_init,
            lm_init,
            lm_train_step,
        )
        B = batch or (2 if smoke else 8)
        S = seq or (64 if smoke else 512)
        params = lm_init(gen, cfg, device=dev)
        state = (params, lm_adam_init(params, cfg))

        def step(params, opt, batch):
            return lm_train_step(params, opt, batch, cfg)

        def batch_fn(s):
            return make_lm_batch(_seeded(s, dev), batch=B, seq=S,
                                 vocab=cfg.vocab, device=dev)

    elif spec.family == "recsys":
        from repro_torch.models.recsys import RECSYS_REGISTRY
        model = RECSYS_REGISTRY[cfg.kind](cfg, gen=gen, device=dev)
        B = batch or (16 if smoke else 4096)
        params = unflatten_like(model.params(), {
            k: p.detach() for k, p in flatten_with_paths(
                model.params()).items()})
        state = (params, model.init_opt())

        def step(params, opt, batch):
            return model.functional_step(params, opt, batch)

        def batch_fn(s):
            g = _seeded(s, dev)
            if cfg.kind == "deepfm":
                return make_deepfm_batch(g, batch=B, n_sparse=cfg.n_sparse,
                                         field_vocab=cfg.field_vocab,
                                         device=dev)
            return make_seqrec_batch(g, batch=B, seq_len=cfg.seq_len,
                                     n_items=cfg.n_items, n_neg=15,
                                     kind=cfg.kind, device=dev)

    elif spec.family == "gnn":
        from repro_torch.models.gnn import (
            gnn_adam_init,
            gnn_init,
            gnn_train_step,
        )
        N, E = GNN_SIZES[smoke]
        cfg = replace(cfg, d_node_in=16, d_edge_in=8, d_out=3)
        params = gnn_init(gen, cfg, device=dev)
        state = (params, gnn_adam_init(params))

        def step(params, opt, graph):
            return gnn_train_step(params, opt, graph, cfg)

        def batch_fn(s):
            return make_random_graph(_seeded(s, dev), n_nodes=N, n_edges=E,
                                     d_node=16, d_edge=8, d_out=3,
                                     device=dev)

    else:
        raise ValueError(f"{arch_name}: train driver supports lm/recsys/gnn")

    def step_fn(state, batch):
        params, opt = state
        params, opt, metrics = step(params, opt, batch)
        return (params, opt), metrics

    return state, step_fn, batch_fn, {"arch": arch_name,
                                      "family": spec.family}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject one failure at this step (chaos drill)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs "
                         "the plain PyTorch path)")
    return ap


def run(args):
    """The driver's body: -> (final state, RunnerReport, JSON report)."""
    state, step_fn, batch_fn, desc = build_training(
        args.arch, smoke=args.smoke, batch=args.batch, seq=args.seq,
        device=args.device)
    store = CheckpointStore(os.path.join(args.ckpt_dir, args.arch),
                            keep_last=2)
    runner = FaultTolerantRunner(
        store, step_fn, batch_fn, ckpt_every=args.ckpt_every)

    injected = {args.fail_at} if args.fail_at is not None else set()
    t0 = time.perf_counter()
    state, report = runner.run(
        state, args.steps,
        fail_at=(lambda s: s in injected and not injected.discard(s)),
        device=args.device)
    dt = time.perf_counter() - t0
    losses = [m.get("loss") for m in report.metrics_history if "loss" in m]
    return state, report, {
        **desc, "steps": report.steps_run, "restarts": report.restarts,
        "checkpoints": report.checkpoints,
        "stragglers": report.straggler_steps,
        "wall_s": round(dt, 2),
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
    }


def main(argv=None) -> dict:
    _, _, out = run(build_parser().parse_args(argv))
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
