"""Train a small LM end to end through the fault-tolerant runner on the
PyTorch port (the twin of examples/train_lm.py).

Demonstrates the training substrate: data pipeline, Adam, global-norm
clipping, checkpoint/restart (with an injected mid-run failure to prove
recovery) and deterministic batch replay: step s's batch comes from a
generator seeded s, and the step is functional, so the restored
checkpoint is all the replayed steps read.

  PYTHONPATH=src python examples/train_lm_torch.py [--steps 120] \
      [--d-model 128] [--device cpu]
"""

import argparse
import shutil
import tempfile

import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.data.batches import make_lm_batch
from repro_torch.device import resolve_device
from repro_torch.distributed.runner import FaultTolerantRunner
from repro_torch.models.transformer import (
    LMConfig,
    lm_adam_init,
    lm_init,
    lm_train_step,
)


def _seeded(seed, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = LMConfig(
        n_layers=args.layers, d_model=args.d_model, n_heads=4, n_kv_heads=2,
        d_head=args.d_model // 4, d_ff=args.d_model * 4, vocab=256,
        dtype=torch.float32, param_dtype=torch.float32, remat="none",
        dense_attn_threshold=4096)
    print(f"model: {cfg.n_params/1e6:.2f} M params")
    params = lm_init(_seeded(0, dev), cfg, device=dev)
    state = (params, lm_adam_init(params, cfg))

    def step_fn(state, batch):
        params, opt = state
        params, opt, metrics = lm_train_step(params, opt, batch, cfg,
                                             lr=3e-3)
        return (params, opt), metrics

    def batch_fn(step):
        return make_lm_batch(_seeded(step, dev), batch=args.batch,
                             seq=args.seq, vocab=cfg.vocab, device=dev)

    ckpt_dir = tempfile.mkdtemp(prefix="repro_lm_")
    store = CheckpointStore(ckpt_dir, keep_last=2)
    runner = FaultTolerantRunner(store, step_fn, batch_fn, ckpt_every=25)

    # chaos drill: one injected failure mid-run; the runner must restore
    # the latest checkpoint and replay deterministically
    fail_step = args.steps // 2
    fails = {fail_step}
    print(f"training {args.steps} steps "
          f"(failure injected at step {fail_step})...")
    try:
        state, report = runner.run(
            state, args.steps,
            fail_at=lambda s: s in fails and not fails.discard(s),
            device=dev)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    losses = [m["loss"] for m in report.metrics_history]
    k = max(len(losses) // 6, 1)
    for i in range(0, len(losses), k):
        print(f"  step {i:4d}  loss {losses[i]:.4f}")
    print(f"  step {len(losses)-1:4d}  loss {losses[-1]:.4f}")
    print(f"restarts: {report.restarts}  checkpoints: {report.checkpoints}  "
          f"stragglers: {report.straggler_steps}")
    assert losses[-1] < losses[0], "loss must decrease"
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}  OK")
    return report


if __name__ == "__main__":
    main()
