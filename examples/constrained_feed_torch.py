"""Constrained content feed on the PyTorch port (the twin of
examples/constrained_feed.py).

A YOW-news-style feed: every user gets a top-50 ranking of news items
under editorial exposure constraints with MIXED signs (boost health &
environment coverage, cap business/entertainment/politics/sport) — the
Table-1b shape. Shows per-topic exposure before/after, per strategy.

  PYTHONPATH=src python examples/constrained_feed_torch.py [--device cpu]
"""

import argparse

import torch

from repro_torch.core.ranking import fit_pipeline, rank_with_strategy
from repro_torch.data.synthetic import (
    YOW_CONSTRAINTS,
    YOW_TOPICS,
    build_experiment,
)


def topic_exposure(exp, out, topic_k):
    """Mean exposure share for constraint k across served users."""
    a_k = torch.abs(exp.a[exp.test_idx][:, topic_k, :])
    sel = torch.gather(a_k, 1, out.perm.long())
    total = float(torch.sum(exp.gamma))
    return float(torch.mean(sel @ exp.gamma)) / total


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = args.device
    gen = torch.Generator()
    gen.manual_seed(3)
    exp = build_experiment(
        gen, dataset="yow", n_users=60, n_items=800,
        m1=200, m2=50, recommender_epochs=2, device=dev)
    u_tr, X_tr, a_tr = exp.split("train")
    u_te, X_te, a_te = exp.split("test")
    pipe = fit_pipeline(X_tr, u_tr, a_tr, exp.b, exp.gamma, m2=exp.m2,
                        num_iters=400, device=dev)

    print("YOW-style feed: 8 topic constraints (>= boosts, <= caps)")
    print(f"{'topic':15s} {'dir':4s} {'no-opt':>8s} {'knn':>8s} "
          f"{'optimal':>8s}")
    outs = {s: rank_with_strategy(pipe, s, X_te, u_te, a_te, exp.b,
                                  dual_iters=400, backend="kernel",
                                  device=dev)
            for s in ("none", "knn", "optimal")}
    for k, name in enumerate(YOW_TOPICS):
        sign = ">=" if YOW_CONSTRAINTS[k][0] > 0 else "<="
        row = [topic_exposure(exp, outs[s], k) for s in ("none", "knn",
                                                         "optimal")]
        print(f"{name:15s} {sign:4s} {row[0]:8.3f} {row[1]:8.3f} "
              f"{row[2]:8.3f}")
    print()
    for s, out in outs.items():
        print(f"{s:8s}: compliance {float(out.compliant.float().mean()):.2f}"
              f"  utility {float(out.utility.mean()):.2f}")


if __name__ == "__main__":
    main()
