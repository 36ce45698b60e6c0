"""Quickstart on the PyTorch port: constrained ranking with prediction
(the twin of examples/quickstart.py).

Builds a tiny MovieLens-style problem, runs Algorithm 1 end to end, and
prints the paper's Figure-2 comparison (strategy -> compliance/utility).
The online stage runs through the port's kernels (their plain PyTorch
versions with --device cpu).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import torch

from repro_torch.core.ranking import fit_pipeline, rank_with_strategy
from repro_torch.data.synthetic import build_experiment


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    dev = args.device
    gen = torch.Generator()
    gen.manual_seed(0)

    print("=== 1. data: synthetic MovieLens-style ranking problems ===")
    exp = build_experiment(
        gen, dataset="movielens",
        n_users=80,        # users (75% train / 25% holdout)
        n_items=600,       # catalogue
        m1=200,            # candidate slate per user
        m2=50,             # ranking slots (paper scenario a)
        recommender_epochs=2, device=dev,
    )
    u_tr, X_tr, a_tr = exp.split("train")
    u_te, X_te, a_te = exp.split("test")
    print(f"    {u_tr.shape[0]} train / {u_te.shape[0]} holdout users, "
          f"m1={exp.u.shape[1]}, K={exp.b.shape[0]} constraints, m2={exp.m2}")

    print("=== 2. offline: batched dual solve + predictor fit ===")
    pipe = fit_pipeline(X_tr, u_tr, a_tr, exp.b, exp.gamma, m2=exp.m2,
                        num_iters=400, device=dev)
    print(f"    fitted predictors: {sorted(pipe.predictors)}  "
          f"(eps tie-break = {pipe.eps})")
    sol = pipe.train_solution
    print(f"    train compliance {float(sol.compliant.float().mean()):.2f}, "
          f"mean duality gap {float(sol.gap.mean()):.4f}")

    print("=== 3. online: rank holdout users under each strategy ===")
    print(f"    {'strategy':10s} {'compliance':>10s} {'utility':>9s}")
    for strat in ("none", "mean", "knn", "optimal"):
        out = rank_with_strategy(pipe, strat, X_te, u_te, a_te, exp.b,
                                 dual_iters=400, backend="kernel",
                                 device=dev)
        print(f"    {strat:10s} {float(out.compliant.float().mean()):10.2f} "
              f"{float(out.utility.mean()):9.2f}")

    out = rank_with_strategy(pipe, "knn", X_te, u_te, a_te, exp.b,
                             backend="kernel", device=dev)
    print("=== 4. a served ranking (user 0, top 10 item ids) ===")
    print("   ", out.perm[0, :10].tolist())


if __name__ == "__main__":
    main()
