"""End-to-end behaviour of the port's system (Algorithm 1) on its own
data: build_experiment (the Appendix-B recommender trained with the
port's Adam, top-m1 slates, Table 1 constraints), fit_pipeline with the
MLP, and the online stage for every strategy through the dispatcher
(backend="kernel", the plain versions on the CPU). The paper's
qualitative claims are asserted as tests/test_system.py asserts them
for the JAX package, at its sizes (80 users, 500 items, m1 200, m2 50,
2 recommender epochs; the YOW case 30 users, 400 items, m1 150, 1
epoch). The port draws its own data (torch generators), so the claims,
not the numbers, are what the two packages share.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.core.ranking import (
    EPS_GRID,
    fit_pipeline,
    rank_with_strategy,
)
from repro_torch.data.synthetic import build_experiment

CPU = "cpu"
STRATEGIES = ("none", "mean", "knn", "linear", "mlp", "optimal")


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.fixture(scope="module")
def experiment():
    exp = build_experiment(_gen(11), dataset="movielens", n_users=80,
                           n_items=500, m1=200, m2=50, recommender_epochs=2,
                           device=CPU)
    u_tr, X_tr, a_tr = exp.split("train")
    pipe = fit_pipeline(X_tr, u_tr, a_tr, exp.b, exp.gamma, m2=exp.m2,
                        num_iters=400, with_mlp=True, device=CPU)
    return exp, pipe


def _rank(exp, pipe, strategy):
    u_te, X_te, a_te = exp.split("test")
    return rank_with_strategy(pipe, strategy, X_te, u_te, a_te, exp.b,
                              dual_iters=400, backend="kernel", device=CPU)


@pytest.fixture(scope="module")
def results(experiment):
    exp, pipe = experiment
    return {s: _rank(exp, pipe, s) for s in STRATEGIES}


def test_compliance_ordering(results):
    c = {s: float(r.compliant.float().mean()) for s, r in results.items()}
    assert c["optimal"] >= 0.9, c
    assert c["knn"] >= c["none"] + 0.3, c
    assert c["mean"] >= c["none"], c
    assert c["optimal"] >= c["knn"] - 0.05, c


def test_utility_cost_of_constraints_is_small(results):
    """Paper: 'the price of imposing diversity constraints is often
    low'."""
    u_none = float(results["none"].utility.mean())
    for s in ("mean", "knn", "linear", "mlp", "optimal"):
        assert float(results[s].utility.mean()) >= 0.90 * u_none, s


def test_rankings_are_valid_permutations(experiment, results):
    exp, _ = experiment
    for s, r in results.items():
        perm = r.perm.numpy()
        assert perm.shape == (exp.test_idx.numel(), exp.m2)
        assert all(len(set(row.tolist())) == exp.m2 for row in perm), s
        assert perm.min() >= 0 and perm.max() < exp.u.shape[1]


def test_prediction_is_much_faster_than_optimization(experiment):
    """The paper's speed claim at the level of the architecture: serving
    by prediction skips the per-user dual solve."""
    exp, pipe = experiment

    def timed(strategy, n=3):
        _rank(exp, pipe, strategy)
        t0 = time.perf_counter()
        for _ in range(n):
            _rank(exp, pipe, strategy)
        return (time.perf_counter() - t0) / n

    t_knn, t_opt = timed("knn"), timed("optimal")
    assert t_knn < t_opt / 3, (t_knn, t_opt)


def test_eps_tuning_selected_from_paper_grid(experiment):
    _, pipe = experiment
    assert pipe.eps in EPS_GRID


def test_yow_style_mixed_sign_constraints():
    """The YOW table has <= constraints; the sign flip must keep the
    solver sound."""
    exp = build_experiment(_gen(13), dataset="yow", n_users=30, n_items=400,
                           m1=150, m2=50, recommender_epochs=1, device=CPU)
    u_tr, X_tr, a_tr = exp.split("train")
    pipe = fit_pipeline(X_tr, u_tr, a_tr, exp.b, exp.gamma, m2=exp.m2,
                        num_iters=400, device=CPU)
    assert bool((exp.b[2:7] < 0).all())            # the five <= rows
    u_te, X_te, a_te = exp.split("test")
    res_opt = rank_with_strategy(pipe, "optimal", X_te, u_te, a_te, exp.b,
                                 dual_iters=400, backend="kernel",
                                 device=CPU)
    res_none = rank_with_strategy(pipe, "none", X_te, u_te, a_te, exp.b,
                                  backend="kernel", device=CPU)
    c_opt = float(res_opt.compliant.float().mean())
    assert c_opt >= float(res_none.compliant.float().mean())
    assert c_opt > 0.5
    assert np.isfinite(res_opt.utility.numpy()).all()
