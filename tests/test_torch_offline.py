"""The port's offline stage held against the JAX package: the batched
dual solver (core.dual_solver), eps tuning, fit_pipeline and the
paper's Fig. 2 strategies (core.ranking), on the same numpy problems.

Tolerances:
  * the dual solver's lam, dual_value, primal_value, exposure and gap:
    rtol=1e-4, atol=1e-5; compliant exact. XLA's CPU code contracts
    a*b + c into fused multiply-adds and takes 1/sqrt from an
    approximate reciprocal square root, so the AdaGrad iterates drift by
    ulps; they part only where an ulp decides an exact tie. The known
    tie: the first AdaGrad step moves a price by exactly lr in the
    solver's [0, 1] utility units, so the lowest-utility item, if it
    carries an attribute, ties the highest. Most problems here give the
    two extreme items of each user no attributes, so no ulp decides;
    `test_solve_dual_batch_with_attributed_extremes` keeps them and
    counts the users that part.
  * strategies: perm and compliant exact; utility and exposure
    rtol=1e-5, atol=1e-5; lambda-hat rtol=1e-4, atol=1e-5 (predictors
    fitted on the two solvers' shadow prices).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constraints as jax_cons
from repro.core import dual_solver as jax_dual
from repro.core import ranking as jax_ranking
from repro_torch.core import constraints as cons
from repro_torch.core import dual_solver as dual
from repro_torch.core import ranking

DUAL_RTOL, DUAL_ATOL = 1e-4, 1e-5
RTOL, ATOL = 1e-5, 1e-5
CPU = "cpu"


def _users(seed, n, m1, K, m2, d=6, bare_extremes=True):
    """MovieLens-like users: utilities from latent factors X (n, d),
    binary topic rows with a >= quota, for K >= 3 one <= cap on row 1,
    for K >= 5 a continuous release-year row >= 0. Rows go through each
    package's make_constraints (the <= row flipped to >=).
    `bare_extremes` strips the attributes of each user's highest- and
    lowest-utility items, so the known tie cannot arise."""
    rng = np.random.default_rng(seed)
    X = (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    V = rng.normal(size=(m1, d)).astype(np.float32)
    u = (3.0 + 1.8 * X @ V.T + 0.35 * rng.normal(size=(n, m1))
         ).astype(np.float32)
    gamma = np.asarray(jax_cons.dcg_discount(m2))
    total = float(gamma.sum())
    rows = (rng.random((n, K, m1)) < 0.1).astype(np.float32)
    b_rows = np.full(K, 0.1 * total)
    signs = np.ones(K)
    if K >= 3:
        b_rows[1], signs[1] = 0.05 * total, -1.0
    if K >= 5:
        rows[:, K - 1] = rng.normal(0.1, 0.2, (n, m1))
        b_rows[K - 1] = 0.0
    if bare_extremes:
        r = np.arange(n)
        rows[r, :, u.argmin(1)] = 0.0
        rows[r, :, u.argmax(1)] = 0.0
    jsets = [jax_cons.make_constraints(list(rows[i]), list(b_rows),
                                       list(signs)) for i in range(n)]
    tsets = [cons.make_constraints(list(rows[i]), list(b_rows), list(signs),
                                   device=CPU) for i in range(n)]
    for js, ts in zip(jsets, tsets):
        np.testing.assert_array_equal(ts.a.numpy(), np.asarray(js.a))
        np.testing.assert_array_equal(ts.b.numpy(), np.asarray(js.b))
    a = np.stack([np.asarray(s.a) for s in jsets])
    b = np.stack([np.asarray(s.b) for s in jsets])
    return X, u, a, b, gamma


def _assert_solution(got, want):
    for f in ("lam", "dual_value", "primal_value", "exposure", "gap"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)),
                                   rtol=DUAL_RTOL, atol=DUAL_ATOL, err_msg=f)
    np.testing.assert_array_equal(got.compliant.numpy(),
                                  np.asarray(want.compliant))


@pytest.mark.parametrize("n,m1,K,m2,iters", [
    (8, 64, 1, 8, 20), (8, 64, 3, 8, 100), (8, 128, 5, 16, 100),
    (6, 128, 3, 16, 20), (8, 128, 5, 8, 20), (4, 64, 5, 16, 100)])
def test_solve_dual_batch_matches_jax(n, m1, K, m2, iters):
    _, u, a, b, gamma = _users(n * 1000 + m1 + K * 10 + m2, n, m1, K, m2)
    want = jax_dual.solve_dual_batch(
        *(jnp.asarray(x) for x in (u, a, b, gamma)), m2=m2, num_iters=iters)
    got = dual.solve_dual_batch(*(torch.tensor(x) for x in (u, a, b, gamma)),
                                m2=m2, num_iters=iters)
    _assert_solution(got, want)
    assert got.iters == iters
    assert (got.lam >= 0).all() and got.compliant.any()


@pytest.mark.parametrize("seed,m1,K,m2,iters,max_parted", [
    (3, 64, 1, 8, 20, 2), (4, 128, 3, 16, 20, 1), (1, 128, 5, 16, 100, 0)])
def test_solve_dual_batch_with_attributed_extremes(seed, m1, K, m2, iters,
                                                   max_parted):
    """64 users whose extreme items keep their attributes, as the
    MovieLens-like problems of chip_smoke.py do. Only users whose
    lowest-utility item carries a_k = 1 can meet the first-step tie; at
    most `max_parted` of them (the count these seeds part) may leave the
    JAX trajectory, and every other user agrees at the stated tolerance."""
    n = 64
    _, u, a, b, gamma = _users(seed, n, m1, K, m2, bare_extremes=False)
    want = jax_dual.solve_dual_batch(
        *(jnp.asarray(x) for x in (u, a, b, gamma)), m2=m2, num_iters=iters)
    got = dual.solve_dual_batch(*(torch.tensor(x) for x in (u, a, b, gamma)),
                                m2=m2, num_iters=iters)
    agree = np.asarray(got.compliant.numpy() == np.asarray(want.compliant))
    # gap = dual_value - primal_value is held through its two terms: at
    # values near 44 their one-ulp drifts alone exceed atol on the gap
    for f in ("lam", "dual_value", "primal_value", "exposure"):
        close = np.isclose(getattr(got, f).numpy(),
                           np.asarray(getattr(want, f)), rtol=DUAL_RTOL,
                           atol=DUAL_ATOL)
        agree &= close.reshape(n, -1).all(1)
    at_risk = (a[np.arange(n), :, u.argmin(1)] == 1).any(1)
    parted = np.flatnonzero(~agree)
    assert at_risk[parted].all(), f"users {parted} parted without the tie"
    assert len(parted) <= max_parted, f"users {parted} parted"


def test_solve_dual_is_the_batch_of_one_and_shares_forms():
    _, u, a, b, gamma = _users(5, 4, 64, 3, 8)
    t = [torch.tensor(x) for x in (u, a, b, gamma)]
    batch = dual.solve_dual_batch(*t, m2=8, num_iters=30)
    one = dual.solve_dual(t[0][2], cons.ConstraintSet(a=t[1][2], b=t[2][2]),
                          t[3], m2=8, num_iters=30)
    assert torch.equal(one.lam, batch.lam[2])
    assert bool(one.compliant) == bool(batch.compliant[2])
    shared = dual.solve_dual_batch(t[0], t[1][0], t[2][0], t[3], m2=8,
                                   num_iters=30)
    full = dual.solve_dual_batch(t[0], t[1][0].expand_as(t[1]),
                                 t[2][0].expand_as(t[2]), t[3], m2=8,
                                 num_iters=30)
    assert torch.equal(shared.lam, full.lam)


def test_serve_rank_matches_jax():
    _, u, a, b, gamma = _users(9, 6, 64, 3, 8)
    lam = np.abs(np.random.default_rng(1).normal(size=(6, 3))
                 ).astype(np.float32)
    for i in range(2):
        jp, ju = jax_dual.serve_rank(jnp.asarray(u[i]), jnp.asarray(a[i]),
                                     jnp.asarray(lam[i]), jnp.asarray(gamma),
                                     m2=8)
        tp, tu = dual.serve_rank(torch.tensor(u[i]), torch.tensor(a[i]),
                                 torch.tensor(lam[i]), torch.tensor(gamma),
                                 m2=8)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_allclose(float(tu), float(ju), rtol=RTOL,
                                   atol=ATOL)


def test_tune_eps_picks_the_same_eps():
    """Same shadow prices, scaled down so that some users' compliance
    hangs on the tie-break boost; the grid is given out of order, and
    every tie keeps the smaller eps."""
    _, u, a, b, gamma = _users(13, 8, 64, 3, 8)
    sol = jax_dual.solve_dual_batch(
        *(jnp.asarray(x) for x in (u, a, b, gamma)), m2=8, num_iters=60)
    grid = (0.5, 0.0, 1e-2, 0.9, 1e-4, 0.1, 0.3)
    for scale in (1.0, 0.97, 0.9):
        lam = np.asarray(sol.lam) * np.float32(scale)
        want = jax_ranking.tune_eps(
            *(jnp.asarray(x) for x in (u, a, b, lam, gamma)), m2=8,
            grid=grid)
        t = [torch.tensor(x) for x in (u, a, b, lam, gamma)]
        assert ranking.tune_eps(*t, m2=8, grid=grid) == want
    assert ranking.EPS_GRID == jax_ranking.EPS_GRID


@pytest.fixture(scope="module")
def pipelines():
    """One small problem through both packages' fit_pipeline, with a
    holdout of the same shape (so JAX's 'optimal' reuses its compile)."""
    n, m1, K, m2 = 16, 64, 3, 8
    X, u, a, b, gamma = _users(21, 2 * n, m1, K, m2)
    train = tuple(x[:n] for x in (X, u, a, b))
    hold = tuple(x[n:] for x in (X, u, a, b))
    want = jax_ranking.fit_pipeline(
        *(jnp.asarray(x) for x in train), jnp.asarray(gamma), m2=m2,
        num_iters=60)
    got = ranking.fit_pipeline(*train, gamma, m2=m2, num_iters=60,
                               device=CPU)
    return got, want, hold


def test_fit_pipeline_matches_jax(pipelines):
    got, want, _ = pipelines
    _assert_solution(got.train_solution, want.train_solution)
    np.testing.assert_allclose(got.lam_train.numpy(),
                               np.asarray(want.lam_train), rtol=DUAL_RTOL,
                               atol=DUAL_ATOL)
    assert got.eps == want.eps and got.m2 == want.m2
    assert set(got.predictors) == set(want.predictors)
    for name, fields in (("mean", ("mean_lam",)), ("linear", ("W", "c")),
                         ("knn", ("X_db", "lam_db"))):
        for f in fields:
            np.testing.assert_allclose(
                getattr(got.predictors[name], f).numpy(),
                np.asarray(getattr(want.predictors[name], f)),
                rtol=DUAL_RTOL, atol=DUAL_ATOL, err_msg=f"{name}.{f}")
    assert got.predictors["knn"].k == want.predictors["knn"].k


@pytest.mark.parametrize("strategy",
                         ["none", "optimal", "mean", "linear", "knn"])
def test_rank_with_strategy_matches_jax(pipelines, strategy):
    got_pipe, want_pipe, (X, u, a, b) = pipelines
    want = jax_ranking.rank_with_strategy(
        want_pipe, strategy, *(jnp.asarray(x) for x in (X, u, a, b)),
        dual_iters=60)
    for backend in ("torch", "kernel"):
        got = ranking.rank_with_strategy(got_pipe, strategy, X, u, a, b,
                                         dual_iters=60, backend=backend,
                                         device=CPU)
        np.testing.assert_array_equal(got.perm.numpy(),
                                      np.asarray(want.perm))
        np.testing.assert_array_equal(got.compliant.numpy(),
                                      np.asarray(want.compliant))
        np.testing.assert_allclose(got.utility.numpy(),
                                   np.asarray(want.utility), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got.exposure.numpy(),
                                   np.asarray(want.exposure), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got.lam.numpy(), np.asarray(want.lam),
                                   rtol=DUAL_RTOL, atol=DUAL_ATOL)


@pytest.mark.parametrize("predictor", ["mean", "linear", "knn"])
def test_serve_kernel_backend_equals_torch_backend(pipelines, predictor):
    pipe, _, (X, u, a, b) = pipelines
    k = ranking.serve(pipe, X, u, a, b, predictor=predictor,
                      backend="kernel", device=CPU)
    t = ranking.serve(pipe, X, u, a, b, predictor=predictor,
                      backend="torch", device=CPU)
    assert torch.equal(k.perm, t.perm)
    assert torch.equal(k.compliant, t.compliant)
    for f in ("utility", "exposure"):
        np.testing.assert_allclose(getattr(k, f).numpy(),
                                   getattr(t, f).numpy(), rtol=RTOL,
                                   atol=ATOL)
    np.testing.assert_allclose(k.lam.numpy(), t.lam.numpy(), rtol=1e-5,
                               atol=1e-6)


def test_pipeline_errors_and_with_predictor(pipelines):
    pipe, _, (X, u, a, b) = pipelines
    with pytest.raises(NotImplementedError, match="Queue 1 item 3"):
        ranking.fit_pipeline(X, u, a, b, pipe.gamma, m2=8, with_mlp=True,
                             device=CPU)
    with pytest.raises(ValueError, match="backend"):
        ranking.serve(pipe, X, u, a, b, backend="xla", device=CPU)
    swapped = ranking.with_predictor(pipe, "knn", pipe.predictors["mean"])
    assert swapped.predictors["knn"] is pipe.predictors["mean"]
    assert pipe.predictors["knn"] is not pipe.predictors["mean"]
