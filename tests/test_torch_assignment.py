"""The rest of the port's core (assignment solvers, Monge checks, BvN
rounding) against repro.core on hypothesis-drawn
inputs, drawn as tests/test_assignment.py, test_monge.py and
test_bvn.py draw them.

Perms exact; auction optimal against brute_force (up to its eps);
greedy_half_approx within its 1/2 bound; sinkhorn_project within rtol
1e-6 of JAX's. JAX's sinkhorn_project is spelt float64, but the repo
runs JAX with jax_enable_x64 off (tests/conftest.py), so the reference
computes in float32, as the port does. sample_ranking's marginals within
the JAX test's 0.05.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import assignment as jassign
from repro.core import bvn as jbvn
from repro.core import monge as jmonge
from repro_torch.core import assignment, bvn, monge

CPU = "cpu"
SETTINGS = dict(max_examples=25, deadline=None)
MONGE = dict(max_examples=15, deadline=None)


def _rand_S(seed, m1, m2):
    return np.random.default_rng(seed).normal(size=(m1, m2)).astype(
        np.float32)


def _tall(m1, m2):
    return (m2, m1) if m2 > m1 else (m1, m2)


@settings(**SETTINGS)
@given(st.integers(0, 10_000), st.integers(2, 6), st.integers(2, 6))
def test_auction_matches_jax_and_is_optimal(seed, m1, m2):
    m1, m2 = _tall(m1, m2)
    S = _rand_S(seed, m1, m2)
    perm = assignment.auction(torch.tensor(S), eps=1e-4)
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(
        perm.numpy(), np.asarray(jassign.auction(jnp.asarray(S), eps=1e-4)))
    St = torch.tensor(S)
    v_auc = float(assignment.assignment_value_dense(St, perm))
    v_bf = float(assignment.assignment_value_dense(
        St, torch.as_tensor(assignment.brute_force(S))))
    assert v_auc >= v_bf - 1e-2
    assert len(set(perm.tolist())) == m2


@settings(**SETTINGS)
@given(st.integers(0, 10_000), st.integers(2, 7), st.integers(2, 7))
def test_greedy_matches_jax_and_half_bound(seed, m1, m2):
    m1, m2 = _tall(m1, m2)
    S = np.abs(_rand_S(seed, m1, m2))
    perm = assignment.greedy_half_approx(torch.tensor(S))
    np.testing.assert_array_equal(
        perm.numpy(), np.asarray(jassign.greedy_half_approx(jnp.asarray(S))))
    St = torch.tensor(S)
    v_g = float(assignment.assignment_value_dense(St, perm))
    v_bf = float(assignment.assignment_value_dense(
        St, torch.as_tensor(assignment.brute_force(S))))
    assert v_g >= 0.5 * v_bf - 1e-5
    assert len(set(perm.tolist())) == m2


def test_greedy_and_auction_tie_to_the_lowest_index():
    """All-equal scores: greedy takes the first entry in row-major order
    each round, the auction's argmax and top-2 the lowest index, as
    JAX's do."""
    S = np.ones((4, 3), np.float32)
    for port, jax_fn in ((assignment.greedy_half_approx,
                          jassign.greedy_half_approx),
                         (lambda s: assignment.auction(s, eps=1e-4),
                          lambda s: jassign.auction(s, eps=1e-4))):
        np.testing.assert_array_equal(port(torch.tensor(S)).numpy(),
                                      np.asarray(jax_fn(jnp.asarray(S))))


@settings(**SETTINGS)
@given(st.integers(0, 10_000), st.integers(2, 8), st.integers(1, 8))
def test_values_and_matrix_match_jax(seed, m1, m2):
    m2 = min(m1, m2)
    rng = np.random.default_rng(seed)
    s = rng.normal(size=(m1,)).astype(np.float32)
    gamma = np.sort(rng.uniform(0.05, 1.0, size=(m2,)))[::-1].astype(
        np.float32)
    S = np.outer(s, gamma).astype(np.float32)
    perm = assignment.rank_by_sort(torch.tensor(s), m2)
    jperm = jassign.rank_by_sort(jnp.asarray(s), m2)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_allclose(
        float(assignment.assignment_value(torch.tensor(s),
                                          torch.tensor(gamma), perm)),
        float(jassign.assignment_value(jnp.asarray(s), jnp.asarray(gamma),
                                       jperm)), rtol=1e-6)
    np.testing.assert_allclose(
        float(assignment.assignment_value_dense(torch.tensor(S), perm)),
        float(jassign.assignment_value_dense(jnp.asarray(S), jperm)),
        rtol=1e-6)
    np.testing.assert_array_equal(
        assignment.perm_to_matrix(perm, m1).numpy(),
        np.asarray(jassign.perm_to_matrix(jperm, m1)))
    # the rearrangement inequality: the sort is the brute-force optimum
    v_bf = float(assignment.assignment_value_dense(
        torch.tensor(S), torch.as_tensor(assignment.brute_force(S))))
    assert float(assignment.assignment_value_dense(torch.tensor(S), perm)) \
        >= v_bf - 1e-5


def test_perm_to_matrix_roundtrip():
    perm = torch.tensor([3, 0, 2])
    P = assignment.perm_to_matrix(perm, 5)
    assert P.shape == (5, 3) and P.dtype == torch.float32
    np.testing.assert_allclose(P.sum(dim=0).numpy(), 1.0)
    S = torch.arange(15.0).reshape(5, 3)
    assert float(torch.sum(S * P)) == float(
        assignment.assignment_value_dense(S, perm))


@pytest.mark.parametrize("seed", range(4))
def test_brute_force_constrained_matches_jax(seed):
    rng = np.random.default_rng(seed)
    m1, m2, K = 5, 3, 2
    U = rng.normal(size=(m1, m2))
    A = rng.uniform(size=(K, m1, m2))
    b = np.array([0.8, 2.0])
    signs = np.array([1, -1])
    perm, val = assignment.brute_force_constrained(U, A, b, signs)
    jperm, jval = jassign.brute_force_constrained(U, A, b, signs)
    assert val == jval
    if jperm is None:
        assert perm is None
    else:
        np.testing.assert_array_equal(perm, jperm)
    np.testing.assert_array_equal(assignment.brute_force(U),
                                  jassign.brute_force(U))


# -- monge ---------------------------------------------------------------------

def _monge_both(S):
    """(port, JAX) of each check on S, as Python values."""
    St, Sj = torch.tensor(S, dtype=torch.float32), jnp.asarray(S, jnp.float32)
    return ((bool(monge.is_inverse_monge(St)),
             bool(monge.is_permuted_inverse_monge(St)),
             float(monge.monge_defect(St))),
            (bool(jmonge.is_inverse_monge(Sj)),
             bool(jmonge.is_permuted_inverse_monge(Sj)),
             float(jmonge.monge_defect(Sj))))


@settings(**MONGE)
@given(st.integers(0, 10_000), st.integers(2, 10), st.integers(2, 10))
def test_outer_product_of_sorted_vectors_is_inverse_monge(seed, m, n):
    rng = np.random.default_rng(seed)
    s = np.sort(rng.normal(size=m))[::-1]
    gamma = np.sort(rng.uniform(0.01, 1, size=n))[::-1]
    port, want = _monge_both(np.outer(s, gamma))
    assert port == want
    assert port[0] and port[2] == 0.0


@settings(**MONGE)
@given(st.integers(0, 10_000), st.integers(2, 8), st.integers(2, 8))
def test_fixed_discounting_is_permuted_inverse_monge(seed, m, n):
    rng = np.random.default_rng(seed)
    s = rng.normal(size=m)
    gamma = np.sort(rng.uniform(0.01, 1, size=n))[::-1]
    port, want = _monge_both(np.outer(s, gamma))
    assert port == want and port[1]


@settings(**MONGE)
@given(st.integers(0, 10_000), st.integers(2, 8), st.integers(2, 8))
def test_general_matrices_match_jax(seed, m, n):
    """Random S (mostly not Monge), and S with tied first-column entries
    where the row order after the stable sort decides."""
    rng = np.random.default_rng(seed)
    S = rng.normal(size=(m, n))
    assert _monge_both(S)[0] == _monge_both(S)[1]
    S[:, 0] = np.round(S[:, 0])
    port, want = _monge_both(S)
    assert port == want


def test_non_monge_detected():
    port, want = _monge_both(np.array([[0.0, 1.0], [1.0, 0.0]]))
    assert port == want
    assert not port[0] and port[2] > 0


# -- bvn -----------------------------------------------------------------------

def _random_ds(seed, m):
    M = np.random.default_rng(seed).uniform(0.1, 1.0, size=(m, m))
    return bvn.sinkhorn_project(M, iters=400, device=CPU).numpy()


@settings(max_examples=10, deadline=None)
@given(st.integers(0, 500), st.integers(2, 7))
def test_sinkhorn_matches_jax_in_float32(seed, m):
    M = np.random.default_rng(seed).uniform(0.1, 1.0, size=(m, m))
    P = bvn.sinkhorn_project(M, iters=400, device=CPU)
    assert P.dtype == torch.float32
    jP = np.asarray(jbvn.sinkhorn_project(jnp.asarray(M), iters=400))
    assert jP.dtype == np.float32          # jax_enable_x64 is off
    np.testing.assert_allclose(P.numpy(), jP, rtol=1e-6)
    assert bvn.is_doubly_stochastic(P.numpy(), atol=1e-4)


@settings(max_examples=5, deadline=None)
@given(st.integers(0, 500), st.integers(2, 7))
def test_decomposition_matches_jax_and_reconstructs(seed, m):
    P = _random_ds(seed, m)
    coeffs, perms = bvn.bvn_decompose(P, device=CPU)
    jcoeffs, jperms = jbvn.bvn_decompose(P)
    np.testing.assert_array_equal(perms, jperms)
    np.testing.assert_array_equal(coeffs, jcoeffs)
    assert np.isclose(coeffs.sum(), 1.0, atol=1e-6)
    R = np.zeros((m, m))
    for c, perm in zip(coeffs, perms):
        R += c * assignment.perm_to_matrix(torch.as_tensor(perm),
                                           m).double().numpy()
    np.testing.assert_allclose(R, P, atol=5e-3)
    assert len(coeffs) <= (m - 1) ** 2 + 1


def test_permutation_matrix_is_its_own_decomposition():
    perm = torch.tensor([2, 0, 1])
    P = assignment.perm_to_matrix(perm, 3).numpy()
    coeffs, perms = bvn.bvn_decompose(P, device=CPU)
    assert len(coeffs) == 1
    np.testing.assert_array_equal(perms[0], perm.numpy())


def test_sampling_matches_marginals():
    P = _random_ds(7, 4)
    coeffs, perms = bvn.bvn_decompose(P, device=CPU)
    gen = torch.Generator().manual_seed(0)
    counts = np.zeros((4, 4))
    n = 3000
    for _ in range(n):
        perm = bvn.sample_ranking(gen, coeffs, perms).numpy()
        counts[perm, np.arange(4)] += 1
    np.testing.assert_allclose(counts / n, P, atol=0.05)


def test_rejects_non_ds():
    with pytest.raises(ValueError, match="doubly-stochastic"):
        bvn.bvn_decompose(np.ones((3, 3)), device=CPU)
    assert bvn.is_doubly_stochastic(np.eye(3)) == jbvn.is_doubly_stochastic(
        np.eye(3))


def test_jax_runs_float32_here():
    """The hazard the sinkhorn test rests on: this repo's JAX has x64
    off, so a float64 spelling computes in float32."""
    assert not jax.config.jax_enable_x64
