"""The port's rank + audit path held against the JAX XLA oracles.

Inputs are made with numpy from a seed and fed to both packages; the
JAX side runs core.ranking.rank_given_lambda and kernels.ref (never the
Pallas interpret path). Tolerances:
  * perm / idx and compliant match exactly; thresholds b are drawn at
    least 1e-3 away from exposure - tol so compliance is decided well
    clear of float noise;
  * utility and exposure: rtol=1e-5, atol=1e-5 (the port sums slot by
    slot, XLA in its own order).
The port's plain rank_audited_ref forms s in the Pallas kernel's axpy
order, the oracle with an einsum; perm still matches at these sizes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.assignment import rank_by_sort as jax_rank_by_sort
from repro.core.constraints import dcg_discount as jax_dcg
from repro.core.ranking import AUDIT_TOL, rank_given_lambda as jax_rank
from repro.kernels import ref as jax_ref
from repro_torch.core.assignment import rank_by_sort
from repro_torch.core.constraints import dcg_discount
from repro_torch.core.ranking import rank_given_lambda
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_rank import rank_audited_cuda

RTOL, ATOL = 1e-5, 1e-5
CPU = "cpu"


def _problem(seed, n, m1, K, m2, *, ties=False):
    rng = np.random.default_rng(seed)
    if ties:
        u = rng.integers(0, 4, (n, m1)).astype(np.float32)
        a = np.zeros((n, K, m1), np.float32)
    else:
        u = rng.uniform(1.0, 5.0, (n, m1)).astype(np.float32)
        a = (rng.random((n, K, m1)) < 0.15).astype(np.float32)
    lam = rng.exponential(0.5, (n, K)).astype(np.float32)
    gamma = np.broadcast_to(np.asarray(jax_dcg(m2)), (n, m2)).copy()
    return u, a, lam, gamma, rng


def _thresholds(rng, exposure):
    """b at least 1e-3 away from exposure - tol, on either side; every
    other row meets all of its constraints."""
    side = np.where(rng.random(exposure.shape) < 0.5, -1.0, 1.0)
    side[::2] = -1.0
    delta = side * rng.uniform(1e-3, 0.3, exposure.shape)
    return (exposure + AUDIT_TOL + delta).astype(np.float32)


def _oracle(u, a, b, lam, gamma, m2):
    out = jax_rank(jnp.asarray(u), jnp.asarray(a), jnp.asarray(b),
                   jnp.asarray(lam), jnp.asarray(gamma), m2=m2)
    return {f: np.asarray(getattr(out, f))
            for f in ("perm", "utility", "exposure", "compliant")}


def _assert_matches(got, want):
    np.testing.assert_array_equal(np.asarray(got.perm), want["perm"])
    np.testing.assert_array_equal(np.asarray(got.compliant),
                                  want["compliant"])
    np.testing.assert_allclose(np.asarray(got.utility), want["utility"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(np.asarray(got.exposure), want["exposure"],
                               rtol=RTOL, atol=ATOL)


SHAPES = [(n, m1, K, m2)
          for n, m1 in ((3, 64), (16, 700), (8, 1024))
          for K in (1, 2, 5, 8)
          for m2 in (1, 8, 50, 128) if m2 <= m1]


@pytest.mark.parametrize("n,m1,K,m2", SHAPES)
def test_rank_audited_matches_xla_oracle(n, m1, K, m2):
    u, a, lam, gamma, rng = _problem(n * 1000 + m1 + K + m2, n, m1, K, m2)
    probe = _oracle(u, a, np.zeros((n, K), np.float32), lam, gamma, m2)
    b = _thresholds(rng, probe["exposure"])
    want = _oracle(u, a, b, lam, gamma, m2)
    assert 0 < want["compliant"].sum() < n or n < 4
    _assert_matches(ops.rank_audited(u, a, b, lam, gamma, m2=m2,
                                     device=CPU), want)
    t = [torch.tensor(x) for x in (u, a, b, lam, gamma)]
    _assert_matches(rank_given_lambda(*t, m2=m2), want)


@pytest.mark.parametrize("m1,m2", [(64, 8), (700, 50), (1024, 1024)])
def test_exact_ties_go_to_the_lowest_index(m1, m2):
    u, a, lam, gamma, rng = _problem(7, 4, m1, 2, m2, ties=True)
    b = np.zeros((4, 2), np.float32)
    want = _oracle(u, a, b, lam, gamma, m2)
    got = ops.rank_audited(u, a, b, lam, gamma, m2=m2, device=CPU)
    _assert_matches(got, want)
    perm = got.perm.numpy()
    vals = np.take_along_axis(u, perm, axis=1)
    tied = vals[:, 1:] == vals[:, :-1]
    assert tied.any()
    assert (perm[:, 1:][tied] > perm[:, :-1][tied]).all()


@pytest.mark.parametrize("m2", [None, 5])
def test_rank_by_sort_matches_lax(m2):
    rng = np.random.default_rng(3)
    s = rng.integers(0, 6, (5, 40)).astype(np.float32)
    want = np.asarray(jax_rank_by_sort(jnp.asarray(s), m2))
    got = rank_by_sort(torch.tensor(s), m2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_dcg_discount_matches():
    np.testing.assert_allclose(dcg_discount(128).numpy(),
                               np.asarray(jax_dcg(128)), rtol=1e-6)


def test_shared_forms_broadcast():
    u, a, lam, gamma, _ = _problem(11, 6, 300, 3, 20)
    a0, b0, g0 = a[0], np.full(3, 0.4, np.float32), gamma[0]
    want = _oracle(u, np.broadcast_to(a0, a.shape).copy(),
                   np.broadcast_to(b0, (6, 3)).copy(), lam, gamma, 20)
    _assert_matches(ops.rank_audited(u, a0, b0, lam, g0, m2=20,
                                     device=CPU), want)


def test_bucket_padding_keeps_the_answer():
    """m1, m2, K and batch padded the engine's way give the unpadded
    oracle's answer on the real rows."""
    n, m1, K, m2 = 5, 300, 3, 20
    u, a, lam, gamma, rng = _problem(13, n, m1, K, m2)
    b = rng.uniform(0.0, 1.0, (n, K)).astype(np.float32)
    want = _oracle(u, a, b, lam, gamma, m2)
    N, M1, KP, M2 = 8, 512, 4, 32
    up = np.full((N, M1), -1e30, np.float32)
    up[:n, :m1] = u
    ap = np.zeros((N, KP, M1), np.float32)
    ap[:n, :K, :m1] = a
    bp = np.zeros((N, KP), np.float32)
    bp[:n, :K] = b
    lp = np.zeros((N, KP), np.float32)
    lp[:n, :K] = lam
    gp = np.zeros((N, M2), np.float32)
    gp[:n, :m2] = gamma
    got = ops.rank_audited(up, ap, bp, lp, gp, m2=M2, device=CPU)
    np.testing.assert_array_equal(got.perm[:n, :m2].numpy(), want["perm"])
    np.testing.assert_array_equal(got.compliant[:n].numpy(),
                                  want["compliant"])
    np.testing.assert_allclose(got.utility[:n].numpy(), want["utility"],
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.exposure[:n, :K].numpy(),
                               want["exposure"], rtol=RTOL, atol=ATOL)


def test_large_m2_runs_the_plain_path_on_cpu():
    u, a, lam, gamma, rng = _problem(17, 3, 300, 2, 200)
    b = rng.uniform(0.0, 1.0, (3, 2)).astype(np.float32)
    _assert_matches(ops.rank_audited(u, a, b, lam, gamma, m2=200,
                                     device=CPU),
                    _oracle(u, a, b, lam, gamma, 200))


def test_plain_version_matches_jax_ref():
    """The plain version beside the kernel against kernels.ref's XLA
    oracle, output by output; the wrapper takes it on a CPU tensor."""
    u, a, lam, gamma, rng = _problem(19, 4, 700, 5, 50)
    b = rng.uniform(0.0, 2.0, (4, 5)).astype(np.float32)
    jv, ji, ju, je, jc = (np.asarray(x) for x in jax_ref.rank_audited_ref(
        *(jnp.asarray(x) for x in (u, a, b, lam, gamma)), 50))
    t = [torch.tensor(x) for x in (u, a, b, lam, gamma)]
    for out in (ref.rank_audited_ref(*t, 50),
                rank_audited_cuda(*t, m2=50, device=CPU)):
        v, i, ut, e, c = (x.numpy() for x in out)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_allclose(v, jv, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(ut, ju, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(e, je, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguity", "m2"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    u, a, lam, gamma, _ = _problem(23, 2, 64, 2, 8)
    t = dict(zip("u a b lam gamma".split(),
                 (torch.tensor(x) for x in
                  (u, a, np.zeros((2, 2), np.float32), lam, gamma))))
    m2 = 8
    if bad == "dtype":
        t["u"] = t["u"].double()
    elif bad == "shape":
        t["b"] = t["b"][:, :1]
    elif bad == "contiguity":
        t["a"] = t["a"].transpose(1, 2).contiguous().transpose(1, 2)
    else:
        m2 = 129
    with pytest.raises(ValueError):
        rank_audited_cuda(t["u"], t["a"], t["b"], t["lam"], t["gamma"],
                          m2=m2, device=CPU)
