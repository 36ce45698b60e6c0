"""The port's constraint constructors and ConstraintSet methods held against
the JAX package (repro.core.constraints) on the same numpy inputs.

Tolerances: a bitwise (a gather and a sign flip are exact); b, the
discounts and exposure rtol=1e-6, atol=1e-7 (XLA and torch may sum
gamma, and round log2 and pow, an ulp apart); violations = max(b -
exposure, 0), the difference of two such terms, within 1e-6 * (|b| +
|exposure|) absolute; is_compliant exact on perms whose exposure is not
within 1e-5 of b.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constraints as jax_cons
from repro_torch.core import constraints as cons

RTOL, ATOL = 1e-6, 1e-7
CPU = "cpu"


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("m2", [1, 50, 500])
def test_discounts_match_jax(m2):
    np.testing.assert_allclose(_np(cons.geometric_discount(m2)),
                               _np(jax_cons.geometric_discount(m2)),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(_np(cons.geometric_discount(m2, d=0.5)),
                               _np(jax_cons.geometric_discount(m2, d=0.5)),
                               rtol=RTOL, atol=ATOL)


def _set_pair(rng, K, m1, m2):
    """The same quota set built by both packages, plus gamma."""
    topics = (rng.random((K, m1)) < 0.2).astype(np.float32)
    fracs = rng.uniform(0.01, 0.3, K).astype(np.float32)
    signs = np.where(rng.random(K) < 0.5, 1.0, -1.0).astype(np.float32)
    g_j = jax_cons.dcg_discount(m2)
    g_t = torch.tensor(np.asarray(g_j))
    j = jax_cons.exposure_quota_constraints(jnp.asarray(topics),
                                            jnp.asarray(fracs),
                                            jnp.asarray(signs), g_j)
    t = cons.exposure_quota_constraints(topics, fracs, signs, g_t,
                                        device=CPU)
    return j, t, g_j, g_t


@pytest.mark.parametrize("K,m1,m2", [(1, 20, 5), (5, 300, 50),
                                     (8, 1000, 500)])
def test_exposure_quota_constraints_and_methods(K, m1, m2):
    rng = np.random.default_rng(K * m1)
    j, t, g_j, g_t = _set_pair(rng, K, m1, m2)
    np.testing.assert_array_equal(_np(t.a), _np(j.a))
    np.testing.assert_allclose(_np(t.b), _np(j.b), rtol=RTOL, atol=ATOL)
    assert t.num_constraints == j.num_constraints == K
    for trial in range(4):
        perm = rng.permutation(m1)[:m2]
        expo_j = _np(j.exposure(jnp.asarray(perm), g_j))
        expo_t = _np(t.exposure(torch.tensor(perm), g_t))
        np.testing.assert_allclose(expo_t, expo_j, rtol=RTOL, atol=ATOL)
        scale = np.abs(_np(j.b)) + np.abs(expo_j)
        assert np.all(np.abs(
            _np(t.violations(perm, g_t))
            - _np(j.violations(jnp.asarray(perm), g_j))) <= RTOL * scale)
        if np.all(np.abs(expo_j - _np(j.b)) > 1e-5):
            assert t.is_compliant(perm, g_t) == bool(
                j.is_compliant(jnp.asarray(perm), g_j))


def test_is_compliant_uses_atol():
    s = cons.make_constraints([np.ones(3)], [2.0], [1.0], device=CPU)
    g = torch.tensor([1.0, 1.0 - 5e-7])
    assert s.is_compliant([0, 1], g)             # 2 - 5e-7 >= 2 - 1e-6
    assert not s.is_compliant([0, 1], g, atol=1e-7)
    assert s.violations([0, 1], g).item() > 0


@pytest.mark.parametrize("quota,m1,m2", [(0.10, 200, 50), (0.05, 1000, 500),
                                         (0.015, 1000, 1000)])
def test_movielens_style_constraints(quota, m1, m2):
    rng = np.random.default_rng(m2)
    topics = (rng.random((4, m1)) < 0.05).astype(np.float32)
    delta = ((2019.0 - np.floor(rng.exponential(size=m1) * 12.0)
              - 1990.0) / 100.0).astype(np.float32)
    g_j = jax_cons.dcg_discount(m2)
    j = jax_cons.movielens_style_constraints(jnp.asarray(topics),
                                             jnp.asarray(delta), quota, g_j)
    t = cons.movielens_style_constraints(topics, delta, quota,
                                         torch.tensor(np.asarray(g_j)),
                                         device=CPU)
    np.testing.assert_array_equal(_np(t.a), _np(j.a))
    np.testing.assert_allclose(_np(t.b), _np(j.b), rtol=RTOL, atol=ATOL)
    assert float(t.b[-1]) == 0.0
    perm = rng.permutation(m1)[:m2]
    np.testing.assert_allclose(
        _np(t.exposure(perm, torch.tensor(np.asarray(g_j)))),
        _np(j.exposure(jnp.asarray(perm), g_j)), rtol=RTOL, atol=ATOL)


def test_constraint_sets_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cons.exposure_quota_constraints(np.ones((2, 3)), [0.1, 0.1],
                                        [1, -1], torch.ones(2))
