"""The port's synthetic data (data.synthetic) held against
repro.data.synthetic: the generators' statistics (as tests/test_data.py
checks the JAX ones), the per-user constraint functions and the
vectorised slates and constraint assembly on carried JAX arrays, the
Table 1 scenario lookup, and the drifting-traffic payloads on one numpy
seed.

Tolerances: slates (top_idx, u), a, X and the split exact; b and gamma
rtol=1e-6 (XLA and torch may sum gamma and round log2 an ulp apart);
drift payloads u, a and X bitwise (the same numpy draws in the same
order), b and gamma rtol=1e-6. The port draws with torch, so its data
match the JAX package's in law (rates, ranges, signs), not in values.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.synthetic as jsyn
from repro.core.constraints import dcg_discount as jax_dcg
from repro_torch.core.constraints import dcg_discount
from repro_torch.data import synthetic as syn

CPU = "cpu"
RTOL = 1e-6


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def test_every_public_name_of_the_jax_module_is_ported():
    own = [name for name, obj in vars(jsyn).items()
           if not name.startswith("_") and not inspect.ismodule(obj)
           and getattr(obj, "__module__", jsyn.__name__) == jsyn.__name__]
    assert "build_experiment" in own and "drift_request_params" in own
    missing = [name for name in own if not hasattr(syn, name)]
    assert not missing, missing
    for name in ("MOVIELENS_QUOTA", "YOW_TOPIC_RATE", "YOW_CONSTRAINTS",
                 "MOVIELENS_TOPICS", "YOW_TOPICS", "MOVIELENS_TOPIC_RATE"):
        assert getattr(syn, name) == getattr(jsyn, name)


def test_interactions_ratings_in_range_and_deterministic():
    d = syn.make_interactions(_gen(0), n_users=50, n_items=60, n_obs=2000,
                              device=CPU)
    r = d.rating.numpy()
    assert r.min() >= 1 and r.max() <= 5 and len(np.unique(r)) >= 3
    assert d.uid.max() < 50 and d.iid.max() < 60
    again = syn.make_interactions(_gen(0), n_users=50, n_items=60,
                                  n_obs=2000, device=CPU)
    assert torch.equal(d.rating, again.rating)


def test_corpus_rates_match_table_1():
    c = syn.make_movielens_corpus(_gen(1), 20000, device=CPU)
    np.testing.assert_allclose(c.topics.numpy().mean(axis=1), 0.05,
                               atol=0.01)
    years = c.extra[0].numpy() * 100 + 1990
    assert years.min() >= 1950 and years.max() < 2020
    assert 2003 < years.mean() < 2011              # the recent skew
    y = syn.make_yow_corpus(_gen(2), 50000, device=CPU)
    np.testing.assert_allclose(y.topics.numpy().mean(axis=1),
                               syn.YOW_TOPIC_RATE, atol=0.01)
    assert y.extra is None and y.topic_names == syn.YOW_TOPICS


def _carried_corpus(jc):
    return syn.Corpus(
        topics=torch.tensor(np.asarray(jc.topics)),
        extra=None if jc.extra is None else torch.tensor(
            np.asarray(jc.extra)), topic_names=jc.topic_names)


@pytest.mark.parametrize("m2", [50, 275, 500, 1000])
@pytest.mark.parametrize("dataset", ["movielens", "yow"])
def test_per_user_constraints_match_jax(dataset, m2):
    key = jax.random.key(3)
    jc = (jsyn.make_movielens_corpus(key, 3000) if dataset == "movielens"
          else jsyn.make_yow_corpus(key, 3000))
    fn, jfn = ((syn.movielens_constraints, jsyn.movielens_constraints)
               if dataset == "movielens"
               else (syn.yow_constraints, jsyn.yow_constraints))
    idx = np.random.default_rng(m2).permutation(3000)[:1000]
    want = jfn(jc, jnp.asarray(idx), jax_dcg(m2), m2)
    got = fn(_carried_corpus(jc), torch.tensor(idx), dcg_discount(m2), m2,
             device=CPU)
    np.testing.assert_array_equal(got.a.numpy(), np.asarray(want.a))
    np.testing.assert_allclose(got.b.numpy(), np.asarray(want.b), rtol=RTOL)
    K = 5 if dataset == "movielens" else 8
    assert got.a.shape == (K, 1000)
    if dataset == "movielens":
        assert float(got.b[-1]) == 0.0            # release-year threshold
    else:
        assert float(got.a[2].max()) <= 0.0       # business is a <= row
        assert float(got.a[0].min()) >= 0.0       # sci&tech is a >= row


def test_scenario_takes_the_nearest_and_the_first_on_a_tie():
    for m2 in (1, 50, 275, 276, 700, 750, 5000):
        assert syn._scenario(syn.MOVIELENS_QUOTA, m2) == jsyn._scenario(
            jsyn.MOVIELENS_QUOTA, m2)
    assert syn._scenario(syn.MOVIELENS_QUOTA, 275) == 0.10   # 50, not 500


@pytest.mark.parametrize("dataset", ["movielens", "yow"])
def test_vectorised_assembly_equals_the_per_user_loop(dataset):
    """assemble_experiment on JAX's u_all, X, corpus and permutation
    against build_experiment's own steps 2-4: jax.lax.top_k, the
    per-user constraint loop and the split. u_all sits on a grid of
    1/8, so most slates hold ties; one is planted at the top of user 0."""
    n, n_items, m1, m2 = 20, 300, 120, 50
    rng = np.random.default_rng(len(dataset))
    u_all = (np.round(rng.uniform(1.0, 5.0, (n, n_items)) * 8.0)
             / 8.0).astype(np.float32)
    u_all[0, [3, 7]] = 6.0
    X = rng.normal(size=(n, 20)).astype(np.float32)
    key = jax.random.key(9)
    jc = (jsyn.make_movielens_corpus(key, n_items) if dataset == "movielens"
          else jsyn.make_yow_corpus(key, n_items))
    perm = np.asarray(jax.random.permutation(jax.random.key(10), n))
    gamma = jax_dcg(m2)
    top_u, top_idx = jax.lax.top_k(jnp.asarray(u_all), m1)
    jfn = (jsyn.movielens_constraints if dataset == "movielens"
           else jsyn.yow_constraints)
    sets = [jfn(jc, top_idx[i], gamma, m2) for i in range(n)]
    a = np.stack([np.asarray(s.a) for s in sets])
    exp = syn.assemble_experiment(
        torch.tensor(u_all), torch.tensor(X), _carried_corpus(jc),
        torch.tensor(perm), dataset=dataset, m1=m1, m2=m2)
    t_u, t_idx = syn.candidate_slates(torch.tensor(u_all), m1)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(top_idx))
    assert t_idx[0, :2].tolist() == [3, 7]
    np.testing.assert_array_equal(exp.u.numpy(), np.asarray(top_u))
    np.testing.assert_array_equal(exp.a.numpy(), a)
    np.testing.assert_allclose(exp.b.numpy(), np.asarray(sets[-1].b),
                               rtol=RTOL)
    np.testing.assert_allclose(exp.gamma.numpy(), np.asarray(gamma),
                               rtol=RTOL)
    np.testing.assert_array_equal(exp.X.numpy(), X)
    n_train = int(round(0.75 * n))
    np.testing.assert_array_equal(exp.train_idx.numpy(), perm[:n_train])
    np.testing.assert_array_equal(exp.test_idx.numpy(), perm[n_train:])
    u_tr, X_tr, a_tr = exp.split("train")
    np.testing.assert_array_equal(a_tr.numpy(), a[perm[:n_train]])
    assert exp.m2 == m2


@pytest.mark.parametrize("kind", ["none", "tighten", "shift", "grow"])
def test_drift_request_params_match_jax(kind):
    spec, jspec = syn.DriftSpec(kind=kind), jsyn.DriftSpec(kind=kind)
    rng_t, rng_j = np.random.default_rng(21), np.random.default_rng(21)
    for t in (0.0, 0.3, 0.5, 0.8, 1.0):
        assert syn.drift_phase(spec, t) == jsyn.drift_phase(jspec, t)
        kw = dict(m1=300, m2=50, K=5, d_cov=20)
        got = syn.drift_request_params(rng_t, spec, t, **kw)
        want = jsyn.drift_request_params(rng_j, jspec, t, **kw)
        for f in ("u", "a", "X"):
            np.testing.assert_array_equal(got[f], want[f])
            assert got[f].dtype == want[f].dtype
        for f in ("b", "gamma"):
            np.testing.assert_allclose(got[f], want[f], rtol=RTOL)


def test_drift_spec_errors():
    with pytest.raises(ValueError, match="unknown drift kind"):
        syn.DriftSpec(kind="melt")
    with pytest.raises(ValueError, match="start <= end"):
        syn.DriftSpec(start=0.8, end=0.2)
    with pytest.raises(ValueError, match="start <= end"):
        syn.DriftSpec(end=1.5)


def test_build_experiment_on_the_cpu():
    exp = syn.build_experiment(_gen(5), dataset="yow", n_users=24,
                               n_items=150, m1=60, m2=50,
                               recommender_epochs=1, device=CPU)
    assert exp.u.shape == (24, 60) and exp.X.shape == (24, 20)
    assert exp.a.shape == (24, 8, 60) and exp.b.shape == (8,)
    assert exp.train_idx.numel() == 18 and exp.test_idx.numel() == 6
    assert set(exp.stage_s) == {"training", "utilities",
                                "slates_constraints"}
    assert bool((exp.u[:, :-1] >= exp.u[:, 1:]).all())
    with pytest.raises(ValueError, match="dataset"):
        syn.build_experiment(_gen(5), dataset="netflix", device=CPU)
