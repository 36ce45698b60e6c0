"""The port's Appendix-B recommender (models.recommender) held against
repro.models.recommender on carried parameters (load_numpy of the JAX
init, with the biases and intercepts made nonzero so that they count).

Tolerances: rating_logits, predict_rating, utilities and
user_covariates rtol=1e-5, atol=1e-6 (the covariates are a gather,
bitwise); the loss and every gradient with dropout off, against
jax.value_and_grad, rtol=1e-5, atol=1e-6; one Adam step from there,
rtol=1e-5, atol=1e-6. Training from the port's own draws lowers the
loss, as tests/test_recommender.py checks the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.recommender import PaperRecommender as JaxRec
from repro.models.recommender import RecommenderConfig as JaxCfg
from repro.optim import adam_init as jax_adam_init
from repro.optim import adam_update as jax_adam_update
from repro_torch.data.synthetic import make_interactions
from repro_torch.models.layers import dense_init
from repro_torch.models.recommender import (
    PARAM_NAMES,
    PaperRecommender,
    RecommenderConfig,
)
from repro_torch.optim import adam_init, adam_update

RTOL, ATOL = 1e-5, 1e-6
CPU = "cpu"
N_USERS, N_ITEMS = 30, 50


@pytest.fixture(scope="module")
def carried():
    """(JAX model, its params, the port's model on the same params, a
    batch of 64 ratings)."""
    jrec = JaxRec(JaxCfg(n_users=N_USERS, n_items=N_ITEMS))
    params = jrec.init(jax.random.key(4))
    rng = np.random.default_rng(4)
    for name in ("user_int", "item_int", "b1", "b2"):
        params[name] = jnp.asarray(
            rng.normal(size=params[name].shape).astype(np.float32) * 0.3)
    rec = PaperRecommender(RecommenderConfig(n_users=N_USERS,
                                             n_items=N_ITEMS), device=CPU)
    rec.load_numpy({k: np.asarray(v) for k, v in params.items()})
    batch = {"uid": rng.integers(0, N_USERS, 64),
             "iid": rng.integers(0, N_ITEMS, 64),
             "rating": rng.integers(1, 6, 64).astype(np.int32)}
    return jrec, params, rec, batch


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


def test_forward_matches_jax(carried):
    jrec, params, rec, batch = carried
    uid, iid = batch["uid"], batch["iid"]
    for k, v in rec.state_numpy().items():
        np.testing.assert_array_equal(v, np.asarray(params[k]))
    _close(rec.rating_logits(uid, iid),
           jrec.rating_logits(params, jnp.asarray(uid), jnp.asarray(iid)))
    _close(rec.predict_rating(uid, iid),
           jrec.predict_rating(params, jnp.asarray(uid), jnp.asarray(iid)))
    users = np.arange(7)
    _close(rec.utilities(users), jrec.utilities(params, jnp.asarray(users)))
    np.testing.assert_array_equal(
        rec.user_covariates(users).numpy(),
        np.asarray(jrec.user_covariates(params, jnp.asarray(users))))
    assert rec.cfg.n_params == JaxCfg(n_users=N_USERS,
                                      n_items=N_ITEMS).n_params


def test_loss_gradients_and_one_adam_step_match_jax(carried):
    jrec, params, rec, batch = carried
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_loss, _), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jrec.loss(p, jbatch), has_aux=True))(params)
    loss, aux = rec.loss(batch)
    assert aux["loss"] is loss
    _close(loss, j_loss)
    names = list(PARAM_NAMES)
    grads = torch.autograd.grad(loss, [getattr(rec, k) for k in names])
    grads = dict(zip(names, grads))
    for k in names:
        _close(grads[k], j_grads[k])
    j_new, _ = jax.jit(lambda g, p: jax_adam_update(
        g, jax_adam_init(p), p, lr=0.01))(j_grads, params)
    p = {k: v.detach() for k, v in rec.params().items()}
    new, state = adam_update(grads, adam_init(p, device=CPU), p, lr=0.01)
    assert int(state.step) == 1
    for k in names:
        _close(new[k], j_new[k])


def test_dropout_scales_kept_units():
    """rating_logits with a generator: h * keep / (1 - p), keep drawn
    from the generator; p = 0 is the plain forward."""
    cfg = RecommenderConfig(n_users=4, n_items=6, dropout=0.5)
    g = torch.Generator()
    g.manual_seed(0)
    rec = PaperRecommender(cfg, gen=g, device=CPU)
    uid, iid = np.arange(4), np.arange(4)
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(1)
    g2.manual_seed(1)
    assert torch.equal(rec.rating_logits(uid, iid, gen=g1),
                       rec.rating_logits(uid, iid, gen=g2))
    assert not torch.equal(rec.rating_logits(uid, iid, gen=g1),
                           rec.rating_logits(uid, iid))
    w = dense_init(g, (40, 15))
    assert w.shape == (40, 15) and abs(float(w.std()) - 40 ** -0.5) < 0.05


def test_training_lowers_the_loss():
    g = torch.Generator()
    g.manual_seed(0)
    inter = make_interactions(g, n_users=60, n_items=80, n_obs=8000,
                              device=CPU)
    rec = PaperRecommender(RecommenderConfig(n_users=60, n_items=80),
                           gen=g, device=CPU)
    losses = rec.train({"uid": inter.uid, "iid": inter.iid,
                        "rating": inter.rating}, gen=g, epochs=3)
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    u = rec.utilities(torch.arange(4))
    assert u.shape == (4, 80) and bool(((u >= 1.0) & (u <= 5.0)).all())
    assert rec.training                          # nn.Module's mode is kept
    rec.eval()
    assert not rec.training
    with pytest.raises(ValueError, match="generator"):
        rec.train({"uid": inter.uid, "iid": inter.iid,
                   "rating": inter.rating})
