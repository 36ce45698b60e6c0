"""The port's Adam (repro_torch.optim) held against repro.optim's
adam_update: 50 steps on the same parameters and gradients (numpy, from
a seed), with f32 and bf16 moments and with weight decay.

The JAX update runs eagerly, op by op, as the reference of the
function itself: under jit XLA contracts m*b1 + (1-b1)*g into fused
multiply-adds, an ulp apart from any order of rounded operations, and
with bf16 moments such an ulp can flip a rounding that then compounds.
Eagerly the moments agree bitwise and a few parameters by an ulp.

Tolerances: parameters rtol=1e-6, atol=1e-7; moments (f32 or bf16)
bitwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adam_init as jax_adam_init
from repro.optim import adam_update as jax_adam_update
from repro_torch.optim import AdamState, adam_init, adam_update

RTOL, ATOL = 1e-6, 1e-7
SHAPES = {"w": (40, 15), "b": (15,), "emb": (200, 20)}


@pytest.mark.parametrize("moments,weight_decay,lr", [
    ("f32", 0.0, 0.01), ("bf16", 0.0, 0.01), ("f32", 0.01, 0.003)])
def test_adam_matches_jax_over_50_steps(moments, weight_decay, lr):
    rng = np.random.default_rng(len(moments) + int(weight_decay * 100))
    p0 = {k: rng.normal(size=s).astype(np.float32)
          for k, s in SHAPES.items()}
    grads = [{k: (rng.normal(size=s) * rng.uniform(0.01, 3.0)).astype(
        np.float32) for k, s in SHAPES.items()} for _ in range(50)]
    j_dt = jnp.bfloat16 if moments == "bf16" else jnp.float32
    t_dt = torch.bfloat16 if moments == "bf16" else torch.float32
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.tensor(v) for k, v in p0.items()}
    jo = jax_adam_init(jp, moment_dtype=j_dt)
    to = adam_init(tp, moment_dtype=t_dt, device="cpu")
    for g in grads:
        jp, jo = jax_adam_update({k: jnp.asarray(v) for k, v in g.items()},
                                 jo, jp, lr=lr, weight_decay=weight_decay)
        tp, to = adam_update({k: torch.tensor(v) for k, v in g.items()}, to,
                             tp, lr=lr, weight_decay=weight_decay)
    assert isinstance(to, AdamState) and int(to.step) == int(jo.step) == 50
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=RTOL, atol=ATOL)
        for got, want in ((to.mu[k], jo.mu[k]), (to.nu[k], jo.nu[k])):
            assert got.dtype == t_dt
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_adam_update_leaves_its_inputs():
    """adam_update returns new parameters and a new state; the tensors
    it was given keep their values."""
    rng = np.random.default_rng(3)
    p = {"w": torch.tensor(rng.normal(size=(20, 5)).astype(np.float32))}
    state = adam_init(p, device="cpu")
    keep = [p["w"].clone(), state.mu["w"].clone(), state.nu["w"].clone()]
    g = {"w": torch.tensor(rng.normal(size=(20, 5)).astype(np.float32))}
    new, new_state = adam_update(g, state, p, lr=0.01)
    for t, k in zip((p["w"], state.mu["w"], state.nu["w"]), keep):
        assert torch.equal(t, k)
    assert not torch.equal(new["w"], p["w"]) and int(state.step) == 0
    assert int(new_state.step) == 1


def test_adam_init_defaults_to_the_card_and_checks_placement():
    p = {"w": torch.zeros(3)}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            adam_init(p)
    with pytest.raises(ValueError, match="lies on"):
        adam_init({"w": torch.zeros(3, device="meta")}, device="cpu")
