"""The LM half of the zoo's configs, optimisers and batches against the
JAX package's:

  * the five LM archs: FULL and SMOKE configs field for field (dtypes by
    name), cells, notes and variants equal to repro.configs'; n_params
    and active_params_per_token equal;
  * FULL parameter trees: lm_init(..., device="meta") gives the paths,
    shapes and dtypes of jax.eval_shape(lm_init) and allocates nothing
    (no FULL parameters are materialised here, on any device);
  * the three schedules and Adafactor (factored and dense leaves, three
    steps, bf16 and f32 first moments) against repro.optim at rtol 1e-6;
    state_bytes equal;
  * make_lm_batch's bigram recurrence on JAX's own draws, exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jax_get_arch
from repro.data.batches import make_lm_batch as jax_lm_batch
from repro.models.transformer import lm_init as jax_lm_init
from repro.optim import adafactor as jada
from repro.optim import schedules as jsched
from repro_torch.checkpoint.store import flatten_with_paths
from repro_torch.configs import get_arch
from repro_torch.configs.lm_family import LM_CELLS, LM_SMOKE_CELLS, build_lm
from repro_torch.data import lm_bigram_batch, make_lm_batch
from repro_torch.models.transformer import LMConfig, lm_init
from repro_torch.optim import adafactor as tada
from repro_torch.optim import schedules as tsched

LM_ARCHS = ("llama3.2-1b", "mistral-nemo-12b", "phi3-medium-14b",
            "llama4-scout-17b-a16e", "kimi-k2-1t-a32b")
FIELDS = [f for f in LMConfig.__dataclass_fields__]


def _dtype_name(d) -> str:
    if isinstance(d, torch.dtype):
        return str(d).removeprefix("torch.")
    return jnp.dtype(d).name


def _assert_same_config(cfg, jcfg):
    for f in FIELDS:
        got, want = getattr(cfg, f), getattr(jcfg, f)
        if f in ("dtype", "param_dtype", "moment_dtype"):
            assert _dtype_name(got) == _dtype_name(want), f
        else:
            assert got == want, f
    assert set(FIELDS) == set(jcfg.__dataclass_fields__)
    assert cfg.n_params == jcfg.n_params
    assert cfg.params_per_layer == jcfg.params_per_layer
    assert cfg.active_params_per_token == jcfg.active_params_per_token


def _cells(cells):
    return [(c.name, c.kind, dict(c.params)) for c in cells]


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_configs_match_jax(arch):
    spec, jspec = get_arch(arch), jax_get_arch(arch)
    assert spec.family == jspec.family == "lm"
    assert spec.build is build_lm
    assert spec.notes == jspec.notes
    assert _cells(spec.cells) == _cells(jspec.cells)
    for full in (True, False):
        _assert_same_config(spec.make_config(full), jspec.make_config(full))
    assert sorted(spec.variants) == sorted(jspec.variants)
    for name, make in spec.variants.items():
        _assert_same_config(make(), jspec.variants[name]())


def test_lm_cells_match_jax():
    from repro.configs import lm_family as jfam

    assert _cells(LM_CELLS) == _cells(jfam.LM_CELLS)
    assert _cells(LM_SMOKE_CELLS) == _cells(jfam.LM_SMOKE_CELLS)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_full_parameter_shapes_match_jax_without_materialising(arch):
    cfg = get_arch(arch).make_config(full=True)
    jcfg = jax_get_arch(arch).make_config(full=True)
    want = jax.eval_shape(lambda k: jax_lm_init(k, jcfg), jax.random.key(0))
    want = {k: v for k, v in flatten_with_paths(want).items()}
    got = flatten_with_paths(lm_init(None, cfg, device="meta"))
    assert list(got) == list(want)
    for k, v in got.items():
        assert v.device.type == "meta", k
        assert tuple(v.shape) == tuple(want[k].shape), k
        assert _dtype_name(v.dtype) == _dtype_name(want[k].dtype), k
    assert sum(v.numel() for v in got.values()) == cfg.n_params


@pytest.mark.parametrize("step", [0, 1, 7, 50, 99, 100, 250])
def test_schedules_match_jax(step):
    pairs = [(tsched.constant_schedule(3e-4), jsched.constant_schedule(3e-4)),
             (tsched.cosine_schedule(1e-3, 100),
              jsched.cosine_schedule(1e-3, 100)),
             (tsched.cosine_schedule(1e-3, 0, final_frac=0.2),
              jsched.cosine_schedule(1e-3, 0, final_frac=0.2)),
             (tsched.linear_warmup_cosine(2e-3, 10, 200),
              jsched.linear_warmup_cosine(2e-3, 10, 200))]
    for f, jf in pairs:
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = f(s)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jf(jnp.asarray(step, jnp.int32))),
                rtol=1e-6)


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(6, 5)).astype(np.float32),
            "stack": rng.normal(size=(2, 3, 4)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "s": np.float32(rng.normal())}


@pytest.mark.parametrize("moment_dtype", ["bfloat16", "float32"])
def test_adafactor_matches_jax(moment_dtype):
    params = _opt_tree(0)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tada.adafactor_init(tp, moment_dtype=getattr(torch, moment_dtype),
                                device="cpu")
    jstate = jada.adafactor_init(jp, moment_dtype=getattr(jnp, moment_dtype))
    for k in params:
        assert tuple(state.nu_row[k].shape) == jstate.nu_row[k].shape
        assert tuple(state.nu_col[k].shape) == jstate.nu_col[k].shape
    for step in range(3):
        g = _opt_tree(10 + step)
        tp, state = tada.adafactor_update(
            {k: torch.tensor(v) for k, v in g.items()}, state, tp, lr=1e-2)
        jp, jstate = jada.adafactor_update(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, jp, lr=1e-2)
        assert int(state.step) == int(jstate.step) == step + 1
        for k in params:
            for got, want in ((tp[k], jp[k]), (state.mu[k], jstate.mu[k]),
                              (state.nu_row[k], jstate.nu_row[k]),
                              (state.nu_col[k], jstate.nu_col[k])):
                assert _dtype_name(got.dtype) == _dtype_name(want.dtype)
                np.testing.assert_allclose(
                    got.to(torch.float32).numpy(),
                    np.asarray(want).astype(np.float32), rtol=1e-6,
                    atol=1e-7, err_msg=f"{k} step {step}")


def test_state_bytes_match_jax():
    params = _opt_tree(1)
    for factored in (True, False):
        assert tada.state_bytes({k: torch.tensor(v) for k, v in
                                 params.items()}, factored=factored) == \
            jada.state_bytes({k: jnp.asarray(v) for k, v in params.items()},
                             factored=factored)
    # the 1T config's fit math, from meta tensors
    cfg = get_arch("kimi-k2-1t-a32b").make_config(full=True)
    meta = flatten_with_paths(lm_init(None, cfg, device="meta"))
    dense = tada.state_bytes(meta, factored=False)
    assert dense == cfg.n_params * 6
    assert tada.state_bytes(meta, factored=True) < dense // 2


@pytest.mark.parametrize("seed,batch,seq,vocab", [(0, 4, 32, 256),
                                                  (3, 2, 17, 128256),
                                                  (5, 1, 1, 7)])
def test_lm_batch_recurrence_on_jax_draws(seed, batch, seq, vocab):
    """JAX's make_lm_batch draws (first, noise) from split(key), then
    runs the recurrence: the port's recurrence on those draws gives its
    tokens and labels exactly."""
    key = jax.random.key(seed)
    k1, k2 = jax.random.split(key)
    first = np.asarray(jax.random.randint(k1, (batch, 1), 0, vocab))
    noise = np.asarray(jax.random.randint(k2, (batch, seq), 0, 7))
    want = jax_lm_batch(key, batch=batch, seq=seq, vocab=vocab)
    got = lm_bigram_batch(first, noise, vocab)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_make_lm_batch_layout():
    gen = torch.Generator().manual_seed(0)
    b = make_lm_batch(gen, batch=3, seq=20, vocab=50, device="cpu")
    tok, lab = b["tokens"].long(), b["labels"].long()
    assert tok.shape == lab.shape == (3, 20) and b["tokens"].dtype == \
        torch.int32
    assert int(tok.min()) >= 0 and int(tok.max()) < 50
    np.testing.assert_array_equal(lab[:, :-1].numpy(), tok[:, 1:].numpy())
    step = (lab - 3 * tok) % 50
    assert int(step.min()) >= 0 and int(step.max()) < 7
    again = make_lm_batch(torch.Generator().manual_seed(0), batch=3, seq=20,
                          vocab=50, device="cpu")
    assert torch.equal(again["tokens"], b["tokens"])
