"""The port's transformer LM (repro_torch.models.transformer) against
repro.models.transformer at two SMOKE configs, llama3.2-1b (dense,
tied embeddings) and kimi-k2-1t-a32b (MoE, 8 experts top-2), on JAX's
lm_init(key(0)) carried across as numpy, in f32 on the CPU:

  * logits, aux, loss and every gradient against jax.value_and_grad;
  * one lm_train_step (clip, then Adam): bitwise-close to JAX's clip
    and Adam on the port's own gradients, and to atol lr * 1e-3 against
    JAX's whole step where the gradient is not near Adam's eps (ROADMAP
    Queue 3: the first step turns a gradient's rounding near 1e-8 into
    a share of the step);
  * prefill, and decode equal to JAX's decode step by step;
  * the three remat modes giving bitwise the same loss and gradients;
  * the MoE's dropped-assignment counts, one a layer, from the forward,
    prefill and decode;
  * a checkpoint written by either package restored by the other.

Tolerances (as measured on this CPU, stated): logits, aux, loss, the
caches and the decode logits within rtol 1e-5, atol 1e-5; gradients
within rtol 1e-4, atol 1e-6; the train step as its docstring says.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.store import CheckpointStore as JaxStore
from repro.configs import get_arch as jax_get_arch
from repro.data.batches import make_lm_batch as jax_lm_batch
from repro.models import transformer as jt
from repro.optim import adam_init as jax_adam_init
from repro.optim import adam_update as jax_adam_update
from repro.optim.clip import clip_by_global_norm as jax_clip
from repro_torch.checkpoint import CheckpointStore
from repro_torch.checkpoint.store import flatten_with_paths, unflatten_like
from repro_torch.configs import get_arch
from repro_torch.models import transformer as tt

ARCHS = ("llama3.2-1b", "kimi-k2-1t-a32b")
TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
LR = 1e-2
B, S = 2, 16


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x), tree)


def _flat_np(tree):
    return {k: np.asarray(v) for k, v in
            flatten_with_paths(_np_tree(tree)).items()}


def _close(got, want, tol=TOL, **kw):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), **tol, **kw)


@pytest.fixture(scope="module", params=ARCHS)
def carried(request):
    """(arch, JAX cfg, JAX params, port cfg, port params, a JAX batch as
    numpy)."""
    arch = request.param
    jcfg = jax_get_arch(arch).make_config(full=False)
    cfg = get_arch(arch).make_config(full=False)
    jparams = jt.lm_init(jax.random.key(0), jcfg)
    params = tt.lm_from_numpy(_np_tree(jparams), cfg, device="cpu")
    batch = _np_tree(jax_lm_batch(jax.random.key(1), batch=B, seq=S,
                                  vocab=jcfg.vocab))
    return arch, jcfg, jparams, cfg, params, batch


def test_carried_params_keep_jax_paths_and_shapes(carried):
    _, jcfg, jparams, cfg, params, _ = carried
    want = _flat_np(jparams)
    got = flatten_with_paths(params)
    assert list(got) == list(want)
    for k, v in got.items():
        assert tuple(v.shape) == want[k].shape and v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), want[k])
    assert sum(v.numel() for v in got.values()) == cfg.n_params == \
        jcfg.n_params
    back = tt.lm_state_numpy(params)
    for k, v in flatten_with_paths(back).items():
        np.testing.assert_array_equal(v, want[k])


def test_forward_and_loss_match_jax(carried):
    _, jcfg, jparams, cfg, params, batch = carried
    jlogits, jaux = jt.lm_forward(jparams, jnp.asarray(batch["tokens"]),
                                  jcfg)
    logits, aux = tt.lm_forward(params, batch["tokens"], cfg)
    assert logits.shape == (B, S, cfg.vocab)
    _close(logits, jlogits)
    _close(aux, jaux)
    if cfg.moe:
        assert float(aux) > 0
    jloss, jm = jt.lm_loss(jparams, jax.tree.map(jnp.asarray, batch), jcfg)
    loss, m = tt.lm_loss(params, batch, cfg)
    _close(loss, jloss)
    _close(m["nll"], jm["nll"])


def test_gradients_match_jax(carried):
    _, jcfg, jparams, cfg, params, batch = carried
    jb = jax.tree.map(jnp.asarray, batch)
    (jloss, _), jgrads = jax.value_and_grad(
        lambda p: jt.lm_loss(p, jb, jcfg), has_aux=True)(jparams)
    loss, _, grads = tt.lm_grads(params, batch, cfg)
    _close(loss, jloss)
    want = _flat_np(jgrads)
    got = flatten_with_paths(grads)
    assert list(got) == list(want)
    for k, g in got.items():
        _close(g, want[k], GRAD_TOL, err_msg=k)


def test_train_step_matches_jax(carried):
    """Against JAX's clip and Adam applied to the port's own gradients:
    rtol 1e-5, atol 1e-7. Against JAX's whole step: atol lr * 1e-3
    wherever JAX's clipped gradient is at least 1e-6; below that Adam's
    first step lr * g / (|g| + 1e-8) turns the gradients' rounding
    (1e-8 of their scale) into a share of the step, held to lr * 2e-2
    (measured: at most 1.07e-2 of a step, kimi's experts/w_gate at a
    clipped gradient of 3e-9)."""
    _, jcfg, jparams, cfg, params, batch = carried
    jb = jax.tree.map(jnp.asarray, batch)
    jopt0 = jax_adam_init(jparams, moment_dtype=jcfg.moment_dtype)
    jnew, jopt, jm = jt.lm_train_step(jparams, jopt0, jb, jcfg, lr=LR)
    opt = tt.lm_adam_init(params, cfg)
    new, opt, m = tt.lm_train_step(params, opt, batch, cfg, lr=LR)
    _close(m["loss"], jm["loss"])
    _close(m["grad_norm"], jm["grad_norm"], dict(rtol=1e-6, atol=0))
    assert int(opt.step) == int(jopt.step) == 1
    got = flatten_with_paths(new)
    # JAX's clip and Adam on the port's gradients
    _, _, grads = tt.lm_grads(params, batch, cfg)
    jgrads = jax.tree.map(jnp.asarray, tt.lm_state_numpy(grads))
    clipped, _ = jax_clip(jgrads, 1.0)
    own, _ = jax_adam_update(clipped, jopt0, jparams, lr=LR)
    for k, v in _flat_np(own).items():
        _close(got[k], v, dict(rtol=1e-5, atol=1e-7), err_msg=k)
    # JAX's whole step
    (_, _), jg = jax.value_and_grad(lambda p: jt.lm_loss(p, jb, jcfg),
                                    has_aux=True)(jparams)
    jg = _flat_np(jax_clip(jg, 1.0)[0])
    want = _flat_np(jnew)
    for k, p in got.items():
        diff = np.abs(p.numpy() - want[k])
        steady = np.abs(jg[k]) >= 1e-6
        assert diff[steady].max(initial=0) <= LR * 1e-3, k
        assert diff.max() <= LR * 2e-2, k
    # the inputs are left as they were
    for k, p in flatten_with_paths(params).items():
        np.testing.assert_array_equal(p.numpy(), _flat_np(jparams)[k])


def test_prefill_and_decode_match_jax(carried):
    _, jcfg, jparams, cfg, params, batch = carried
    tokens = batch["tokens"]
    P = 6
    jcache, jlast = jt.lm_prefill(jparams, jnp.asarray(tokens[:, :P]), jcfg)
    cache, last = tt.lm_prefill(params, tokens[:, :P], cfg)
    _close(last, jlast)
    _close(cache["k"], jcache["k"])
    _close(cache["v"], jcache["v"])
    jfull = jt.make_decode_cache(jcfg, B, S)
    jfull = {n: jfull[n].at[:, :, :P].set(jcache[n]) for n in ("k", "v")}
    full = tt.make_decode_cache(cfg, B, S, device="cpu")
    for n in ("k", "v"):
        full[n][:, :, :P] = cache[n]
    # a dense model's decode equals its forward; a MoE's drops depend on
    # the tokens a call routes (capacity grows with them), so its decode
    # is held to JAX's decode only
    logits_fwd = None if cfg.moe else tt.lm_forward(params, tokens, cfg)[0]
    if logits_fwd is not None:
        _close(last, logits_fwd[:, P - 1])
    for pos in range(P, S):
        jlog, jfull = jt.lm_decode_step(jparams, jfull,
                                        jnp.asarray(tokens[:, pos]),
                                        jnp.asarray(pos), jcfg)
        log, full = tt.lm_decode_step(params, full, tokens[:, pos], pos, cfg)
        assert log.dtype == torch.float32
        _close(log, jlog, err_msg=f"pos {pos}")
        if logits_fwd is not None:
            _close(log, logits_fwd[:, pos], dict(rtol=1e-4, atol=1e-4))
    _close(full["k"], jfull["k"])
    _close(full["v"], jfull["v"])


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_agree_bitwise(arch):
    """'none', 'full' and 'dots' give the same loss and gradients, bit
    for bit (recomputing a layer repeats its arithmetic)."""
    base = get_arch(arch).make_config(full=False)
    params = tt.lm_init(None, base, device="cpu")
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, base.vocab, (B, S), generator=gen)
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    runs = {}
    for remat in ("none", "full", "dots"):
        cfg = tt.LMConfig(**{**base.__dict__, "remat": remat})
        loss, _, grads = tt.lm_grads(params, batch, cfg)
        runs[remat] = (loss, flatten_with_paths(grads))
    for remat in ("full", "dots"):
        assert torch.equal(runs[remat][0], runs["none"][0])
        for k, g in runs[remat][1].items():
            assert torch.equal(g, runs["none"][1][k]), (remat, k)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_moe_drops_are_reported_per_layer(remat):
    """lm_forward's, lm_prefill's and lm_decode_step's `stats` get one
    dropped-assignment count a layer: none at a capacity factor that
    holds every assignment, some at a quarter of the default, the same
    from prefill as from the forward on the same tokens, and once a
    layer when autograd records the forward under remat (a recomputed
    layer adds nothing)."""
    base = get_arch("kimi-k2-1t-a32b").make_config(full=False)
    tokens = torch.randint(0, base.vocab, (B, S),
                           generator=torch.Generator().manual_seed(4))
    counts = {}
    for cf in (base.n_experts / base.top_k, 0.25):
        cfg = tt.LMConfig(**{**base.__dict__, "capacity_factor": cf,
                             "remat": remat})
        params = tt.lm_init(torch.Generator().manual_seed(0), cfg,
                            device="cpu")
        fwd, pre, dec = {}, {}, {}
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True) for k, v in
                      flatten_with_paths(params).items()}
            tree = unflatten_like(params, leaves)
            logits, _ = tt.lm_forward(tree, tokens, cfg, stats=fwd)
            logits.float().sum().backward()
        tt.lm_prefill(params, tokens, cfg, stats=pre)
        cache = tt.make_decode_cache(cfg, B, S + 1, device="cpu")
        tt.lm_decode_step(params, cache, tokens[:, 0], 0, cfg, stats=dec)
        assert len(fwd["moe_dropped"]) == len(dec["moe_dropped"]) \
            == cfg.n_layers
        assert [int(x) for x in pre["moe_dropped"]] == \
            [int(x) for x in fwd["moe_dropped"]]
        assert not any(int(x) for x in dec["moe_dropped"])
        counts[cf] = sum(int(x) for x in fwd["moe_dropped"])
    assert counts[base.n_experts / base.top_k] == 0 < counts[0.25]


def test_checkpoint_round_trips_across_packages(carried):
    """A JAX store's LM restores in the port bitwise, and the port's
    (after a train step) restores in JAX bitwise; bf16 leaves too."""
    arch, jcfg, jparams, cfg, params, batch = carried
    with tempfile.TemporaryDirectory() as d:
        JaxStore(d).save(1, jparams)
        got, _ = CheckpointStore(d).restore(params, step=1, device="cpu")
        for k, v in flatten_with_paths(got).items():
            np.testing.assert_array_equal(v.numpy(), _flat_np(jparams)[k])
        opt = tt.lm_adam_init(params, cfg)
        new, _, _ = tt.lm_train_step(params, opt, batch, cfg, lr=LR)
        bf = {k: v.to(torch.bfloat16) for k, v in
              flatten_with_paths(new).items()}
        CheckpointStore(d).save(2, {"f32": new, "bf16": bf})
        back, _ = JaxStore(d).restore(
            {"f32": jparams, "bf16": {k: jnp.zeros(v.shape, jnp.bfloat16)
                                      for k, v in bf.items()}}, step=2)
        jf32 = _flat_np(back["f32"])
        for k, v in flatten_with_paths(new).items():
            np.testing.assert_array_equal(jf32[k], v.numpy())
        for k, v in bf.items():
            np.testing.assert_array_equal(
                np.asarray(back["bf16"][k]).astype(np.float32),
                v.to(torch.float32).numpy())


def test_shmap_dispatch_is_refused():
    """Without a mesh context the 'shmap' dispatch is not taken: the
    layers run the global moe_apply, bitwise the 'onehot' dispatch's
    (both round the capacity to 8), as JAX's _moe_dispatching falls
    back; under a mesh whose 'model' axis divides n_experts it runs
    moe_apply_shmap (tests/test_torch_moe_shmap.py)."""
    cfg = get_arch("kimi-k2-1t-a32b").make_config(full=False)
    cfg = tt.LMConfig(**{**cfg.__dict__, "moe_dispatch": "shmap"})
    params = tt.lm_init(None, cfg, device="cpu")
    tokens = torch.zeros((1, 4), dtype=torch.long)
    got = tt.lm_forward(params, tokens, cfg)
    want = tt.lm_forward(params, tokens, tt.LMConfig(**{
        **cfg.__dict__, "moe_dispatch": "onehot"}))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_transformer_module_wraps_the_functions():
    cfg = get_arch("llama3.2-1b").make_config(full=False)
    model = tt.TransformerLM(cfg, device="cpu")
    names = {n for n, _ in model.named_parameters()}
    assert names == {k.replace("/", ".") for k in
                     flatten_with_paths(model.params())}
    tokens = torch.randint(0, cfg.vocab, (B, S),
                           generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
    logits, _ = model(tokens)
    assert torch.equal(logits, tt.lm_forward(model.params(), tokens, cfg)[0])
    opt = model.init_opt()
    losses = [float(model.train_step(opt, batch, lr=LR)[1]["loss"])]
    for _ in range(5):
        opt, m = model.train_step(opt, batch, lr=LR)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    cache = model.make_cache(B, S)
    _, last = model.prefill(tokens[:, :4])
    log, _ = model.decode_step(cache, tokens[:, 0], 0)
    assert last.shape == log.shape == (B, cfg.vocab)
    state = model.state_numpy()
    other = tt.TransformerLM(cfg, gen=torch.Generator().manual_seed(9),
                             device="cpu").load_numpy(state)
    assert torch.equal(other(tokens)[0], model(tokens)[0])
