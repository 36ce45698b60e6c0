"""The port's LM building blocks (repro_torch.models.layers) against
repro.models.layers on the same seeded numpy inputs, in f32 on the CPU:
RoPE, the GQA projections, logits and combine, dense and chunked causal
attention (Sq != Sk, the chunk skip on and off), one-token decode
attention, the SwiGLU FFN, the MoE at both capacity roundings on a batch
that overflows an expert, and the embedding.

Tolerances: expert ids and kept/dropped slots exact; every float within
rtol 1e-5, atol 1e-6 (the two packages' matmuls and transcendental
functions round apart by a few ulp), but the MoE's output: atol 1e-5,
where the routed and the shared expert's sums cancel to a few 1e-2
(measured: at most 2.2e-6 apart).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models.transformer import LMConfig as JaxLMConfig
from repro_torch.models import layers as tl
from repro_torch.models.transformer import LMConfig

TOL = dict(rtol=1e-5, atol=1e-6)
MOE_TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_head=8,
           d_ff=48, vocab=64)


def _cfgs(**kw):
    kw = {**CFG, **kw}
    return (JaxLMConfig(dtype=jnp.float32, param_dtype=jnp.float32, **kw),
            LMConfig(dtype=torch.float32, param_dtype=torch.float32, **kw))


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32).copy())


def _tree_t(tree):
    return jax.tree.map(lambda x: _t(np.asarray(x)), tree)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or TOL))


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_rope_matches_jax():
    x = _normal(0, 2, 6, 4, 8)
    _close(tl.rope_freqs(8, 500_000.0), jl.rope_freqs(8, 500_000.0))
    for pos in (np.arange(6)[None, :], np.full((2, 1), 4099),
                np.arange(1000, 1006)[None, :]):
        want = jl.apply_rope(jnp.asarray(x[:, :pos.shape[-1]]),
                             jnp.asarray(pos), 500_000.0)
        got = tl.apply_rope(_t(x[:, :pos.shape[-1]]), torch.from_numpy(pos),
                            500_000.0)
        _close(got, want)


def test_qkv_logits_and_combine_match_jax():
    jcfg, cfg = _cfgs()
    p = jl.attn_init(jax.random.key(0), jcfg)
    x = _normal(1, 2, 5, CFG["d_model"])
    pos = np.arange(5)[None, :]
    jq, jk, jv = jl._qkv(p, jnp.asarray(x), jcfg, jnp.asarray(pos))
    q, k, v = tl._qkv(_tree_t(p), _t(x), cfg, torch.from_numpy(pos))
    for got, want in ((q, jq), (k, jk), (v, jv)):
        _close(got, want)
    logits = tl._gqa_logits(q, k)
    jlogits = jl._gqa_logits(jq, jk)
    assert logits.dtype == torch.float32 and logits.shape == jlogits.shape
    _close(logits, jlogits)
    probs = _normal(2, *logits.shape)
    _close(tl._gqa_combine(_t(probs), v, torch.float32),
           jl._gqa_combine(jnp.asarray(probs), jv, jnp.float32))


def _qkv_arrays(Sq, Sk, seed=3):
    B, H, KV, Dh = 2, 4, 2, 8
    return (_normal(seed, B, Sq, H, Dh), _normal(seed + 1, B, Sk, KV, Dh),
            _normal(seed + 2, B, Sk, KV, Dh))


@pytest.mark.parametrize("Sq,Sk", [(8, 8), (4, 12), (1, 9)])
def test_dense_causal_attention_matches_jax(Sq, Sk):
    q, k, v = _qkv_arrays(Sq, Sk)
    _close(tl.dense_causal_attention(_t(q), _t(k), _t(v)),
           jl.dense_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v)))


@pytest.mark.parametrize("skip", [True, False])
@pytest.mark.parametrize("Sq,Sk,cq,ck", [(16, 16, 4, 4), (8, 16, 4, 8),
                                          (8, 24, 8, 4)])
def test_chunked_causal_attention_matches_jax(Sq, Sk, cq, ck, skip):
    q, k, v = _qkv_arrays(Sq, Sk, seed=7)
    got = tl.chunked_causal_attention(_t(q), _t(k), _t(v), chunk_q=cq,
                                      chunk_kv=ck, skip_masked_chunks=skip)
    want = jl.chunked_causal_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), chunk_q=cq,
        chunk_kv=ck, skip_masked_chunks=skip)
    _close(got, want)
    # and the dense path's answer, to the rounding of the running softmax
    _close(got, tl.dense_causal_attention(_t(q), _t(k), _t(v)),
           rtol=2e-5, atol=2e-6)


def test_chunked_attention_refuses_ragged_chunks():
    q, k, v = _qkv_arrays(6, 6)
    with pytest.raises(ValueError, match="not divisible"):
        tl.chunked_causal_attention(_t(q), _t(k), _t(v), chunk_q=4,
                                    chunk_kv=4)


@pytest.mark.parametrize("pos", [0, 5, 15])
def test_decode_attention_matches_jax(pos):
    q, k, v = _qkv_arrays(1, 16, seed=11)
    _close(tl.decode_attention(_t(q), _t(k), _t(v), pos),
           jl.decode_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), jnp.asarray(pos)))


def test_ffn_matches_jax():
    jcfg, _ = _cfgs()
    p = jl.ffn_init(jax.random.key(1), jcfg)
    x = _normal(12, 2, 5, CFG["d_model"])
    _close(tl.ffn_apply(_tree_t(p), _t(x)), jl.ffn_apply(p, jnp.asarray(x)))


@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
def test_moe_capacity_matches_jax(dispatch):
    for E, K, cf in ((4, 2, 1.25), (16, 1, 1.25), (384, 8, 1.25),
                     (8, 2, 0.25)):
        jcfg, cfg = _cfgs(moe=True, n_experts=E, top_k=K,
                          capacity_factor=cf, moe_dispatch=dispatch)
        for T in (1, 7, 64, 2048, 4099):
            assert tl.moe_capacity(T, cfg) == jl.moe_capacity(T, jcfg)


def _moe_case(dispatch, shared, seed=5):
    """E=4, top_k 2 over 320 tokens whose router favours expert 0 (an
    offset in every coordinate and a router column along it): expert 0
    overflows at both roundings (onehot C = 8, sort C = 256)."""
    jcfg, cfg = _cfgs(moe=True, n_experts=4, top_k=2, d_ff_moe=24,
                      capacity_factor=0.25, moe_dispatch=dispatch,
                      shared_expert=shared)
    p = jl.moe_init(jax.random.key(seed), jcfg)
    p["router"] = p["router"].at[:, 0].add(0.05)
    x = _normal(seed, 4, 80, CFG["d_model"]) + 1.0
    return jcfg, cfg, p, x


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
def test_moe_apply_matches_jax_on_an_overflowing_batch(dispatch, shared):
    jcfg, cfg, p, x = _moe_case(dispatch, shared)
    tp = _tree_t(p)
    xt = x.reshape(-1, CFG["d_model"])
    # the router: ids exact, gates and probabilities to rounding
    jprobs = jax.nn.softmax(jnp.asarray(xt) @ p["router"], axis=-1)
    jgates, jids = jax.lax.top_k(jprobs, jcfg.top_k)
    probs, gates, ids = tl.moe_route(tp, _t(xt), cfg)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    _close(probs, jprobs)
    _close(gates, jgates / jnp.sum(jgates, axis=-1, keepdims=True))
    # kept slots exact: the stable positions of both dispatch modes
    flat = ids.reshape(-1)
    pos = tl._positions_by_expert(flat, cfg.n_experts)
    np.testing.assert_array_equal(
        pos.numpy(), np.asarray(jl._positions_by_expert(
            jnp.asarray(flat.numpy()), cfg.n_experts)))
    C = tl.moe_capacity(xt.shape[0], cfg)
    y, aux, dropped = tl.moe_apply_with_drops(tp, _t(x), cfg)
    assert int(dropped) == int((pos >= C).sum()) > 0
    jy, jaux = jl.moe_apply(p, jnp.asarray(x), jcfg)
    _close(y, jy, **MOE_TOL)
    _close(aux, jaux)
    for got, want in zip(tl.moe_apply(tp, _t(x), cfg), (y, aux)):
        assert torch.equal(got, want)


def test_moe_route_breaks_ties_to_the_lower_expert():
    _, cfg = _cfgs(moe=True, n_experts=4, top_k=2)
    p = {"router": torch.zeros((CFG["d_model"], 4))}
    _, gates, ids = tl.moe_route(p, torch.ones((3, CFG["d_model"])), cfg)
    assert ids.tolist() == [[0, 1]] * 3
    _close(gates, np.full((3, 2), 0.5, np.float32))


def test_embed_lookup_matches_jax():
    table = _normal(13, 10, 6)
    ids = np.array([[0, 9, 3], [3, 3, 1]], np.int32)
    _close(tl.embed_lookup(_t(table), torch.from_numpy(ids)),
           jl.embed_lookup(jnp.asarray(table), jnp.asarray(ids)))
    gen = torch.Generator().manual_seed(0)
    e = tl.embed_init(gen, 1000, 16, torch.bfloat16)
    assert e.dtype == torch.bfloat16 and e.shape == (1000, 16)
    assert abs(float(e.float().std()) - 0.02) < 2e-3
