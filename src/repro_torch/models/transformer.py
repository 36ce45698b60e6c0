"""Decoder-only transformer LM family, dense and MoE (counterpart of
repro.models.transformer).

One parameterization, the JAX module's entry points: `lm_forward` and
`lm_loss`, `lm_train_step` (gradients, clip at global norm, Adam),
`lm_prefill` (the KV cache of a prompt and its last logits) and
`lm_decode_step` (one token against a cache of fixed length).

Parameters are a nested dict of tensors with JAX's paths and shapes:
the layer leaves are stacked on a leading L (JAX's scan convention), so
checkpoint/store.py round-trips an LM between the packages and
`lm_from_numpy` / `lm_state_numpy` carry a JAX `lm_init` tree across.
The layers run in a Python loop over L. `remat` picks what a layer's
backward keeps: "full" recomputes each layer
(torch.utils.checkpoint, non-reentrant), "dots" keeps the outputs of
the plain matmuls (batched ones are recomputed, as JAX's
dots_with_no_batch_dims_saveable does), "none" keeps everything. Remat
changes memory, never numbers.

A decode step writes the new token's k and v into the cache in place
(JAX returns a new cache; its decode cell donates the old one).
`lm_logical_axes` and `cache_logical_axes` mirror the parameter and
cache trees with per-dim logical axis names (distributed/sharding.py:
FSDP over 'data', TP/EP over 'model', DP over ('pod', 'data')). The
'shmap' MoE dispatch runs layers.moe_apply_shmap when a mesh context is
active and its 'model' axis divides n_experts, and the global dispatch
otherwise, as JAX's _moe_dispatching chooses.

Under a mesh context a dense config's entry points run partitioned
(`lm_plan`), where JAX's jit partitions the annotated program: one
shard body a mesh position, in lockstep (distributed.topk's
each_position and the collectives over each position's group). Every
parameter is laid by its spec (`launch.mesh.shard`, or a Sharded laid
so); each layer all-gathers its leaves' FSDP blocks over 'data', makes
q, k and v column-parallel by heads behind `copy_to_shards` (a KV head
split 'model' does not divide is gathered whole over 'model' and query
head h reads KV head h // G), and sums the row-parallel wo and w_down
over 'model' with `reduce_from_shards`. Heads 'model' does not divide
split the dense path's query rows over 'model' (JAX's seq_attn) or
replicate the chunked path's attention (as GSPMD does). The embedding
and the head are vocab-parallel; the loss takes the log-sum-exp's max
over 'model' with no gradient, the sum of exp and the label logit
summed over 'model', each batch block's sum over the global token
count summed over the batch blocks. Every position's loss seeds its
own backward; an FSDP gather's backward reduce-scatters over 'data'
where the batch is split there and takes one copy's gradient where it
is replicated, and a sum over the other batch axes follows. The train
step clips at the norm of each distinct block once and steps Adam on
each position's blocks: the new parameters and moments are Sharded.
Prefill keeps each position's sequence rows of every KV head (the
cache laid by cache_logical_axes); decode writes the new token into the
block that holds pos and merges the blocks' f32 max, sum of exp and
weighted values. A layer's remat is the reentrant checkpoint
(`_remat_layer`). The global code runs without a context, for an MoE
config, where a parameter's spec would be relaxed, or where the mesh
splits nothing.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.checkpoint.store import flatten_with_paths, unflatten_like
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    current_mesh,
    current_rules,
    drop_nondivisible,
    logical_shard,
    param_shardings,
    tree_map,
)
from repro_torch.distributed.topk import (
    all_gather_dim,
    assemble,
    copy_to_shards,
    each_position,
    max_over_shards,
    one_body_active,
    position_blocks,
    positions,
    reduce_from_shards,
    sum_over_shards,
)
from repro_torch.launch.mesh import (
    Sharded,
    axis_size,
    block_of,
    place,
    spec_entries,
)
from repro_torch.models.layers import (
    _qkv,
    apply_rope,
    attn_axes,
    attn_init,
    chunked_causal_attention,
    decode_attention,
    decode_attention_partial,
    dense_causal_attention,
    dense_init,
    embed_init,
    embed_lookup,
    ffn_apply,
    ffn_axes,
    ffn_init,
    moe_apply_shmap_with_drops,
    moe_apply_with_drops,
    moe_axes,
    moe_init,
    rms_norm,
    vocab_block_lookup,
)
from repro_torch.models.recsys import _register, _tree_of
from repro_torch.optim import (
    AdamState,
    adam_init,
    adam_update,
    clip_by_global_norm,
)


@dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    d_head: int = 64
    d_ff: int = 512
    vocab: int = 1024
    # MoE
    moe: bool = False
    n_experts: int = 8
    top_k: int = 2
    d_ff_moe: int = 256
    shared_expert: bool = False
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    # 'onehot' and 'sort' give the same positions (a stable sort) and
    # differ in capacity rounding; 'shmap' is the expert-parallel
    # layers.moe_apply_shmap under a mesh context
    moe_dispatch: str = "onehot"
    # numerics / execution
    rope_theta: float = 500_000.0
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.bfloat16
    remat: str = "full"            # 'none' | 'full' | 'dots'
    attn_chunk_q: int = 512
    attn_chunk_kv: int = 512
    attn_skip_masked: bool = True
    dense_attn_threshold: int = 1024   # S <= this -> dense attention
    tie_embeddings: bool = False
    moment_dtype: Any = torch.float32

    @property
    def params_per_layer(self) -> int:
        D, H, KV, Dh = self.d_model, self.n_heads, self.n_kv_heads, self.d_head
        attn = D * H * Dh + 2 * D * KV * Dh + H * Dh * D
        if self.moe:
            ffn = self.n_experts * 3 * D * self.d_ff_moe + D * self.n_experts
            if self.shared_expert:
                ffn += 3 * D * self.d_ff_moe
        else:
            ffn = 3 * D * self.d_ff
        return attn + ffn + 2 * D

    @property
    def n_params(self) -> int:
        embed = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * self.params_per_layer + embed + self.d_model

    @property
    def active_params_per_token(self) -> int:
        """N_active for MODEL_FLOPS = 6 * N_active * D_tokens."""
        D, H, KV, Dh = self.d_model, self.n_heads, self.n_kv_heads, self.d_head
        attn = D * H * Dh + 2 * D * KV * Dh + H * Dh * D
        if self.moe:
            ffn = self.top_k * 3 * D * self.d_ff_moe
            if self.shared_expert:
                ffn += 3 * D * self.d_ff_moe
        else:
            ffn = 3 * D * self.d_ff
        layer = attn + ffn
        embed = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return self.n_layers * layer + embed


def _device_of(device) -> torch.device:
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------

def _layer_init(gen, cfg: LMConfig, dev) -> dict:
    p = {
        "ln1": torch.zeros((cfg.d_model,), dtype=cfg.param_dtype, device=dev),
        "ln2": torch.zeros((cfg.d_model,), dtype=cfg.param_dtype, device=dev),
        "attn": attn_init(gen, cfg, device=dev),
    }
    if cfg.moe:
        p["moe"] = moe_init(gen, cfg, device=dev)
    else:
        p["ffn"] = ffn_init(gen, cfg, device=dev)
    return p


def lm_init(gen: torch.Generator | None, cfg: LMConfig, *,
            device=None) -> dict:
    """The parameter tree on `device` (None = the card; "meta" gives
    shapes and dtypes and allocates nothing), drawn from `gen` (on the
    device; a generator there seeded 0 if None) in JAX's layout and
    scales: each layer leaf stacked on a leading L. torch cannot
    reproduce jax.random, so the values match JAX's in distribution
    only; lm_from_numpy carries JAX's own across."""
    dev = _device_of(device)
    if dev.type != "meta" and gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    layers = [_layer_init(gen, cfg, dev) for _ in range(cfg.n_layers)]
    flat = [flatten_with_paths(lay) for lay in layers]
    stacked = unflatten_like(layers[0], {
        k: torch.stack([f[k] for f in flat]) for k in flat[0]})
    params = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, cfg.param_dtype,
                            device=dev),
        "layers": stacked,
        "final_ln": torch.zeros((cfg.d_model,), dtype=cfg.param_dtype,
                                device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, (cfg.d_model, cfg.vocab),
                                       cfg.param_dtype, device=dev)
    return params


def lm_logical_axes(cfg: LMConfig) -> dict:
    """The parameter tree's logical axes: a tuple per leaf, one name (or
    None) per dim, the stacked layer leaves led by 'layers'."""
    L = "layers"
    layer_axes = {
        "ln1": (L, "norm"),
        "ln2": (L, "norm"),
        "attn": {k: (L,) + v for k, v in attn_axes().items()},
    }
    if cfg.moe:
        layer_axes["moe"] = tree_map(lambda v: (L,) + v, moe_axes(cfg),
                                     is_leaf=lambda x: isinstance(x, tuple))
    else:
        layer_axes["ffn"] = {k: (L,) + v for k, v in ffn_axes().items()}
    axes = {
        "embed": ("vocab", "embed_fsdp"),
        "layers": layer_axes,
        "final_ln": ("norm",),
    }
    if not cfg.tie_embeddings:
        axes["lm_head"] = ("embed_fsdp", "vocab")
    return axes


def lm_from_numpy(tree, cfg: LMConfig, *, device=None) -> dict:
    """A JAX `lm_init` tree (numpy arrays; bf16 ones as ml_dtypes'
    bfloat16 or as float32 values) as the port's parameters, each leaf
    in the config's dtype of its JAX counterpart."""
    dev = resolve_device(device)
    like = lm_init(None, cfg, device="meta")
    src, ref = flatten_with_paths(tree), flatten_with_paths(like)
    if set(src) != set(ref):
        raise ValueError(f"parameter paths differ: "
                         f"{sorted(set(src) ^ set(ref))}")
    out = {}
    for k, r in ref.items():
        a = np.asarray(src[k])
        if tuple(a.shape) != tuple(r.shape):
            raise ValueError(f"{k}: {tuple(a.shape)} != {tuple(r.shape)}")
        out[k] = torch.from_numpy(a.astype(np.float32)).to(
            device=dev, dtype=r.dtype)
    return unflatten_like(like, out)


def lm_state_numpy(params: dict) -> dict:
    """The parameter tree as numpy float32 arrays (bf16 leaves widened,
    exactly), in JAX's paths."""
    flat = flatten_with_paths(params)
    return unflatten_like(params, {
        k: v.detach().to(torch.float32).cpu().numpy() for k, v in
        flat.items()})


# --------------------------------------------------------------------------
# Forward
# --------------------------------------------------------------------------

def _layer(params: dict, i: int) -> dict:
    """Layer i's parameters out of the stacked tree."""
    flat = flatten_with_paths(params["layers"])
    return unflatten_like(params["layers"], {k: v[i] for k, v in
                                             flat.items()})


def _attention_fwd(p_attn, x, cfg: LMConfig, positions):
    B, S, _ = x.shape
    H, Dh = cfg.n_heads, cfg.d_head
    q, k, v = _qkv(p_attn, x, cfg, positions)
    if S <= cfg.dense_attn_threshold:
        out = dense_causal_attention(q, k, v)
    else:
        out = chunked_causal_attention(
            q, k, v, chunk_q=min(cfg.attn_chunk_q, S),
            chunk_kv=min(cfg.attn_chunk_kv, S),
            skip_masked_chunks=cfg.attn_skip_masked)
    out = out.reshape(B, S, H * Dh)
    return out @ p_attn["wo"].to(x.dtype), (k, v)


def _moe_dispatching(p_moe, hn, cfg: LMConfig):
    """The MoE's execution path: 'shmap' needs an active mesh whose
    'model' axis divides n_experts (layers.moe_apply_shmap); otherwise
    the global dispatch. (out, aux loss, assignments dropped)."""
    if cfg.moe_dispatch == "shmap":
        mesh = current_mesh()
        ep = mesh.shape.get("model", 1) if mesh is not None else 1
        if mesh is not None and cfg.n_experts % ep == 0:
            return moe_apply_shmap_with_drops(p_moe, hn, cfg, mesh)
    return moe_apply_with_drops(p_moe, hn, cfg)


def _mlp(p, hn, cfg: LMConfig):
    """The layer's MoE or FFN on hn: (out, aux loss, assignments dropped
    over capacity)."""
    if cfg.moe:
        return _moe_dispatching(p["moe"], hn, cfg)
    zero = torch.zeros((), device=hn.device)
    return ffn_apply(p["ffn"], hn), zero, zero.long()


def _layer_fwd(p, x, cfg: LMConfig, positions):
    h, kv = _attention_fwd(p["attn"], rms_norm(x, p["ln1"]), cfg, positions)
    x = logical_shard(x + h, "batch", "seq", "embed")
    h2, aux, dropped = _mlp(p, rms_norm(x, p["ln2"]), cfg)
    return logical_shard(x + h2, "batch", "seq", "embed"), aux, kv, dropped


def _record(stats, dropped):
    """Each layer's dropped assignments into stats['moe_dropped']."""
    if stats is not None:
        stats.setdefault("moe_dropped", []).extend(dropped)


# the matmuls "dots" keeps: plain 2-D products (batched ones recompute)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    if op in _DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _run_layer(fn, cfg: LMConfig, *args):
    """fn(*args) under the config's remat: recomputed in the backward
    only when autograd records it."""
    if cfg.remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {cfg.remat!r}")
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if cfg.remat == "dots":
        return ckpt.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=lambda: ckpt.create_selective_checkpoint_contexts(
                _dots_policy))
    return ckpt.checkpoint(fn, *args, use_reentrant=False)


def _embed(params, tokens, cfg: LMConfig):
    return embed_lookup(params["embed"], tokens).to(cfg.dtype)


def _head(params, x, cfg: LMConfig):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head.to(x.dtype)


def _tokens(tokens, dev) -> torch.Tensor:
    if isinstance(tokens, np.ndarray) and not tokens.flags.writeable:
        tokens = tokens.copy()       # torch refuses to view read-only memory
    return torch.as_tensor(tokens, device=dev).long()


def _param_device(params) -> torch.device:
    return params["embed"].device


def lm_forward(params: dict, tokens, cfg: LMConfig, *, stats=None):
    """tokens (B, S) -> (logits (B, S, V) in cfg.dtype, aux loss: the
    layers' load-balance losses summed, f32). A dict `stats` gets
    'moe_dropped', each layer's assignments dropped over capacity (0-d
    tensors; 0 for a dense layer)."""
    plan = lm_plan(cfg, _shape_of(tokens)[0])
    if plan is not None:
        return _partitioned_forward(plan, params, tokens, cfg, stats)
    tokens = _tokens(tokens, _param_device(params))
    S = tokens.shape[1]
    x = logical_shard(_embed(params, tokens, cfg), "batch", "seq", "embed")
    positions = torch.arange(S, device=x.device)[None, :]

    def body(x, p):
        y, aux, _, dropped = _layer_fwd(p, x, cfg, positions)
        return y, aux, dropped

    auxes, drops = [], []
    for i in range(cfg.n_layers):
        x, aux, dropped = _run_layer(body, cfg, x, _layer(params, i))
        auxes.append(aux)
        drops.append(dropped)
    _record(stats, drops)
    x = rms_norm(x, params["final_ln"])
    logits = logical_shard(_head(params, x, cfg), "batch", "seq", "vocab")
    return logits, torch.stack(auxes).sum()


def lm_loss(params: dict, batch: dict, cfg: LMConfig):
    """batch {'tokens', 'labels': (B, S)} -> (loss, {'nll', 'aux'}):
    the mean of log-sum-exp minus the label logit, taken as JAX takes it
    (a masked sum over the vocab axis), plus aux_loss_weight x aux.
    Under a plan (lm_plan) the loss is the partitioned program's value,
    every position's its own copy; lm_grads takes its gradients."""
    plan = lm_plan(cfg, _shape_of(batch["tokens"])[0])
    if plan is not None:
        dev0 = plan.devices[0]
        loss, nll, aux = _loss_part(
            plan, cfg, _param_blocks(plan, params),
            _batch_blocks(plan, batch["tokens"]),
            _batch_blocks(plan, batch["labels"]),
            math.prod(_shape_of(batch["tokens"])))
        return place(loss[0], dev0), {"nll": place(nll[0], dev0),
                                      "aux": place(aux[0], dev0)}
    logits, aux = lm_forward(params, batch["tokens"], cfg)
    logits = logits.to(torch.float32)
    labels = _tokens(batch["labels"], logits.device)
    m = logits.amax(dim=-1, keepdim=True)
    lse = m[..., 0] + torch.log(torch.exp(logits - m).sum(dim=-1))
    vocab_iota = torch.arange(logits.shape[-1], device=logits.device)
    label_mask = vocab_iota == labels[..., None]
    label_logit = torch.where(label_mask, logits,
                              torch.zeros((), device=logits.device)).sum(-1)
    nll = (lse - label_logit).mean()
    loss = nll + cfg.aux_loss_weight * aux
    return loss, {"nll": nll, "aux": aux}


# --------------------------------------------------------------------------
# Train step
# --------------------------------------------------------------------------

def lm_adam_init(params: dict, cfg: LMConfig):
    """Adam's zero state over the flattened tree, moments in
    cfg.moment_dtype (JAX's adam_init(params, moment_dtype=...))."""
    flat = flatten_with_paths(params)
    return adam_init({k: p.detach() for k, p in flat.items()},
                     moment_dtype=cfg.moment_dtype,
                     device=_param_device(params))


def lm_grads(params: dict, batch: dict, cfg: LMConfig):
    """(loss, metrics, gradient tree), the gradients in each leaf's
    dtype, as jax.value_and_grad gives them; under a plan (lm_plan)
    each gradient a Sharded laid by its parameter's spec."""
    plan = lm_plan(cfg, _shape_of(batch["tokens"])[0])
    if plan is not None:
        loss, metrics, grads = _partitioned_grads(plan, cfg, params, batch)
        shapes = _shapes(cfg)
        return loss, metrics, unflatten_like(params, {
            k: assemble(plan.mesh, g, plan.specs[k], shapes[k])
            for k, g in grads.items()})
    flat = flatten_with_paths(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    with torch.enable_grad():
        loss, metrics = lm_loss(unflatten_like(params, leaves), batch, cfg)
        g = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    g = {k: torch.zeros_like(v) if gk is None else gk
         for (k, v), gk in zip(leaves.items(), g)}
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, unflatten_like(params, g)


def lm_train_step(params: dict, opt_state, batch: dict, cfg: LMConfig, *,
                  lr: float = 3e-4, clip_norm: float = 1.0):
    """Gradients, clip at `clip_norm`, one Adam step: returns (new
    params, new opt state, {'nll', 'aux', 'loss', 'grad_norm'}). The
    inputs are left as they are. Under a plan (lm_plan) a leaf of
    `params` or of the moments may be a tensor or a Sharded laid by its
    spec, and the new ones are Sharded (`.gather()` gives the whole)."""
    plan = lm_plan(cfg, _shape_of(batch["tokens"])[0])
    if plan is not None:
        return _partitioned_train_step(plan, params, opt_state, batch, cfg,
                                       lr, clip_norm)
    loss, metrics, grads = lm_grads(params, batch, cfg)
    grads, gnorm = clip_by_global_norm(grads, clip_norm)
    flat = flatten_with_paths(params)
    new, opt_state = adam_update(
        flatten_with_paths(grads), opt_state,
        {k: p.detach() for k, p in flat.items()}, lr=lr)
    return unflatten_like(params, new), opt_state, dict(
        metrics, loss=loss, grad_norm=gnorm)


# --------------------------------------------------------------------------
# Inference: prefill + decode
# --------------------------------------------------------------------------

@torch.no_grad()
def lm_prefill(params: dict, tokens, cfg: LMConfig, *, stats=None):
    """The KV cache of a prompt: ({'k', 'v': (L, B, S, KV, Dh)},
    last-token logits (B, V) f32); `stats` as lm_forward's. Under a plan
    (lm_plan) the cache comes laid by cache_logical_axes and the logits
    by ('batch', 'vocab'), each a Sharded."""
    plan = lm_plan(cfg, _shape_of(tokens)[0])
    if plan is not None:
        _record(stats, [torch.zeros((), dtype=torch.long,
                                    device=plan.devices[0])] * cfg.n_layers)
        return _partitioned_prefill(plan, params, tokens, cfg)
    tokens = _tokens(tokens, _param_device(params))
    S = tokens.shape[1]
    x = logical_shard(_embed(params, tokens, cfg), "batch", "seq", "embed")
    positions = torch.arange(S, device=x.device)[None, :]
    ks, vs, drops = [], [], []
    for i in range(cfg.n_layers):
        x, _, (k, v), dropped = _layer_fwd(_layer(params, i), x, cfg,
                                           positions)
        ks.append(logical_shard(k, "kv_batch", "seq_shard", None, None))
        vs.append(logical_shard(v, "kv_batch", "seq_shard", None, None))
        drops.append(dropped)
    _record(stats, drops)
    x_last = rms_norm(x[:, -1, :], params["final_ln"])
    logits = _head(params, x_last, cfg).to(torch.float32)
    return {"k": torch.stack(ks), "v": torch.stack(vs)}, logits


def make_decode_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None,
                      device=None) -> dict:
    """Zero caches {'k', 'v': (L, batch, max_seq, KV, Dh)} on `device`
    (None = the card; "meta" gives shapes only)."""
    dev = _device_of(device)
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def cache_logical_axes(cfg: LMConfig) -> dict:
    return {
        "k": ("layers", "kv_batch", "seq_shard", None, None),
        "v": ("layers", "kv_batch", "seq_shard", None, None),
    }


@torch.no_grad()
def lm_decode_step(params: dict, cache: dict, token, pos: int,
                   cfg: LMConfig, *, stats=None):
    """One decode step: token (B,), pos the cache index it is written at
    (positions <= pos are attended after the write). Writes the cache in
    place and returns (logits (B, V) f32, the cache); `stats` as
    lm_forward's. Under a plan (lm_plan) the cache (tensors or Sharded)
    is laid by cache_logical_axes, the block that holds pos is written
    in place, and the logits and the cache come back Sharded."""
    pos = int(pos)
    plan = lm_plan(cfg, _shape_of(token)[0])
    if plan is not None:
        _record(stats, [torch.zeros((), dtype=torch.long,
                                    device=plan.devices[0])] * cfg.n_layers)
        return _partitioned_decode(plan, params, cache, token, pos, cfg)
    token = _tokens(token, _param_device(params))
    B = token.shape[0]
    x = _embed(params, token, cfg)[:, None, :]
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    H, Dh = cfg.n_heads, cfg.d_head
    drops = []
    for i in range(cfg.n_layers):
        p = _layer(params, i)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        q, k, v = _qkv(p["attn"], rms_norm(x, p["ln1"]), cfg, positions)
        k_cache[:, pos:pos + 1] = k.to(k_cache.dtype)
        v_cache[:, pos:pos + 1] = v.to(v_cache.dtype)
        att = decode_attention(q, k_cache, v_cache, pos)
        x = x + att.reshape(B, 1, H * Dh) @ p["attn"]["wo"].to(x.dtype)
        h2, _, dropped = _mlp(p, rms_norm(x, p["ln2"]), cfg)
        drops.append(dropped)
        x = x + h2
    _record(stats, drops)
    x_last = rms_norm(x[:, 0, :], params["final_ln"])
    return _head(params, x_last, cfg).to(torch.float32), cache


# --------------------------------------------------------------------------
# The partitioned program: one shard body a mesh position
# --------------------------------------------------------------------------

@dataclass(frozen=True, eq=False)
class LMPlan:
    """How a dense LM's program splits over the active mesh: every
    parameter leaf by its spec (lm_logical_axes under the rules, none
    relaxed), the batch over `batch` (the mesh axes of the rules'
    relaxed 'batch' entry; () replicates it), tensor parallelism over
    `model` (('model',) where the mesh has that axis). One body runs at
    each mesh position (`positions`, row-major)."""
    mesh: Any
    rules: Any
    specs: dict
    batch: tuple
    model: tuple
    positions: tuple

    @property
    def n(self) -> int:
        return len(self.positions)

    @property
    def m_size(self) -> int:
        return axis_size(self.mesh, self.model)

    @property
    def devices(self) -> list:
        return [self.mesh.devices[p] for p in self.positions]

    def block(self, i: int, axes) -> int:
        """Position i's block index along a dim split over `axes`."""
        return block_of(self.mesh, (tuple(axes),), self.positions[i])[0]

    def mi(self, i: int) -> int:
        """Position i's 'model' index."""
        return self.block(i, self.model)


def _entry_axes(entry) -> tuple:
    return () if entry is None else ((entry,) if isinstance(entry, str)
                                     else tuple(entry))


def lm_plan(cfg: LMConfig, batch: int) -> LMPlan | None:
    """The active mesh context's partition of a dense LM's program for a
    batch of `batch` sequences, or None, and the global program runs:
    without a context, for an MoE config (the MoE's dispatch is global,
    as in JAX's program, or its own shard_map), where a parameter's spec
    would be relaxed (a split the mesh does not divide), or where the
    relaxed specs split nothing over more than one block."""
    mesh, rules = current_mesh(), current_rules()
    if mesh is None or rules is None or cfg.moe:
        return None
    shapes = _shapes(cfg)
    shards = flatten_with_paths(param_shardings(lm_logical_axes(cfg), mesh,
                                                rules))
    specs = {}
    for k, sh in shards.items():
        shape = shapes[k]
        spec = drop_nondivisible(sh.spec, shape, mesh)
        if spec_entries(spec, len(shape)) != spec_entries(sh.spec,
                                                          len(shape)):
            return None
        specs[k] = spec
    b_axes = _entry_axes(drop_nondivisible(rules.resolve("batch"), (batch,),
                                           mesh)[0])
    split = axis_size(mesh, b_axes) > 1 or any(
        axis_size(mesh, e) > 1 for sp in specs.values() for e in sp if e)
    if not split:
        return None
    model = ("model",) if "model" in mesh.axis_names else ()
    return LMPlan(mesh, rules, specs, b_axes, model,
                  tuple(positions(mesh)))


def _map(plan: LMPlan, fn, *lists) -> list:
    """fn(i, *(each list's entry i)) at every position, on its device."""
    return each_position(plan.mesh, lambda i, dev: fn(
        i, *(xs[i] for xs in lists)))


def _pick(xs: list, fn) -> list:
    """fn on each entry of a position list (once under one_body(), where
    every entry is the first's)."""
    if one_body_active():
        return [fn(xs[0])] * len(xs)
    return [fn(x) for x in xs]


def _fsdp(plan: LMPlan, xs: list, path: str) -> list:
    """The blocks of parameter `path` (of one layer, for a stacked leaf)
    gathered over the axes of its spec other than 'model' (FSDP), along
    the dims they split. The gather's backward sums over them where the
    batch is split there, and takes each position's own slice where it
    is replicated."""
    stacked = path.startswith("layers/")
    entries = spec_entries(plan.specs[path],
                           xs[0].dim() + (1 if stacked else 0))
    for dim, axes in enumerate(entries[1:] if stacked else entries):
        fsdp = tuple(a for a in axes if a not in plan.model)
        if not fsdp or axis_size(plan.mesh, fsdp) == 1:
            continue
        if set(fsdp) - set(plan.batch) and set(fsdp) & set(plan.batch):
            raise NotImplementedError(f"FSDP over {fsdp} with the batch "
                                      f"over {plan.batch}")
        grad = "sum" if set(fsdp) <= set(plan.batch) else "own"
        xs = all_gather_dim(plan.mesh, fsdp, xs, dim, grad)
    return xs


def _gather_model(plan: LMPlan, xs: list, dim: int) -> list:
    """A TP block gathered whole over 'model'; each position's work with
    it differs, so the backward sums over 'model'."""
    return all_gather_dim(plan.mesh, plan.model, xs, dim, "sum")


def _attn_mode(plan: LMPlan, cfg: LMConfig, S: int) -> str:
    """'heads' (the shard's heads), 'seq' (the dense path's query rows,
    as JAX's seq_attn) or 'replicated' (the chunked path's attention on
    every shard, as GSPMD replicates it) where the heads do not divide
    'model'."""
    M = plan.m_size
    if cfg.n_heads % M == 0:
        return "heads"
    if S <= cfg.dense_attn_threshold and S % M == 0:
        return "seq"
    return "replicated"


def _attend(q, k, v, cfg: LMConfig):
    S = q.shape[1]
    if k.shape[1] <= cfg.dense_attn_threshold:
        return dense_causal_attention(q, k, v)
    return chunked_causal_attention(
        q, k, v, chunk_q=min(cfg.attn_chunk_q, S),
        chunk_kv=min(cfg.attn_chunk_kv, S),
        skip_masked_chunks=cfg.attn_skip_masked)


def _local_kv(k, v, h0: int, Hl: int, G: int, lo: int):
    """k and v (B, S, n, Dh) of KV heads lo onwards for query heads h0 ..
    h0 + Hl - 1, each of which reads KV head h // G: as they are where
    the heads group evenly, else one KV head a query head."""
    hi = (h0 + Hl - 1) // G
    if (h0 % G == 0 and Hl % G == 0) or lo == hi:
        return k, v
    idx = (torch.arange(h0, h0 + Hl, device=k.device) // G) - lo
    return k[:, :, idx], v[:, :, idx]


def _attention_part(plan: LMPlan, cfg: LMConfig, xn: list, pa: dict,
                    pos_ids: list, cache_rows=None):
    """The attention's output at every position (its residual update,
    whole on every 'model' shard) and, with `cache_rows` (each
    position's slice of the sequence), each position's k and v rows of
    every KV head; `pos_ids` are each position's (1, S) token
    positions, on its device. By _attn_mode: 'heads' takes the shard's heads (wk
    and wv gathered over 'model' where its KV heads do not divide it,
    or for the cache); 'seq' the shard's query rows against every key,
    wq, wk, wv and wo gathered over 'model'; 'replicated' the
    column-parallel projections' outputs gathered over 'model' and the
    whole attention on every shard, wo row-parallel."""
    mesh, model, M = plan.mesh, plan.model, plan.m_size
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    G = H // KV
    B, S, _ = xn[0].shape
    mode = _attn_mode(plan, cfg, S)
    xc = copy_to_shards(mesh, model, xn)
    w = {n: _fsdp(plan, pa[n], f"layers/attn/{n}")
         for n in ("wq", "wk", "wv", "wo")}
    if mode == "seq":
        for n, dim in (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 0)):
            w[n] = _gather_model(plan, w[n], dim)
    elif mode == "heads" and (KV % M or cache_rows is not None):
        for n in ("wk", "wv"):
            w[n] = _gather_model(plan, w[n], 1)
    kv_local = mode == "heads" and KV % M == 0 and cache_rows is None
    if mode == "replicated":
        # each shard's columns of q, k and v gathered whole: the gather's
        # backward sums the shards' parts of each block's gradient
        xs = {n: all_gather_dim(mesh, model, _map(
            plan, lambda i, x, wt: x @ wt.to(x.dtype), xc, w[n]), 2, "sum")
            for n in ("wq", "wk", "wv")}
        q_in, k_in, v_in = xs["wq"], xs["wk"], xs["wv"]
    else:
        q_in, k_in, v_in = xc, xc, xc

    def heads(t, n):
        return t.reshape(t.shape[0], t.shape[1], n, Dh)

    def proj(x, wt, n):
        return heads(x @ wt.to(x.dtype), n)

    def rot(t, p):
        return apply_rope(t, p, cfg.rope_theta)

    def body(i, xq, xk, xv, wq, wk, wv, wo, positions):
        m = plan.mi(i)
        r = None if cache_rows is None else cache_rows[i]
        cache = None
        if mode == "heads":
            Hl = H // M
            h0 = m * Hl
            q = rot(proj(xq, wq, Hl), positions)
            if kv_local:
                k = rot(proj(xk, wk, KV // M), positions)
                v = proj(xv, wv, KV // M)
            else:
                lo, hi = h0 // G, (h0 + Hl - 1) // G
                cols = slice(lo * Dh, (hi + 1) * Dh)
                k = rot(proj(xk, wk[:, cols], hi - lo + 1), positions)
                v = proj(xv, wv[:, cols], hi - lo + 1)
                k, v = _local_kv(k, v, h0, Hl, G, lo)
                if r is not None:
                    cache = (rot(proj(xk[:, r], wk, KV), positions[:, r]),
                             proj(xv[:, r], wv, KV))
            out = _attend(q, k, v, cfg).reshape(B, S, Hl * Dh)
            return out @ wo.to(out.dtype), cache
        if mode == "seq":
            k = rot(proj(xk, wk, KV), positions)
            v = proj(xv, wv, KV)
        else:
            k, v = rot(heads(xk, KV), positions), heads(xv, KV)
        if r is not None:
            cache = (k[:, r], v[:, r])
        if mode == "seq":
            rows = S // M
            r0 = m * rows
            q = rot(proj(xq[:, r0:r0 + rows], wq, H),
                    positions[:, r0:r0 + rows])
            out = dense_causal_attention(q, k, v, q_offset=r0)
            return out.reshape(B, rows, H * Dh) @ wo.to(out.dtype), cache
        q = rot(heads(xq, H), positions)
        out = _attend(q, k, v, cfg).reshape(B, S, H * Dh)
        c = wo.shape[0]
        return out[..., m * c:(m + 1) * c] @ wo.to(out.dtype), cache

    res = _map(plan, body, q_in, k_in, v_in, w["wq"], w["wk"], w["wv"],
               w["wo"], pos_ids)
    parts = [r[0] for r in res]
    if mode == "seq":
        h = all_gather_dim(mesh, model, parts, 1, "own")
    else:
        h = reduce_from_shards(mesh, model, parts)
    return h, [r[1] for r in res]


def _ffn_part(plan: LMPlan, cfg: LMConfig, xn: list, pf: dict) -> list:
    """The SwiGLU FFN: w_gate and w_up column-parallel, w_down
    row-parallel, the partials summed over 'model'."""
    xc = copy_to_shards(plan.mesh, plan.model, xn)
    w = [_fsdp(plan, pf[n], f"layers/ffn/{n}")
         for n in ("w_gate", "w_up", "w_down")]

    def body(i, x, wg, wu, wd):
        h = F.silu(x @ wg.to(x.dtype)) * (x @ wu.to(x.dtype))
        return h @ wd.to(x.dtype)
    return reduce_from_shards(plan.mesh, plan.model,
                              _map(plan, body, xc, *w))


def _layer_tree(P: dict, l: int) -> dict:
    """Layer l's leaves, a position list each, out of the stacked
    leaves' position lists."""
    out: dict = {}
    for k, xs in P.items():
        if k.startswith("layers/"):
            path = k.split("/")[1:]
            node = out
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = _pick(xs, lambda x, l=l: x[l])
    return out


def _layer_part(plan, cfg, x, lp, pos_ids, cache_rows=None):
    xn = _map(plan, lambda i, x, w: rms_norm(x, w), x, lp["ln1"])
    h, kv = _attention_part(plan, cfg, xn, lp["attn"], pos_ids, cache_rows)
    x = _map(plan, lambda i, a, b: a + b, x, h)
    xn = _map(plan, lambda i, x, w: rms_norm(x, w), x, lp["ln2"])
    h = _ffn_part(plan, cfg, xn, lp["ffn"])
    return _map(plan, lambda i, a, b: a + b, x, h), kv


def _embed_table(plan: LMPlan, P: dict) -> list:
    return _fsdp(plan, P["embed"], "embed")


def _embed_part(plan: LMPlan, cfg: LMConfig, table: list,
                tok: list) -> list:
    """The vocab-parallel lookup: each position's rows of its vocab
    block, summed over 'model'."""
    parts = _map(plan, lambda i, t, ids: vocab_block_lookup(
        t, ids, plan.mi(i) * t.shape[0]), table, tok)
    x = reduce_from_shards(plan.mesh, plan.model, parts)
    return _map(plan, lambda i, x: x.to(cfg.dtype), x)


def _head_part(plan: LMPlan, cfg: LMConfig, P: dict, table: list,
               x: list) -> list:
    """Each position's logits of its vocab block (rms_norm'd x through
    the tied embed.T or lm_head, column-parallel over 'model')."""
    x = _map(plan, lambda i, x, w: rms_norm(x, w), x, P["final_ln"])
    x = copy_to_shards(plan.mesh, plan.model, x)
    if cfg.tie_embeddings:
        return _map(plan, lambda i, x, t: x @ t.T.to(x.dtype), x, table)
    head = _fsdp(plan, P["lm_head"], "lm_head")
    return _map(plan, lambda i, x, w: x @ w.to(x.dtype), x, head)


def _param_blocks(plan: LMPlan, params: dict) -> dict:
    """Each parameter leaf's block at every position (a tensor is laid by
    its spec, a Sharded must be laid so already)."""
    flat = flatten_with_paths(params)
    if set(flat) != set(plan.specs):
        raise ValueError(f"parameter paths differ: "
                         f"{sorted(set(flat) ^ set(plan.specs))[:5]}")
    return {k: position_blocks(plan.mesh, v, plan.specs[k], k)
            for k, v in flat.items()}


def _batch_blocks(plan: LMPlan, x) -> list:
    """A (B, ...) batch of ids' rows of each position's batch block, as
    int64 on its device."""
    if not isinstance(x, Sharded):
        x = _tokens(x, None)
    blocks = position_blocks(plan.mesh, x, ((plan.batch or None),), "batch")
    return _map(plan, lambda i, b: b.long(), blocks)


def _trunk(plan: LMPlan, cfg: LMConfig, P: dict, tok: list, *,
           cache_rows=None):
    """Embedding and layers: each position's (B_l, S, D) residual stream
    (whole over 'model'), the gathered embedding table, and with
    `cache_rows` each layer's k and v rows at every position."""
    S = tok[0].shape[1]
    table = _embed_table(plan, P)
    x = _embed_part(plan, cfg, table, tok)
    pos_ids = _map(plan, lambda i, x: torch.arange(S, device=x.device)[
        None, :], x)
    caches = []
    for l in range(cfg.n_layers):
        lp = _layer_tree(P, l)
        if cache_rows is not None:
            x, kv = _layer_part(plan, cfg, x, lp, pos_ids, cache_rows)
            caches.append(kv)
        else:
            x = _remat_layer(plan, cfg, x, lp, pos_ids)
    return x, table, caches


def _remat_layer(plan: LMPlan, cfg: LMConfig, x: list, lp: dict,
                 pos_ids: list) -> list:
    """_layer_part at every position under the config's remat, as
    _run_layer runs a global layer. "full" is torch.utils.checkpoint's
    reentrant form over the layer's distinct tensors: its one node
    recomputes the lockstep layer once, where the non-reentrant form
    recomputes on the first device thread of the backward that asks,
    and two cards' threads may both start it. "dots" keeps
    _run_layer's selective checkpoint (a virtual mesh's one thread)."""
    def run(x, lp):
        return _layer_part(plan, cfg, x, lp, pos_ids)[0]
    if cfg.remat != "full" or not torch.is_grad_enabled():
        return _run_layer(run, cfg, x, lp)
    flat = flatten_with_paths(lp)          # a leaf a position's tensor
    ts = _unique(x + list(flat.values()))
    at = {id(t): j for j, t in enumerate(ts)}
    xi = [at[id(t)] for t in x]
    li = {k: at[id(t)] for k, t in flat.items()}

    def body(*ts):
        lp_ = unflatten_like(lp, {k: ts[j] for k, j in li.items()})
        out = run([ts[j] for j in xi], lp_)
        return tuple(_unique(out))
    out = ckpt.checkpoint(body, *ts, use_reentrant=True,
                          preserve_rng_state=False)
    return list(out) * plan.n if len(out) == 1 else list(out)


def _loss_part(plan: LMPlan, cfg: LMConfig, P: dict, tok: list,
               lab: list, n_tokens: int):
    """Each position's loss: the vocab-parallel log-sum-exp (the max over
    'model' with no gradient, the sum of exp over 'model') less the
    label logit (each block's masked sum, summed over 'model'), each
    batch block's sum over the global token count, summed over the
    batch blocks. (losses, nlls, auxes), a position list each."""
    mesh, model = plan.mesh, plan.model
    x, table, _ = _trunk(plan, cfg, P, tok)
    logits = _map(plan, lambda i, l: l.to(torch.float32),
                  _head_part(plan, cfg, P, table, x))
    m = max_over_shards(mesh, model, _map(
        plan, lambda i, l: l.detach().amax(dim=-1, keepdim=True), logits))
    se = reduce_from_shards(mesh, model, _map(
        plan, lambda i, l, m: torch.exp(l - m).sum(dim=-1), logits, m))

    def label(i, l, y):
        V = l.shape[-1]
        iota = torch.arange(V, device=l.device) + plan.mi(i) * V
        mask = iota == y[..., None]
        return torch.where(mask, l, torch.zeros((), device=l.device)).sum(-1)
    ll = reduce_from_shards(mesh, model, _map(plan, label, logits, lab))
    part = _map(plan, lambda i, m, se, ll: (
        (m[..., 0] + torch.log(se)) - ll).sum() / n_tokens, m, se, ll)
    nll = reduce_from_shards(mesh, plan.batch, part)
    aux = _map(plan, lambda i, n: torch.zeros((), device=n.device), nll)
    loss = _map(plan, lambda i, n, a: n + cfg.aux_loss_weight * a, nll, aux)
    return loss, nll, aux


def _shape_of(x) -> tuple:
    return tuple(x.shape) if isinstance(x, Sharded) else tuple(np.shape(x))


def _unique(xs: list) -> list:
    return list({id(x): x for x in xs}.values())


def _partitioned_grads(plan: LMPlan, cfg: LMConfig, params: dict,
                       batch: dict):
    """(loss, metrics, each leaf's gradient at every position). Each
    position's loss seeds its own backward (Megatron's operators make
    every position's gradient its share: the 'model' sums where the
    work splits, the identity where it is replicated); the FSDP
    gathers' backwards reduce-scatter over 'data' where the batch is
    split there; then each leaf's gradient is summed over the batch
    axes that split the batch and not the leaf."""
    dev0 = plan.devices[0]
    P = _param_blocks(plan, params)
    tok = _batch_blocks(plan, batch["tokens"])
    lab = _batch_blocks(plan, batch["labels"])
    stacked = {k for k in P if k.startswith("layers/")}

    def leaf(k, x):
        if k in stacked:
            return [t.detach().requires_grad_(True) for t in x.unbind(0)]
        return x.detach().requires_grad_(True)
    leaves = {k: _pick(xs, lambda x, k=k: leaf(k, x)) for k, xs in P.items()}
    n_tokens = math.prod(_shape_of(batch["tokens"]))
    with torch.enable_grad():
        loss, nll, aux = _loss_part(plan, cfg, leaves, tok, lab, n_tokens)
        outs = _unique(loss)
        ins = _unique([t for xs in leaves.values() for x in xs
                       for t in (x if isinstance(x, list) else [x])])
        seeds = _unique(_map(plan, lambda i, l: torch.ones_like(l), loss))
        # backward, not grad: a layer's reentrant checkpoint refuses
        # autograd.grad's inputs
        torch.autograd.backward(outs, seeds)
    g_of = {id(t): (torch.zeros_like(t) if t.grad is None else t.grad)
            for t in ins}
    grads = {}
    for k, xs in leaves.items():
        if k in stacked:
            g = _map(plan, lambda i, x: torch.stack([g_of[id(t)]
                                                     for t in x]), xs)
        else:
            g = [g_of[id(x)] for x in xs]
        spec_axes = {a for e in plan.specs[k] for a in _entry_axes(e)}
        grads[k] = sum_over_shards(plan.mesh, tuple(
            a for a in plan.batch if a not in spec_axes), g)
    metrics = {"nll": place(nll[0].detach(), dev0),
               "aux": place(aux[0].detach(), dev0)}
    return place(loss[0].detach(), dev0), metrics, grads


def _owners(plan: LMPlan, spec, ndim: int) -> list:
    """Whether each position is the first to hold its block of a leaf
    laid by `spec`."""
    entries = spec_entries(spec, ndim)
    seen, out = set(), []
    for pos in plan.positions:
        blk = block_of(plan.mesh, entries, pos)
        out.append(blk not in seen)
        seen.add(blk)
    return out


@functools.lru_cache(maxsize=None)
def _shapes(cfg: LMConfig) -> dict:
    """Each parameter's shape (lm_init on the meta device, outside any
    dispatch mode: a cost walk that calls a program does not count
    them)."""
    with _disable_current_modes():
        return {k: tuple(v.shape) for k, v in flatten_with_paths(
            lm_init(None, cfg, device="meta")).items()}


def _partitioned_train_step(plan, params, opt_state, batch, cfg, lr,
                            clip_norm):
    """Gradients at every position, the global norm (each distinct
    block's squares once, summed over the positions in order), the clip
    and Adam on each position's blocks; the new parameters and moments
    as Sharded laid by their specs."""
    loss, metrics, grads = _partitioned_grads(plan, cfg, params, batch)
    shapes = _shapes(cfg)
    keys = list(grads)
    owners = {k: _owners(plan, plan.specs[k], len(shapes[k])) for k in keys}
    sq = _map(plan, lambda i, *gs: torch.stack([
        torch.sum(g.to(torch.float32) ** 2) * float(owners[k][i])
        for k, g in zip(keys, gs)]), *(grads[k] for k in keys))
    total = sum_over_shards(plan.mesh, plan.mesh.axis_names, sq)
    gnorm = _map(plan, lambda i, t: torch.sqrt(t.sum()), total)
    mu = {k: position_blocks(plan.mesh, opt_state.mu[k], plan.specs[k],
                             f"mu {k}") for k in keys}
    nu = {k: position_blocks(plan.mesh, opt_state.nu[k], plan.specs[k],
                             f"nu {k}") for k in keys}
    P = _param_blocks(plan, params)

    def step(i, gn, *leaves):
        n = len(keys)
        gs, ps, ms, vs = (leaves[j * n:(j + 1) * n] for j in range(4))
        scale = torch.clamp_max(clip_norm / (gn + 1e-12), 1.0)
        g = {k: (x.to(torch.float32) * scale).to(x.dtype)
             for k, x in zip(keys, gs)}
        st = AdamState(step=place(opt_state.step, plan.devices[i]),
                       mu=dict(zip(keys, ms)), nu=dict(zip(keys, vs)))
        return adam_update(g, st, {k: p.detach() for k, p in zip(keys, ps)},
                           lr=lr)
    out = _map(plan, step, gnorm, *(grads[k] for k in keys),
               *(P[k] for k in keys), *(mu[k] for k in keys),
               *(nu[k] for k in keys))
    new = {k: assemble(plan.mesh, [o[0][k] for o in out], plan.specs[k],
                       shapes[k]) for k in keys}
    state = AdamState(
        step=out[0][1].step,
        mu={k: assemble(plan.mesh, [o[1].mu[k] for o in out],
                        plan.specs[k], shapes[k]) for k in keys},
        nu={k: assemble(plan.mesh, [o[1].nu[k] for o in out],
                        plan.specs[k], shapes[k]) for k in keys})
    return unflatten_like(params, new), state, dict(
        metrics, loss=loss, grad_norm=place(gnorm[0], plan.devices[0]))


def _partitioned_forward(plan, params, tokens, cfg, stats):
    dev0 = plan.devices[0]
    P = _param_blocks(plan, params)
    x, table, _ = _trunk(plan, cfg, P, _batch_blocks(plan, tokens))
    logits = _head_part(plan, cfg, P, table, x)
    zero = torch.zeros((), device=dev0)
    _record(stats, [zero.long()] * cfg.n_layers)
    B, S = _shape_of(tokens)
    return assemble(plan.mesh, logits, ((plan.batch or None), None,
                                        (plan.model or None)),
                    (B, S, cfg.vocab)), zero


def _cache_plan(plan: LMPlan, cfg: LMConfig, B: int, S: int):
    """The cache's spec (cache_logical_axes under the rules, relaxed),
    each position's slice of the sequence, and the mesh axes the
    sequence splits over."""
    shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
    spec = drop_nondivisible(plan.rules.resolve(*cache_logical_axes(cfg)["k"]),
                             shape, plan.mesh)
    seq_axes = spec_entries(spec, 5)[2]
    Sc = S // axis_size(plan.mesh, seq_axes)
    rows = [slice(plan.block(i, seq_axes) * Sc,
                  (plan.block(i, seq_axes) + 1) * Sc)
            for i in range(plan.n)]
    return spec, shape, seq_axes, rows


@torch.no_grad()
def _partitioned_prefill(plan, params, tokens, cfg):
    P = _param_blocks(plan, params)
    tok = _batch_blocks(plan, tokens)
    B, S = _shape_of(tokens)
    spec, shape, _, rows = _cache_plan(plan, cfg, B, S)
    x, table, caches = _trunk(plan, cfg, P, tok, cache_rows=rows)
    last = _map(plan, lambda i, x: x[:, -1, :], x)
    logits = _map(plan, lambda i, l: l.to(torch.float32),
                  _head_part(plan, cfg, P, table, last))
    cache = {}
    for j, name in enumerate(("k", "v")):
        blocks = _map(plan, lambda i, *ls, j=j: torch.stack(
            [c[j] for c in ls]), *caches)
        cache[name] = assemble(plan.mesh, blocks, spec, shape)
    return cache, assemble(plan.mesh, logits, ((plan.batch or None),
                                               (plan.model or None)),
                           (B, cfg.vocab))


@torch.no_grad()
def _partitioned_decode(plan, params, cache, token, pos, cfg):
    """One decode step at every position: q, k and v column-parallel and
    gathered over 'model' (each sequence block attends with every head),
    the new token's k and v written in place into the block that holds
    pos, each block's f32 max, sum of exp and weighted values merged
    over the blocks in order (a block wholly past pos weighs 0), wo and
    the FFN row-parallel."""
    mesh, model = plan.mesh, plan.model
    P = _param_blocks(plan, params)
    tok = _batch_blocks(plan, token)
    B = _shape_of(token)[0]
    S = _shape_of(cache["k"])[2]
    spec, shape, seq_axes, rows = _cache_plan(plan, cfg, B, S)
    if spec_entries(spec, 5)[1] != plan.batch:
        raise ValueError(f"the cache's batch over {spec_entries(spec, 5)[1]}"
                         f", the tokens' over {plan.batch}")
    kc = position_blocks(plan.mesh, cache["k"], spec, "cache k")
    vc = position_blocks(plan.mesh, cache["v"], spec, "cache v")
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    table = _embed_table(plan, P)
    x = _map(plan, lambda i, x: x[:, None, :],
             _embed_part(plan, cfg, table, tok))
    # each position's rope positions, and whether its block holds pos
    at_pos = _map(plan, lambda i, t: torch.full(
        (t.shape[0], 1), pos, dtype=torch.int32, device=t.device), tok)
    holds = _map(plan, lambda i, t: torch.full(
        (), rows[i].start <= pos < rows[i].stop, device=t.device), tok)
    for l in range(cfg.n_layers):
        lp = _layer_tree(P, l)
        xn = _map(plan, lambda i, x, w: rms_norm(x, w), x, lp["ln1"])
        w = {n: _fsdp(plan, lp["attn"][n], f"layers/attn/{n}")
             for n in ("wq", "wk", "wv", "wo")}

        def proj(i, x, wt):
            return x @ wt.to(x.dtype)
        cols = {n: all_gather_dim(mesh, model, _map(plan, proj, xn, w[n]),
                                  2, "own") for n in ("wq", "wk", "wv")}

        def attend(i, xq, xk, xv, kb, vb, at_pos, holds):
            Bl = xq.shape[0]
            q = apply_rope(xq.reshape(Bl, 1, H, Dh), at_pos, cfg.rope_theta)
            k = apply_rope(xk.reshape(Bl, 1, KV, Dh), at_pos, cfg.rope_theta)
            v = xv.reshape(Bl, 1, KV, Dh)
            r = rows[i]
            # every block writes its row at pos (clamped into the block):
            # the new token's k and v where the block holds pos, its own
            # row back elsewhere, so every body runs the same ops
            at = min(max(pos - r.start, 0), r.stop - r.start - 1)
            for blk, new in ((kb, k), (vb, v)):
                row = blk[l][:, at:at + 1]
                row.copy_(torch.where(holds, new.to(blk.dtype), row))
            return decode_attention_partial(q, kb[l], vb[l], pos, r.start)
        part = _map(plan, attend, cols["wq"], cols["wk"], cols["wv"], kc, vc,
                    at_pos, holds)
        # each block weighed exp(m_b - m) against the blocks' max m
        m = max_over_shards(mesh, seq_axes, [p[0] for p in part])
        share = _map(plan, lambda i, p, m: torch.exp(p[0] - m), part, m)
        den = reduce_from_shards(mesh, seq_axes, _map(
            plan, lambda i, p, e: e * p[1], part, share))
        num = reduce_from_shards(mesh, seq_axes, _map(
            plan, lambda i, p, e: e * p[2], part, share))

        def out_proj(i, den, num, wo):
            att = (num / den).movedim(3, 1)           # (B, 1, KV, G, Dh)
            att = att.reshape(den.shape[0], 1, H * Dh).to(cfg.dtype)
            c = wo.shape[0]
            m = plan.mi(i)
            return att[..., m * c:(m + 1) * c] @ wo.to(att.dtype)
        h = reduce_from_shards(mesh, model, _map(plan, out_proj, den, num,
                                                 w["wo"]))
        x = _map(plan, lambda i, a, b: a + b, x, h)
        xn = _map(plan, lambda i, x, w: rms_norm(x, w), x, lp["ln2"])
        x = _map(plan, lambda i, a, b: a + b, x,
                 _ffn_part(plan, cfg, xn, lp["ffn"]))
    last = _map(plan, lambda i, x: x[:, 0, :], x)
    logits = _map(plan, lambda i, l: l.to(torch.float32),
                  _head_part(plan, cfg, P, table, last))
    out = {"k": assemble(plan.mesh, kc, spec, shape),
           "v": assemble(plan.mesh, vc, spec, shape)}
    return assemble(plan.mesh, logits, ((plan.batch or None),
                                        (plan.model or None)),
                    (B, cfg.vocab)), out


class TransformerLM(nn.Module):
    """An LMConfig's parameters as an nn.Module (parameter names are the
    tree's paths with '.' for '/'), over the functions above."""

    def __init__(self, cfg: LMConfig, *, gen: torch.Generator | None = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        _register(self, lm_init(gen, cfg, device=device))

    def params(self) -> dict:
        """The parameter tree (nested dicts of parameters)."""
        return _tree_of(self)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def load_numpy(self, tree) -> "TransformerLM":
        """Take a JAX `lm_init` tree (numpy arrays) as the parameters."""
        new = flatten_with_paths(lm_from_numpy(tree, self.cfg,
                                               device=self.device))
        with torch.no_grad():
            for k, p in flatten_with_paths(self.params()).items():
                p.copy_(new[k])
        return self

    def state_numpy(self) -> dict:
        return lm_state_numpy(self.params())

    def forward(self, tokens):
        return lm_forward(self.params(), tokens, self.cfg)

    def loss(self, batch):
        return lm_loss(self.params(), batch, self.cfg)

    def init_opt(self):
        return lm_adam_init(self.params(), self.cfg)

    def train_step(self, opt_state, batch, **kw):
        """One lm_train_step; the parameters are updated in place.
        Returns (opt_state, metrics)."""
        new, opt_state, metrics = lm_train_step(self.params(), opt_state,
                                                batch, self.cfg, **kw)
        new = flatten_with_paths(new)
        with torch.no_grad():
            for k, p in flatten_with_paths(self.params()).items():
                p.data = new[k]
        return opt_state, metrics

    def prefill(self, tokens):
        return lm_prefill(self.params(), tokens, self.cfg)

    def decode_step(self, cache, token, pos):
        return lm_decode_step(self.params(), cache, token, pos, self.cfg)

    def make_cache(self, batch, max_seq, dtype=None):
        return make_decode_cache(self.cfg, batch, max_seq, dtype,
                                 device=self.device)
