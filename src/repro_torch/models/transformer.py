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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.checkpoint.store import flatten_with_paths, unflatten_like
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import (
    current_mesh,
    logical_shard,
    tree_map,
)
from repro_torch.models.layers import (
    _qkv,
    attn_axes,
    attn_init,
    chunked_causal_attention,
    decode_attention,
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
)
from repro_torch.models.recsys import _register, _tree_of
from repro_torch.optim import adam_init, adam_update, clip_by_global_norm


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
    (a masked sum over the vocab axis), plus aux_loss_weight x aux."""
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
    dtype, as jax.value_and_grad gives them."""
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
    inputs are left as they are."""
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
    last-token logits (B, V) f32); `stats` as lm_forward's."""
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
    lm_forward's."""
    token = _tokens(token, _param_device(params))
    pos = int(pos)
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
