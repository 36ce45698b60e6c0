"""Building blocks shared by the port's models (counterpart of
repro.models.layers): the dense initialiser, RMSNorm, RoPE, GQA
attention (dense causal, chunked flash-style causal, one-token decode
against a KV cache), the SwiGLU FFN, the scatter-dispatch MoE and the
embedding.

Plain torch ops that follow the JAX formulas step by step: parameters
in cfg.param_dtype, activations in cfg.dtype, softmax statistics and
attention logits in f32 (q and k widened to f32 before their product,
which is exact for bf16 operands, as XLA's preferred_element_type=f32
is). No F.scaled_dot_product_attention: its backends change the order
of rounding. The `*_axes` functions give each parameter's logical
axes (distributed/sharding.py resolves them against a mesh), and the
activations carry JAX's `logical_shard` annotations, which check and
relax their specs under an active mesh context and leave the values
as they are.

`moe_apply_shmap` is JAX's shard_map expert-parallel MoE written over
distributed.topk.map_shards on a one-process mesh (launch/mesh.py): a
body for each batch block and each 'model' shard routes its block's
tokens, dispatches those bound for its own experts into slots, runs
its experts and scatters their outputs back to the tokens; the
partial sums add over 'model' in shard order.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import logical_shard
from repro_torch.distributed.topk import batch_axes_of, map_shards
from repro_torch.launch.mesh import axis_size, place

# masked attention logits (the chunked and decode paths; dense uses -inf)
MASK_LOGIT = -1e30


# --------------------------------------------------------------------------
# Init helpers
# --------------------------------------------------------------------------

def _draw(gen: torch.Generator | None, shape, device) -> torch.Tensor:
    """Standard normals in f32 from `gen` on its device; on the meta
    device an empty tensor of the shape (nothing is drawn or held)."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device="meta")
    return torch.randn(shape, generator=gen, device=gen.device)


def dense_init(gen: torch.Generator | None, shape, dtype=torch.float32,
               scale: float | None = None, device=None) -> torch.Tensor:
    """Normal weights scaled by `scale` (default 1/sqrt(fan-in)), drawn
    from `gen` on its device (or shaped only, on device="meta")."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    dev = gen.device if device is None else device
    return (_draw(gen, shape, dev) * s).to(dtype)


# --------------------------------------------------------------------------
# RMSNorm
# --------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """x / rms(x) * (1 + w) over the last axis, in f32, cast back to x's
    type. The JAX body's rsqrt comes from XLA, whose CPU rsqrt need not
    round as torch.rsqrt does: the two agree to a few ulp, not bitwise."""
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.to(torch.float32))).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, d_head, 2, dtype=torch.float32,
                                         device=device) / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions broadcastable to (..., S). Rotated
    in f32 (the two halves of Dh), then cast back to x's type."""
    d_head = x.shape[-1]
    freqs = rope_freqs(d_head, theta, device=x.device)       # (Dh/2,)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x32 = x.to(torch.float32)
    x1, x2 = x32[..., : d_head // 2], x32[..., d_head // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention: three execution modes sharing one parameterization
# --------------------------------------------------------------------------

def attn_init(gen, cfg, device=None) -> dict:
    D, H, KV, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    return {
        "wq": dense_init(gen, (D, H * Dh), cfg.param_dtype, device=device),
        "wk": dense_init(gen, (D, KV * Dh), cfg.param_dtype, device=device),
        "wv": dense_init(gen, (D, KV * Dh), cfg.param_dtype, device=device),
        "wo": dense_init(gen, (H * Dh, D), cfg.param_dtype,
                         scale=1.0 / math.sqrt(H * Dh), device=device),
    }


def attn_axes() -> dict:
    return {
        "wq": ("qkv_in", "qkv_out"),
        "wk": ("qkv_in", "qkv_out"),
        "wv": ("qkv_in", "qkv_out"),
        "wo": ("o_in", "o_out"),
    }


def _qkv(params: dict, x: torch.Tensor, cfg, positions: torch.Tensor):
    """q (B, S, H, Dh), k and v (B, S, KV, Dh), q and k rotated."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = (x @ params["wq"].to(x.dtype)).reshape(B, S, H, Dh)
    k = (x @ params["wk"].to(x.dtype)).reshape(B, S, KV, Dh)
    v = (x @ params["wv"].to(x.dtype)).reshape(B, S, KV, Dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = logical_shard(q, "batch", "seq", "heads", None)
    k = logical_shard(k, "batch", "seq", "kv_heads", None)
    v = logical_shard(v, "batch", "seq", "kv_heads", None)
    return q, k, v


def _gqa_logits(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, H, Dh), k: (B, Sk, KV, Dh) -> (B, KV, G, Sq, Sk) f32,
    divided by sqrt(Dh)."""
    B, Sq, H, Dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, Dh).to(torch.float32)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.to(torch.float32))
    return logits / math.sqrt(Dh)


def _gqa_combine(probs: torch.Tensor, v: torch.Tensor,
                 dtype) -> torch.Tensor:
    """probs: (B, KV, G, Sq, Sk), v: (B, Sk, KV, Dh) -> (B, Sq, H, Dh) in
    `dtype` (probs cast to it first, as JAX does)."""
    B, KV, G, Sq, _ = probs.shape
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(dtype), v.to(dtype))
    return out.reshape(B, Sq, KV * G, v.shape[-1])


def dense_causal_attention(q, k, v, *, q_offset: int | None = None
                           ) -> torch.Tensor:
    """Causal attention over the whole (Sq, Sk) score matrix; query i
    attends to keys <= i + q_offset (default Sk - Sq; masked with -inf).
    A block of query rows r0 onwards against every key takes
    q_offset=r0."""
    Sq, Sk = q.shape[1], k.shape[1]
    logits = _gqa_logits(q, k)
    off = Sk - Sq if q_offset is None else q_offset
    qi = torch.arange(Sq, device=q.device)[:, None] + off
    ki = torch.arange(Sk, device=q.device)[None, :]
    logits = logits.masked_fill(~(qi >= ki), float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return _gqa_combine(probs, v, q.dtype)


def chunked_causal_attention(q, k, v, *, chunk_q: int, chunk_kv: int,
                             skip_masked_chunks: bool = True
                             ) -> torch.Tensor:
    """Flash-style double-chunked causal attention: for each q chunk a
    running (max, denominator, accumulator) over the kv chunks, logits
    masked with -1e30, the output acc / max(l, 1e-30). Never holds the
    (Sq, Sk) score matrix. With `skip_masked_chunks` a kv chunk wholly
    in the future of its q chunk is skipped (a static Python skip: the
    chunk would leave the carry as it is)."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    if Sq % chunk_q or Sk % chunk_kv:
        raise ValueError(f"Sq {Sq} / Sk {Sk} not divisible by chunks "
                         f"{chunk_q} / {chunk_kv}")
    nq, nk = Sq // chunk_q, Sk // chunk_kv
    KV = k.shape[2]
    G = H // KV
    offset = Sk - Sq            # query i attends to keys <= i + offset
    dev = q.device
    ar_q = torch.arange(chunk_q, device=dev)
    ar_k = torch.arange(chunk_kv, device=dev)
    chunks = []
    for qi in range(nq):
        q_c = q[:, qi * chunk_q:(qi + 1) * chunk_q]
        q_pos = qi * chunk_q + ar_q + offset
        m = torch.full((B, KV, G, chunk_q), MASK_LOGIT, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, KV, G, chunk_q), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, KV, G, chunk_q, Dh), dtype=torch.float32,
                          device=dev)
        first_q = qi * chunk_q + offset
        for kj in range(nk):
            if skip_masked_chunks and kj * chunk_kv > first_q + chunk_q - 1:
                continue
            k_c = k[:, kj * chunk_kv:(kj + 1) * chunk_kv]
            v_c = v[:, kj * chunk_kv:(kj + 1) * chunk_kv]
            logits = _gqa_logits(q_c, k_c)          # (B, KV, G, cq, ck)
            k_pos = kj * chunk_kv + ar_k
            mask = q_pos[:, None] >= k_pos[None, :]
            logits = torch.where(mask, logits,
                                 torch.full_like(logits, MASK_LOGIT))
            m_new = torch.maximum(m, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            scale = torch.exp(m - m_new)
            l = l * scale + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p,
                              v_c.to(torch.float32))
            acc = acc * scale[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        out = out.movedim(3, 1)                     # (B, cq, KV, G, Dh)
        chunks.append(out.reshape(B, chunk_q, KV * G, Dh).to(q.dtype))
    return torch.cat(chunks, dim=1)


def decode_attention(q, k_cache, v_cache, pos: int) -> torch.Tensor:
    """One-token attention against a KV cache. q: (B, 1, H, Dh); caches
    (B, S_max, KV, Dh); entries at positions > pos are masked. Softmax
    statistics in f32."""
    S = k_cache.shape[1]
    logits = _gqa_logits(q, k_cache)                # (B, KV, G, 1, S)
    valid = torch.arange(S, device=q.device) <= pos
    logits = torch.where(valid, logits, torch.full_like(logits, MASK_LOGIT))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    probs = p / p.sum(dim=-1, keepdim=True)
    return _gqa_combine(probs, v_cache, q.dtype)


def decode_attention_partial(q, k_block, v_block, pos: int, start: int):
    """decode_attention's statistics over one block of the cache, its
    keys at positions start onwards (entries past pos masked with
    MASK_LOGIT): (m_b, l_b, acc_b), the block's f32 max (B, KV, G, 1,
    1), its sum of exp(logit - m_b) (same shape) and the sum of
    exp(logit - m_b) v (B, KV, G, 1, Dh) in f32. A block wholly past pos
    has every logit at MASK_LOGIT: m_b is MASK_LOGIT and l_b the block's
    length, and the merge over the blocks, against their max m, weighs
    it exp(m_b - m) = 0."""
    S = k_block.shape[1]
    logits = _gqa_logits(q, k_block)                # (B, KV, G, 1, S)
    valid = start + torch.arange(S, device=q.device) <= pos
    logits = torch.where(valid, logits, torch.full_like(logits, MASK_LOGIT))
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.exp(logits - m)
    acc = torch.einsum("bkgqs,bskd->bkgqd", p, v_block.to(torch.float32))
    return m, p.sum(dim=-1, keepdim=True), acc


# --------------------------------------------------------------------------
# SwiGLU FFN
# --------------------------------------------------------------------------

def ffn_init(gen, cfg, d_ff: int | None = None, device=None) -> dict:
    D = cfg.d_model
    Fh = d_ff or cfg.d_ff
    return {
        "w_gate": dense_init(gen, (D, Fh), cfg.param_dtype, device=device),
        "w_up": dense_init(gen, (D, Fh), cfg.param_dtype, device=device),
        "w_down": dense_init(gen, (Fh, D), cfg.param_dtype,
                             scale=1.0 / math.sqrt(Fh), device=device),
    }


def ffn_axes() -> dict:
    return {
        "w_gate": ("ffn_in", "ffn_out"),
        "w_up": ("ffn_in", "ffn_out"),
        "w_down": ("ffn_down_in", "ffn_down_out"),
    }


def ffn_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ params["w_gate"].to(x.dtype)) * (
        x @ params["w_up"].to(x.dtype))
    h = logical_shard(h, "batch", "seq", "mlp")
    return h @ params["w_down"].to(x.dtype)


# --------------------------------------------------------------------------
# Mixture of Experts: scatter dispatch into (E, C, D) buffers
# --------------------------------------------------------------------------

def moe_init(gen, cfg, device=None) -> dict:
    D, E, Fm = cfg.d_model, cfg.n_experts, cfg.d_ff_moe
    params = {
        "router": dense_init(gen, (D, E), torch.float32, device=device),
        "experts": {
            "w_gate": dense_init(gen, (E, D, Fm), cfg.param_dtype,
                                 device=device),
            "w_up": dense_init(gen, (E, D, Fm), cfg.param_dtype,
                               device=device),
            "w_down": dense_init(gen, (E, Fm, D), cfg.param_dtype,
                                 scale=1.0 / math.sqrt(Fm), device=device),
        },
    }
    if cfg.shared_expert:
        params["shared"] = ffn_init(gen, cfg, d_ff=cfg.d_ff_moe, device=device)
    return params


def moe_axes(cfg) -> dict:
    axes = {
        "router": (None, None),
        "experts": {
            "w_gate": ("experts", "expert_in", "expert_out"),
            "w_up": ("experts", "expert_in", "expert_out"),
            "w_down": ("experts", "expert_out", "expert_in"),
        },
    }
    if cfg.shared_expert:
        axes["shared"] = ffn_axes()
    return axes


def moe_capacity(n_tokens: int, cfg) -> int:
    """Slots an expert holds: ceil(T * top_k * capacity_factor / E),
    rounded up to 256 for the 'sort' dispatch (at least 256), else to 8
    (at least 8)."""
    c = int(math.ceil(n_tokens * cfg.top_k * cfg.capacity_factor
                      / cfg.n_experts))
    if getattr(cfg, "moe_dispatch", "onehot") == "sort":
        return max(256, -(-c // 256) * 256)
    return max(8, -(-c // 8) * 8)


def _positions_by_expert(flat_e: torch.Tensor, n_experts: int
                         ) -> torch.Tensor:
    """Stable rank of each assignment among those of its expert, in
    token order (the onehot cumsum's positions, the sort path's too)."""
    TK = flat_e.shape[0]
    sorted_e, order = torch.sort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    pos_sorted = torch.arange(TK, device=flat_e.device) - starts[sorted_e]
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos


def moe_route(params: dict, xt: torch.Tensor, cfg):
    """The router of moe_apply over tokens xt (T, D): (probs (T, E) f32,
    gate values (T, top_k) renormalised, expert ids (T, top_k) int64).
    Experts are chosen by a stable sort of -probs, so equal
    probabilities go to the lower expert, as jax.lax.top_k does."""
    probs = torch.softmax(xt.to(torch.float32) @ params["router"], dim=-1)
    order = torch.sort(-probs, dim=-1, stable=True).indices[:, :cfg.top_k]
    gate_vals = torch.gather(probs, 1, order)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return probs, gate_vals, order


def moe_apply(params: dict, x: torch.Tensor, cfg):
    """x: (B, S, D) -> (y (B, S, D), load-balance aux loss ()): JAX's
    moe_apply, moe_apply_with_drops without the count."""
    return moe_apply_with_drops(params, x, cfg)[:2]


def moe_apply_with_drops(params: dict, x: torch.Tensor, cfg):
    """x: (B, S, D) -> (y (B, S, D), load-balance aux loss (), the
    assignments dropped over capacity (0-d int64 on x's device)).

    Top-k routing with capacity: an assignment past its expert's C slots
    is dropped (its token keeps the shared expert and the residual).
    Kept (expert, slot) pairs are unique, so the dispatch writes the
    buffer without accumulating; the combine sums a token's top_k
    weighted outputs in slot order (JAX's scatter-add over
    repeat(arange(T), top_k)), never by index_add_, whose adds on the
    card come in no fixed order."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    C = moe_capacity(T, cfg)
    xt = x.reshape(T, D)
    probs, gate_vals, expert_ids = moe_route(params, xt, cfg)

    # load balance: E * sum_e (share of top-1 picks_e * mean prob_e)
    me = probs.mean(dim=0)
    ce = F.one_hot(expert_ids[:, 0], E).to(torch.float32).mean(dim=0)
    aux = E * torch.sum(me * ce)

    flat_e = expert_ids.reshape(-1)                          # (T*K,)
    flat_tok = torch.arange(T, device=x.device).repeat_interleave(K)
    pos = _positions_by_expert(flat_e, E)
    keep = pos < C
    buf = x.new_zeros((E, C, D)).index_put(
        (flat_e[keep], pos[keep]), xt[flat_tok[keep]])
    sort_path = getattr(cfg, "moe_dispatch", "onehot") == "sort"
    cap_axis = "expert_cap" if sort_path else None
    buf = logical_shard(buf, "experts", cap_axis, None)

    we = params["experts"]
    h = F.silu(torch.einsum("ecd,edf->ecf", buf, we["w_gate"].to(x.dtype))
               ) * torch.einsum("ecd,edf->ecf", buf, we["w_up"].to(x.dtype))
    h = logical_shard(h, "experts", cap_axis, "expert_out")
    out_buf = torch.einsum("ecf,efd->ecd", h, we["w_down"].to(x.dtype))
    out_buf = logical_shard(out_buf, "experts", cap_axis, None)

    gathered = out_buf[flat_e, torch.where(keep, pos, 0)]    # (T*K, D)
    gathered = torch.where(keep[:, None], gathered,
                           torch.zeros_like(gathered))
    w = (gathered * gate_vals.reshape(-1)[:, None].to(x.dtype)
         ).reshape(T, K, D)
    y = w[:, 0]
    for j in range(1, K):
        y = y + w[:, j]
    if cfg.shared_expert:
        y = y + ffn_apply(params["shared"], xt)
    return y.reshape(B, S, D), aux, (~keep).sum()


# --------------------------------------------------------------------------
# shard_map expert-parallel MoE (the 'shmap' dispatch)
# --------------------------------------------------------------------------
#
# Tokens are split over the batch axes ('pod', 'data') and replicated
# over 'model'; each 'model' shard holds E / ep experts. So dispatch
# needs no communication: each (batch block, model shard) body scatters
# its block's tokens into slots of its own experts. The expert weights
# are FSDP-sharded over the batch axes in JAX and all-gathered a body;
# here a body reads its experts' slice of the global weights, a view
# where they lie on its device (a virtual mesh copies nothing). The
# combine is a psum over 'model' of each block's (T_l, D) partial sums.
# Capacity is enforced per batch block: C_l = moe_capacity(T_l).

def moe_apply_shmap(params: dict, x: torch.Tensor, cfg, mesh):
    """The shard_map twin of moe_apply over `mesh` (a launch.mesh.Mesh).
    x: (B, S, D) global -> (y (B, S, D), aux loss ())."""
    return moe_apply_shmap_with_drops(params, x, cfg, mesh)[:2]


def moe_apply_shmap_with_drops(params: dict, x: torch.Tensor, cfg, mesh):
    """moe_apply_shmap, plus the assignments dropped over the blocks'
    capacities (0-d int64 on x's device).

    Each body: routing of its block's tokens (moe_route: ties to the
    lower expert); me and ce, pmeaned over the batch blocks into the
    load-balance loss; stable positions by expert and the local
    capacity; slot-centric dispatch (each kept assignment of the shard's
    own experts writes its token and gate into its (expert, slot); the
    others, dropped or another shard's, write nothing, as JAX's
    out-of-bounds scatter drops them); the experts' FFN on the gathered
    slot rows; the combine, each slot's gate x output added to its token
    by a sorted index_put(accumulate=True) (never index_add_, whose adds
    on the card come in no fixed order). The blocks' partial outputs
    add over 'model' in shard order; the shared expert is added after."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    batch_axes = batch_axes_of(mesh, ("pod", "data"))
    n_batch = axis_size(mesh, batch_axes)
    model = "model" if "model" in mesh.axis_names else None
    ep = axis_size(mesh, model)
    if E % ep:
        raise ValueError(f"{E} experts do not split over {ep} 'model' "
                         f"shards")
    E_l = E // ep
    T_l = B * S // n_batch
    C_l = moe_capacity(T_l, cfg)
    we = params["experts"]

    def body(rows, si, dev):
        xt = place(x[rows], dev).reshape(-1, D)
        tl = xt.shape[0]
        probs, gate_vals, expert_ids = moe_route(
            {"router": place(params["router"], dev)}, xt, cfg)
        # combine in the activation dtype, as JAX's body does
        gate_vals = gate_vals.to(x.dtype)
        me = probs.mean(dim=0)
        ce = F.one_hot(expert_ids[:, 0], E).to(torch.float32).mean(dim=0)

        flat_e = expert_ids.reshape(-1)
        flat_g = gate_vals.reshape(-1)
        flat_tok = torch.arange(tl, device=dev).repeat_interleave(K)
        pos = _positions_by_expert(flat_e, E)
        e0 = si * E_l
        local = (flat_e >= e0) & (flat_e < e0 + E_l)
        keep = local & (pos < C_l)
        el, pk = flat_e[keep] - e0, pos[keep]
        slot_tok = torch.zeros((E_l, C_l), dtype=torch.long, device=dev)
        slot_tok = slot_tok.index_put((el, pk), flat_tok[keep])
        slot_gate = torch.zeros((E_l, C_l), dtype=x.dtype, device=dev
                                ).index_put((el, pk), flat_g[keep])
        slot_valid = torch.zeros((E_l, C_l), dtype=x.dtype, device=dev
                                 ).index_put((el, pk), torch.ones_like(
                                     flat_g[keep]))
        buf = xt[slot_tok] * slot_valid[..., None]            # (E_l, C_l, D)

        # this shard's experts: JAX's FSDP all-gather, a view here
        wg = place(we["w_gate"][e0:e0 + E_l], dev).to(x.dtype)
        wu = place(we["w_up"][e0:e0 + E_l], dev).to(x.dtype)
        wd = place(we["w_down"][e0:e0 + E_l], dev).to(x.dtype)
        h = F.silu(torch.einsum("ecd,edf->ecf", buf, wg)) * torch.einsum(
            "ecd,edf->ecf", buf, wu)
        out_buf = torch.einsum("ecf,efd->ecd", h, wd)

        weighted = out_buf * (slot_gate * slot_valid)[..., None]
        y = torch.zeros((tl, D), dtype=x.dtype, device=dev).index_put(
            (slot_tok.reshape(-1),), weighted.reshape(-1, D),
            accumulate=True)
        dropped = (local & (pos >= C_l)).sum()
        return y, me, ce, dropped

    ys, mes, ces, drops = [], [], [], []
    for _, parts in map_shards(mesh, model, batch_axes, B, body, x.device):
        y = parts[0][0]
        for p in parts[1:]:
            y = y + p[0]                  # the EP combine, in shard order
        ys.append(y)
        mes.append(parts[0][1])           # routing is the same on every
        ces.append(parts[0][2])           # model shard of a block
        drops.extend(p[3] for p in parts)
    me = torch.stack(mes).sum(dim=0) / n_batch
    ce = torch.stack(ces).sum(dim=0) / n_batch
    aux = E * torch.sum(me * ce)
    y = torch.cat(ys).reshape(B, S, D)
    if cfg.shared_expert:
        y = y + ffn_apply(params["shared"], x.reshape(B * S, D)).reshape(
            B, S, D)
    return y, aux, torch.stack(drops).sum()


# --------------------------------------------------------------------------
# Embedding
# --------------------------------------------------------------------------

def embed_init(gen, vocab: int, d: int, dtype, device=None) -> torch.Tensor:
    dev = gen.device if device is None else device
    return (_draw(gen, (vocab, d), dev) * 0.02).to(dtype)


def embed_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of `table` by `ids` (indexing: its backward on the card is a
    sorted, deterministic index_put_)."""
    return table[ids.long()]


def vocab_block_lookup(block: torch.Tensor, ids: torch.Tensor,
                       start: int) -> torch.Tensor:
    """A vocab-parallel embedding's part: the rows of `block` (the
    table's rows start onwards) for the ids that fall in it, zeros for
    the rest; the parts' sum over the blocks is embed_lookup's."""
    local = ids.long() - start
    inside = (local >= 0) & (local < block.shape[0])
    rows = embed_lookup(block, torch.where(inside, local,
                                           torch.zeros_like(local)))
    return torch.where(inside[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
