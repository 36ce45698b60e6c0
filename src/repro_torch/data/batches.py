"""Synthetic LM and recsys training and serving batches (counterpart of
the LM and recsys parts of repro.data.batches).

Each function draws from an explicit torch.Generator (on its own device)
and returns int32 tensors on `device` (None = the card). Torch cannot
reproduce jax.random's streams, so a batch here matches the JAX one in
layout, dtype, range and statistics, not in its values; the parity
tests carry JAX's own batches across through numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _randint(gen: torch.Generator, lo: int, hi: int, shape) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device)


def lm_bigram_batch(first, noise, vocab: int) -> dict:
    """JAX's bigram recurrence on given draws: first (B, 1) and noise
    (B, S) integers give tokens[:, 0] = first and tokens[:, t + 1] =
    (3 tokens[:, t] + noise[:, t]) mod vocab; the labels are the tokens
    shifted left, the last one the recurrence's next step. Runs on the
    host in int64; returns int32 {tokens, labels} (B, S) on the CPU."""
    first = torch.as_tensor(np.array(first) if isinstance(
        first, np.ndarray) else first).to("cpu", torch.int64).reshape(-1)
    noise = torch.as_tensor(np.array(noise) if isinstance(
        noise, np.ndarray) else noise).to("cpu", torch.int64)
    B, S = noise.shape
    seq = torch.empty((B, S + 1), dtype=torch.int64)
    seq[:, 0] = first
    for t in range(S):
        seq[:, t + 1] = (3 * seq[:, t] + noise[:, t]) % vocab
    return {"tokens": seq[:, :S].to(torch.int32),
            "labels": seq[:, 1:].to(torch.int32)}


def make_lm_batch(gen: torch.Generator, *, batch: int, seq: int, vocab: int,
                  device=None) -> dict:
    """Causal-LM batch with learnable bigram structure, next token =
    (3 * token + noise) mod vocab with noise in [0, 7): first (B, 1) and
    noise (B, S) drawn from `gen`, then lm_bigram_batch. {tokens,
    labels} (B, S) int32 on `device` (None = the card)."""
    dev = resolve_device(device)
    first = _randint(gen, 0, vocab, (batch, 1))
    noise = _randint(gen, 0, 7, (batch, seq))
    out = lm_bigram_batch(first, noise, vocab)
    return {k: v.to(dev) for k, v in out.items()}


def make_deepfm_batch(gen: torch.Generator, *, batch: int, n_sparse: int,
                      field_vocab: int, device=None) -> dict:
    """CTR batch: per-field global ids (field f takes rows
    [f * field_vocab, (f + 1) * field_vocab)) and clicks whose rate
    rises with the share of odd local ids: {ids (B, n_sparse),
    labels (B,)}."""
    dev = resolve_device(device)
    local = _randint(gen, 0, field_vocab, (batch, n_sparse))
    offsets = torch.arange(n_sparse, device=local.device) * field_vocab
    ids = local + offsets[None, :]
    click_p = 0.2 + 0.6 * torch.mean((local % 2).to(torch.float32), dim=1)
    labels = (torch.rand((batch,), generator=gen, device=gen.device)
              < click_p).to(torch.int32)
    return {"ids": ids.to(torch.int32).to(dev), "labels": labels.to(dev)}


def make_seqrec_batch(gen: torch.Generator, *, batch: int, seq_len: int,
                      n_items: int, n_neg: int, kind: str = "sasrec",
                      n_mask: int = 8, device=None) -> dict:
    """Random-walk item sequences (steps in [-3, 3], modulo n_items).
    sasrec: {seq, pos = next items (B, S), neg (B, S, n_neg)}; bert4rec:
    {seq with item 0 (the mask token) at mask_pos, mask_pos (B, n_mask),
    mask_target, neg (B, n_mask, n_neg)}; mind: {seq, pos = the item
    after the last (B,), neg (B, n_neg)}."""
    if kind not in ("sasrec", "bert4rec", "mind"):
        raise ValueError(kind)
    dev = resolve_device(device)
    start = _randint(gen, 0, n_items, (batch, 1))
    steps = _randint(gen, -3, 4, (batch, seq_len))
    seq = (start + torch.cumsum(steps, dim=1)) % n_items
    if kind == "sasrec":
        out = {"seq": seq, "pos": (seq + 1) % n_items,
               "neg": _randint(gen, 0, n_items, (batch, seq_len, n_neg))}
    elif kind == "bert4rec":
        n_mask = min(n_mask, seq_len)
        mask_pos = _randint(gen, 0, seq_len, (batch, n_mask))
        target = torch.gather(seq, 1, mask_pos)
        masked = seq.clone()
        rows = torch.arange(batch, device=seq.device)[:, None]
        masked[rows.expand_as(mask_pos), mask_pos] = 0
        out = {"seq": masked, "mask_pos": mask_pos, "mask_target": target,
               "neg": _randint(gen, 0, n_items, (batch, n_mask, n_neg))}
    else:
        out = {"seq": seq, "pos": (seq[:, -1] + 1) % n_items,
               "neg": _randint(gen, 0, n_items, (batch, n_neg))}
    return {k: v.to(torch.int32).to(dev) for k, v in out.items()}
