"""Synthetic recsys training and serving batches (counterpart of the
recsys half of repro.data.batches).

Each function draws from an explicit torch.Generator (on its own device)
and returns int32 tensors on `device` (None = the card). Torch cannot
reproduce jax.random's streams, so a batch here matches the JAX one in
layout, dtype, range and statistics, not in its values; the parity
tests carry JAX's own batches across through numpy.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device


def _randint(gen: torch.Generator, lo: int, hi: int, shape) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device)


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
