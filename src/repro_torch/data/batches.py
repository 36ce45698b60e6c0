"""Synthetic LM, recsys and graph training and serving batches
(counterpart of repro.data.batches).

Each function draws from an explicit torch.Generator (on its own device)
and returns tensors on `device` (None = the card): int32 ids, f32
features. Torch cannot reproduce jax.random's streams, so a batch here
matches the JAX one in layout, dtype, range and statistics, not in its
values; the parity tests carry JAX's own batches across through numpy,
and feed JAX's draws to the deterministic bodies (lm_bigram_batch,
random_graph_from_draws, csr_from_seed).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.gnn import aggregate


def _tensor(x) -> torch.Tensor:
    """A tensor of x; a numpy array (JAX's read-only ones too) copied."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.array(x))
    return torch.as_tensor(x)


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


# --------------------------------------------------------------------------
# Graph batches
# --------------------------------------------------------------------------

def random_graph_from_draws(nodes, senders, receivers, *, d_edge: int,
                            d_out: int) -> dict:
    """make_random_graph's deterministic body: edges |x_s - x_r| over
    the first d_edge features, targets tanh of the sum over each
    receiver's senders' first d_out features (models.gnn.aggregate);
    on the draws' device."""
    nodes = _tensor(nodes).to(torch.float32)
    senders = _tensor(senders).to(nodes.device)
    receivers = _tensor(receivers).to(nodes.device)
    s, r = senders.long(), receivers.long()
    edges = torch.abs(nodes[s, :d_edge] - nodes[r, :d_edge])
    agg = aggregate(nodes[s, :d_out], r, nodes.shape[0], "sum")
    return {"nodes": nodes, "edges": edges,
            "senders": senders.to(torch.int32),
            "receivers": receivers.to(torch.int32),
            "targets": torch.tanh(agg)}


def make_random_graph(gen: torch.Generator, *, n_nodes: int, n_edges: int,
                      d_node: int, d_edge: int, d_out: int,
                      device=None) -> dict:
    """Random graph with smooth targets (a squashed sum of neighbour
    features) so the GNN has learnable signal: nodes (N, d_node) normal,
    senders and receivers (E,) uniform over the nodes, then
    random_graph_from_draws."""
    dev = resolve_device(device)
    nodes = torch.randn((n_nodes, d_node), generator=gen, device=gen.device)
    senders = _randint(gen, 0, n_nodes, (n_edges,))
    receivers = _randint(gen, 0, n_nodes, (n_edges,))
    return random_graph_from_draws(nodes.to(dev), senders.to(dev),
                                   receivers.to(dev), d_edge=d_edge,
                                   d_out=d_out)


def csr_from_seed(seed: int, *, n_nodes: int, avg_degree: int):
    """make_csr_graph's deterministic body: numpy's default_rng(seed)
    draws Poisson(avg_degree) degrees (at least 1) and uniform column
    indices. -> (indptr (N + 1,), indices (nnz,)) int32 numpy arrays."""
    rng = np.random.default_rng(int(seed))
    deg = rng.poisson(avg_degree, n_nodes).astype(np.int64)
    deg = np.maximum(deg, 1)
    indptr = np.zeros(n_nodes + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rng.integers(0, n_nodes, int(indptr[-1]))
    return indptr.astype(np.int32), indices.astype(np.int32)


def make_csr_graph(gen: torch.Generator, *, n_nodes: int, avg_degree: int,
                   device=None):
    """CSR adjacency for the neighbor sampler (the minibatch_lg
    pipeline): numpy seeded from `gen`, then csr_from_seed. ->
    (indptr, indices) int32 tensors on `device`."""
    dev = resolve_device(device)
    seed = int(_randint(gen, 0, 2**31 - 1, ()))
    indptr, indices = csr_from_seed(seed, n_nodes=n_nodes,
                                    avg_degree=avg_degree)
    return (torch.from_numpy(indptr).to(dev),
            torch.from_numpy(indices).to(dev))


def make_molecule_batch(gen: torch.Generator, *, batch: int, n_nodes: int,
                        n_edges: int, d_node: int, d_edge: int, d_out: int,
                        device=None) -> dict:
    """Batched small graphs (the molecule cell): `batch` random graphs
    from `gen` in turn, each leaf stacked on a leading batch dim."""
    graphs = [make_random_graph(gen, n_nodes=n_nodes, n_edges=n_edges,
                                d_node=d_node, d_edge=d_edge, d_out=d_out,
                                device=device) for _ in range(batch)]
    return {k: torch.stack([g[k] for g in graphs]) for k in graphs[0]}
