"""RecSys backbones of the port: DeepFM, SASRec, BERT4Rec, MIND
(counterpart of repro.models.recsys).

Each model is an nn.Module whose parameters keep the JAX tree's names
(`table`, `mlp.w0`, `blocks.0.wqkv`, `bilinear`, ...), drawn from a
torch.Generator in the JAX init's layout and scales; `load_numpy` takes
a JAX `model.init(key)` tree as numpy arrays and `state_numpy` gives it
back. Every model exposes

  loss(batch)                -> (loss, {"loss": loss})
  train_step(opt, batch, lr) -> (opt, {"loss", "grad_norm"}): clip at
                                global norm 1, then Adam, in place
  serve(...)                 -> pointwise scores
  retrieval_scores(...)      -> (B, n_cand): one user against candidates,
                                the utilities of the constrained head
  user_covariates(...)       -> the covariates X of the lambda predictor

The forward keeps the JAX body's order of operations. Every gather is
`table[ids]` indexing, whose backward on the card is a sorted and so
deterministic index_put_ (index_select and F.embedding add atomically:
two trainings would then differ). DeepFM's loss is the stable BCE form
written out, as JAX writes it; masks are -1e30, not -inf; BERT4Rec's
mask token is item 0. DeepFM's retrieval context, a sum of the user's
context-field rows, is a sum-mode bag and runs through
kernels.ops.embedding_bag (the `embedding_bag` kernel on the card); it
sums in slot order, where XLA's sum(axis=1) may not, so it agrees with
JAX to rounding. The inference methods run without autograd.

`logical_axes()` mirrors each model's parameter tree with per-dim
logical axis names (the tables' rows over 'table_rows', the dense
layers replicated); `device="meta"` builds a model's parameters as
shapes only, and `bound(cfg, params)` wraps a given parameter tree
without a copy, so a cell program (configs/recsys_family.py) runs on
the tensors it is handed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint.store import flatten_with_paths, unflatten_like
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import logical_shard
from repro_torch.kernels import ops
from repro_torch.models.layers import _draw, dense_init, rms_norm
from repro_torch.optim import adam_init, adam_update, clip_by_global_norm

NEG_MASK = -1e30


# the JAX module's sum-mode bag is the kernel library's entry point here
embedding_bag = ops.embedding_bag


@dataclass(frozen=True)
class RecsysConfig:
    name: str = "recsys"
    kind: str = "deepfm"           # deepfm | sasrec | bert4rec | mind
    # deepfm
    n_sparse: int = 39
    field_vocab: int = 1_000_000
    embed_dim: int = 10
    mlp_dims: tuple = (400, 400, 400)
    # sequence models
    n_items: int = 1_000_000
    seq_len: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    # mind
    n_interests: int = 4
    capsule_iters: int = 3
    # training
    n_neg: int = 127               # sampled-softmax negatives
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32
    # the JAX package's sharding variant (replicate the table instead of
    # row-sharding it); one card holds the whole table either way
    replicate_tables: bool = False

    @property
    def n_params(self) -> int:
        if self.kind == "deepfm":
            emb = self.n_sparse * self.field_vocab * (self.embed_dim + 1)
            d_in = self.n_sparse * self.embed_dim
            mlp = 0
            prev = d_in
            for h in self.mlp_dims:
                mlp += prev * h + h
                prev = h
            return emb + mlp + prev + 1
        return self.n_items * self.embed_dim  # dominated by the item table


class _Node(nn.Module):
    """A dict of a parameter tree: tensors become parameters under their
    keys, dicts child nodes, lists ModuleLists of nodes."""

    def __init__(self, tree: dict):
        super().__init__()
        _register(self, tree)

    def tree(self) -> dict:
        return _tree_of(self)


def _register(module: nn.Module, tree: dict) -> None:
    module._tree_keys = list(tree)
    for k, v in tree.items():
        if isinstance(v, dict):
            module.add_module(k, _Node(v))
        elif isinstance(v, list):
            module.add_module(k, nn.ModuleList([_Node(x) for x in v]))
        else:
            module.register_parameter(k, nn.Parameter(v))


def _tree_of(module: nn.Module) -> dict:
    out = {}
    for k in module._tree_keys:
        v = getattr(module, k)
        if isinstance(v, _Node):
            out[k] = v.tree()
        elif isinstance(v, nn.ModuleList):
            out[k] = [m.tree() for m in v]
        else:
            out[k] = v
    return out


def _ids(x, dev: torch.device) -> torch.Tensor:
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()                 # torch refuses to view read-only memory
    return torch.as_tensor(x, device=dev).long()


class _RecsysModel(nn.Module):
    """Parameters on one device (None = the card), drawn from `gen` (on
    its own device; a generator on `device` seeded 0 if None)."""

    def __init__(self, cfg: RecsysConfig, *,
                 gen: torch.Generator | None = None, device=None):
        super().__init__()
        meta = device is not None and torch.device(device).type == "meta"
        dev = torch.device("meta") if meta else resolve_device(device)
        self.cfg = cfg
        if gen is None and not meta:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
        tree = self._init(gen, dev if meta else gen.device)
        _register(self, unflatten_like(tree, {
            k: v.to(dev) for k, v in flatten_with_paths(tree).items()}))

    @classmethod
    def bound(cls, cfg: RecsysConfig, params: dict) -> "_RecsysModel":
        """A model over `params` (a tree of this model's paths), read
        without a copy; training it rebinds its own parameters and
        leaves the given tensors as they are."""
        self = cls.__new__(cls)
        nn.Module.__init__(self)
        self.cfg = cfg
        _register(self, unflatten_like(params, {
            k: v.detach() for k, v in flatten_with_paths(params).items()}))
        return self

    def logical_axes(self) -> dict:
        return recsys_logical_axes(self.cfg)

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def params(self) -> dict:
        """The parameter tree (nested dicts and lists of parameters)."""
        return _tree_of(self)

    # -- carrying parameters across ---------------------------------------

    def load_numpy(self, params) -> "_RecsysModel":
        """Take a JAX `init` tree (arrays of the same paths and shapes)
        as this model's parameters."""
        src = flatten_with_paths(params)
        dst = flatten_with_paths(self.params())
        if set(src) != set(dst):
            raise ValueError(f"parameter paths differ: "
                             f"{sorted(set(src) ^ set(dst))}")
        with torch.no_grad():
            for k, p in dst.items():
                v = torch.from_numpy(np.array(src[k]))
                if tuple(v.shape) != tuple(p.shape):
                    raise ValueError(f"{k}: {tuple(v.shape)} != "
                                     f"{tuple(p.shape)}")
                p.copy_(v.to(p.dtype))
        return self

    def state_numpy(self):
        flat = flatten_with_paths(self.params())
        return unflatten_like(self.params(), {
            k: v.detach().cpu().numpy() for k, v in flat.items()})

    # -- training ---------------------------------------------------------

    def init_opt(self):
        """Adam's zero state over the flattened parameters."""
        flat = flatten_with_paths(self.params())
        return adam_init({k: p.detach() for k, p in flat.items()},
                         device=self.device)

    def grads(self, batch: dict):
        """(loss, metrics, gradient tree) of a batch."""
        tree = self.params()
        flat = flatten_with_paths(tree)
        loss, metrics = self.loss(batch)
        g = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
        # a leaf the loss does not read (MIND's `pos`) gets a zero
        # gradient, as jax.grad gives it
        g = {k: torch.zeros_like(p) if gk is None else gk
             for (k, p), gk in zip(flat.items(), g)}
        return loss, metrics, unflatten_like(tree, g)

    def functional_step(self, params: dict, opt_state, batch: dict, *,
                        lr=1e-3):
        """One train_step run as a function of (params, opt): the module
        reads `params` (no copy), steps, and its new tensors come back as
        the next state's: (new params, new opt state, metrics)."""
        flat = flatten_with_paths(params)
        for k, p in flatten_with_paths(self.params()).items():
            p.data = flat[k]
        opt_state, metrics = self.train_step(opt_state, batch, lr=lr)
        new = {k: p.detach() for k, p in flatten_with_paths(
            self.params()).items()}
        return unflatten_like(params, new), opt_state, metrics

    def train_step(self, opt_state, batch: dict, *, lr=1e-3):
        """One step of the JAX package's generic train step: gradients,
        clip at global norm 1, Adam. Updates the parameters in place;
        returns (opt_state, {"loss", "grad_norm"})."""
        _, metrics, grads = self.grads(batch)
        grads, gnorm = clip_by_global_norm(grads, 1.0)
        flat = flatten_with_paths(self.params())
        new, opt_state = adam_update(
            flatten_with_paths(grads), opt_state,
            {k: p.detach() for k, p in flat.items()}, lr=lr)
        with torch.no_grad():
            for k, p in flat.items():
                p.data = new[k]
        metrics = {k: v.detach() for k, v in metrics.items()}
        return opt_state, dict(metrics, grad_norm=gnorm)


# --------------------------------------------------------------------------
# DeepFM
# --------------------------------------------------------------------------

class DeepFM(_RecsysModel):
    """Factorization-machine + deep tower CTR model (arXiv:1703.04247).

    Input: (B, n_sparse) global ids (field f uses rows
    [f*field_vocab, (f+1)*field_vocab)) into one flat
    (n_sparse*field_vocab, D) table."""

    def _init(self, gen, g):
        cfg = self.cfg
        V = cfg.n_sparse * cfg.field_vocab

        def normal(shape, scale):
            return (_draw(gen, shape, g) * scale).to(cfg.param_dtype)

        params = {
            "table": normal((V, cfg.embed_dim), 0.01),
            "w_linear": normal((V, 1), 0.01),
            "bias": torch.zeros((), dtype=cfg.param_dtype, device=g),
            "mlp": {},
        }
        prev = cfg.n_sparse * cfg.embed_dim
        for i, h in enumerate(cfg.mlp_dims):
            params["mlp"][f"w{i}"] = dense_init(gen, (prev, h),
                                                cfg.param_dtype, device=g)
            params["mlp"][f"b{i}"] = torch.zeros((h,), dtype=cfg.param_dtype,
                                                 device=g)
            prev = h
        params["mlp"]["w_out"] = dense_init(gen, (prev, 1), cfg.param_dtype,
                                            device=g)
        return params

    def forward(self, ids) -> torch.Tensor:
        """ids: (B, n_sparse) -> logits (B,)."""
        cfg, p = self.cfg, self.params()
        ids = _ids(ids, self.device)
        B = ids.shape[0]
        flat = ids.reshape(-1)
        emb = p["table"][flat].reshape(B, cfg.n_sparse, cfg.embed_dim)
        emb = logical_shard(emb, "batch", None, None)
        # FM 2nd order: 0.5 * ((sum v)^2 - sum v^2) summed over dim
        s = torch.sum(emb, dim=1)
        fm2 = 0.5 * torch.sum(s * s - torch.sum(emb * emb, dim=1), dim=-1)
        # 1st order
        lin = p["w_linear"][flat]
        fm1 = torch.sum(lin.reshape(B, cfg.n_sparse), dim=1)
        # deep tower
        h = emb.reshape(B, cfg.n_sparse * cfg.embed_dim)
        for i in range(len(cfg.mlp_dims)):
            h = torch.relu(h @ p["mlp"][f"w{i}"] + p["mlp"][f"b{i}"])
        deep = (h @ p["mlp"]["w_out"])[:, 0]
        return fm1 + fm2 + deep + p["bias"]

    def loss(self, batch: dict):
        logits = self.forward(batch["ids"])
        y = torch.as_tensor(batch["labels"],
                            device=self.device).to(torch.float32)
        loss = torch.mean(torch.clamp_min(logits, 0) - logits * y
                          + torch.log1p(torch.exp(-torch.abs(logits))))
        return loss, {"loss": loss}

    @torch.no_grad()
    def serve(self, ids) -> torch.Tensor:
        return torch.sigmoid(self.forward(ids))

    @torch.no_grad()
    def user_covariates(self, ids) -> torch.Tensor:
        """Mean field embedding = the user-side covariate vector X. Any
        number of fields (context-only ids at retrieval). A gather and a
        mean: a bag weighted by 1/n would round differently."""
        ids = _ids(ids, self.device)
        B = ids.shape[0]
        emb = self.table[ids.reshape(-1)]
        return torch.mean(emb.reshape(B, -1, self.cfg.embed_dim), dim=1)

    @torch.no_grad()
    def context_sum(self, user_ids) -> torch.Tensor:
        """(B, D): the sum of each user's context-field rows, one bag a
        user through kernels.ops.embedding_bag."""
        return ops.embedding_bag(self.table, _ids(user_ids, self.device),
                                 device=self.device)

    @torch.no_grad()
    def retrieval_scores(self, user_ids, cand_ids) -> torch.Tensor:
        """user_ids: (B, n_sparse-1) context fields; cand_ids: (n_cand,)
        candidate values of the item field (field 0). Scores (B, n_cand):
        the FM interaction of each candidate's embedding with the summed
        context, plus the candidate's first-order weight."""
        ctx = self.context_sum(user_ids)                        # (B, D)
        cand_ids = _ids(cand_ids, self.device)
        cand = logical_shard(self.table[cand_ids], "candidates", None)
        lin = self.w_linear[cand_ids][:, 0]
        return ctx @ cand.T + lin[None, :]


# --------------------------------------------------------------------------
# Shared transformer block for SASRec / BERT4Rec
# --------------------------------------------------------------------------

def _block_init(gen, d: int, n_heads: int, d_ff: int, dtype, g) -> dict:
    del n_heads
    zeros = torch.zeros((d,), dtype=dtype, device=g)
    return {
        "wqkv": dense_init(gen, (d, 3 * d), dtype, device=g),
        "wo": dense_init(gen, (d, d), dtype, device=g),
        "w1": dense_init(gen, (d, d_ff), dtype, device=g),
        "w2": dense_init(gen, (d_ff, d), dtype, device=g),
        "ln1": zeros,
        "ln2": zeros.clone(),
    }


_BLOCK_AXES = {
    "wqkv": ("dense_in", "dense_out"),
    "wo": ("dense_in", "dense_out"),
    "w1": ("dense_in", "dense_out"),
    "w2": ("dense_in", "dense_out"),
    "ln1": (None,),
    "ln2": (None,),
}


def recsys_logical_axes(cfg: RecsysConfig) -> dict:
    """The parameter tree's logical axes (JAX's `logical_axes()` of the
    cfg.kind model)."""
    if cfg.kind == "deepfm":
        axes = {
            "table": ("table_rows", "table_dim"),
            "w_linear": ("table_rows", None),
            "bias": (),
            "mlp": {},
        }
        for i in range(len(cfg.mlp_dims)):
            axes["mlp"][f"w{i}"] = ("dense_in", "dense_out")
            axes["mlp"][f"b{i}"] = (None,)
        axes["mlp"]["w_out"] = ("dense_in", None)
        return axes
    axes = {
        "items": ("table_rows", "table_dim"),
        "pos": (None, None),
        "blocks": [dict(_BLOCK_AXES) for _ in range(cfg.n_blocks)],
        "final_ln": (None,),
    }
    if cfg.kind == "mind":
        axes["bilinear"] = ("dense_in", "dense_out")
    return axes


def _block_apply(p: dict, x: torch.Tensor, n_heads: int,
                 causal: bool) -> torch.Tensor:
    B, S, D = x.shape
    Dh = D // n_heads
    h = rms_norm(x, p["ln1"])
    qkv = (h @ p["wqkv"]).reshape(B, S, 3, n_heads, Dh)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(Dh)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=x.device))
        logits = logits.masked_fill(~mask, NEG_MASK)
    probs = torch.softmax(logits, dim=-1)
    att = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(B, S, D)
    x = x + att @ p["wo"]
    h = rms_norm(x, p["ln2"])
    return x + torch.relu(h @ p["w1"]) @ p["w2"]


def _masked_rows(items: torch.Tensor, seq: torch.Tensor) -> torch.Tensor:
    """items[seq] with padding (ids < 0) rows zeroed."""
    valid = seq >= 0
    e = items[torch.where(valid, seq, 0)]
    return e * valid[..., None].to(e.dtype)


def _sampled_softmax(items, q, pos_ids, neg_ids) -> torch.Tensor:
    """q: (B, D); pos: (B,); neg: (B, n_neg) -> mean CE loss of the
    positive against its negatives (logsumexp of the concatenation)."""
    pos_e = items[pos_ids]
    neg_e = items[neg_ids]
    pos_logit = torch.sum(q * pos_e, dim=-1, keepdim=True)     # (B, 1)
    neg_logit = torch.einsum("bd,bnd->bn", q, neg_e)
    logits = torch.cat([pos_logit, neg_logit], dim=-1)
    lse = torch.logsumexp(logits, dim=-1)
    return torch.mean(lse - pos_logit[:, 0])


class _SeqRecBase(_RecsysModel):
    """Shared machinery for sequential recommenders."""

    causal = True

    def _init(self, gen, g):
        cfg = self.cfg

        def normal(shape):
            return (_draw(gen, shape, g) * 0.02).to(cfg.param_dtype)

        return {
            "items": normal((cfg.n_items, cfg.embed_dim)),
            "pos": normal((cfg.seq_len, cfg.embed_dim)),
            "blocks": [_block_init(gen, cfg.embed_dim, cfg.n_heads,
                                   4 * cfg.embed_dim, cfg.param_dtype, g)
                       for _ in range(cfg.n_blocks)],
            "final_ln": torch.zeros((cfg.embed_dim,), dtype=cfg.param_dtype,
                                    device=g),
        }

    def encode(self, seq) -> torch.Tensor:
        """seq: (B, S) item ids (< 0 = padding) -> (B, S, D) states."""
        p = self.params()
        seq = _ids(seq, self.device)
        x = _masked_rows(p["items"], seq)
        x = x + p["pos"][None, :seq.shape[1]]
        x = logical_shard(x, "batch", "seq", None)
        for blk in p["blocks"]:
            x = _block_apply(blk, x, self.cfg.n_heads, self.causal)
        return rms_norm(x, p["final_ln"])

    def user_repr(self, seq) -> torch.Tensor:
        """(B, D): the last position's state (the retrieval query)."""
        return self.encode(seq)[:, -1]

    @torch.no_grad()
    def user_covariates(self, seq) -> torch.Tensor:
        return self.user_repr(seq)

    @torch.no_grad()
    def retrieval_scores(self, seq, cand_ids) -> torch.Tensor:
        """(B, n_cand): the user's query dotted with each candidate."""
        q = self.user_repr(seq)                                 # (B, D)
        cand = logical_shard(self.items[_ids(cand_ids, self.device)],
                             "candidates", None)                # (n, D)
        return q @ cand.T

    @torch.no_grad()
    def serve(self, seq, target) -> torch.Tensor:
        """Pointwise scores of (user sequence, target item) pairs."""
        q = self.user_repr(seq)
        t = self.items[_ids(target, self.device)]
        return torch.sum(q * t, dim=-1)


class SASRec(_SeqRecBase):
    """Self-attentive sequential recommendation (arXiv:1808.09781):
    the state at position t scores item t+1 against sampled negatives."""

    causal = True

    def loss(self, batch: dict):
        dev = self.device
        h = self.encode(batch["seq"])                           # (B, S, D)
        B, S, D = h.shape
        loss = _sampled_softmax(
            self.items, h.reshape(B * S, D),
            _ids(batch["pos"], dev).reshape(-1),
            _ids(batch["neg"], dev).reshape(B * S, -1))
        return loss, {"loss": loss}


class BERT4Rec(_SeqRecBase):
    """Bidirectional masked-item model (arXiv:1904.06690); encoder only."""

    causal = False

    def loss(self, batch: dict):
        dev = self.device
        h = self.encode(batch["seq"])
        pos = _ids(batch["mask_pos"], dev)
        q = torch.gather(h, 1, pos[..., None].expand(-1, -1, h.shape[2]))
        B, M, D = q.shape
        loss = _sampled_softmax(
            self.items, q.reshape(B * M, D),
            _ids(batch["mask_target"], dev).reshape(-1),
            _ids(batch["neg"], dev).reshape(B * M, -1))
        return loss, {"loss": loss}


class MIND(_SeqRecBase):
    """Multi-Interest Network with Dynamic routing (arXiv:1904.08030):
    behaviour sequence -> n_interests capsules by B2I routing
    (`capsule_iters` rounds, softmax over the capsules, squash);
    label-aware attention at training; serve = max over interests."""

    causal = False

    def _init(self, gen, g):
        params = super()._init(gen, g)
        cfg = self.cfg
        params["bilinear"] = dense_init(gen, (cfg.embed_dim, cfg.embed_dim),
                                        cfg.param_dtype, device=g)
        return params

    @staticmethod
    def _squash(x: torch.Tensor) -> torch.Tensor:
        n2 = torch.sum(x * x, dim=-1, keepdim=True)
        return (n2 / (1.0 + n2)) * x / torch.sqrt(n2 + 1e-9)

    def interests(self, seq) -> torch.Tensor:
        """(B, n_interests, D) capsules from the behaviour sequence."""
        cfg = self.cfg
        seq = _ids(seq, self.device)
        valid = seq >= 0
        eh = _masked_rows(self.items, seq) @ self.bilinear      # (B, S, D)
        B, S, D = eh.shape
        K = cfg.n_interests
        b_logit = torch.zeros((B, K, S), dtype=eh.dtype, device=eh.device)
        neg_mask = torch.where(valid[:, None, :], 0.0,
                               NEG_MASK).to(eh.dtype)
        u = torch.zeros((B, K, D), dtype=eh.dtype, device=eh.device)
        for _ in range(cfg.capsule_iters):
            w = torch.softmax(b_logit + neg_mask, dim=1)        # over capsules
            u = self._squash(torch.einsum("bks,bsd->bkd", w, eh))
            b_logit = b_logit + torch.einsum("bkd,bsd->bks", u, eh)
        return u

    def user_repr(self, seq) -> torch.Tensor:
        # single-vector fallback: mean of interests
        return torch.mean(self.interests(seq), dim=1)

    @torch.no_grad()
    def user_covariates(self, seq) -> torch.Tensor:
        u = self.interests(seq)
        return u.reshape(u.shape[0], -1)

    @torch.no_grad()
    def retrieval_scores(self, seq, cand_ids) -> torch.Tensor:
        """max over interests of interest . candidate (MIND's serving
        rule)."""
        u = self.interests(seq)                                 # (B, K, D)
        cand = logical_shard(self.items[_ids(cand_ids, self.device)],
                             "candidates", None)                # (n, D)
        return torch.amax(torch.einsum("bkd,nd->bkn", u, cand), dim=1)

    def loss(self, batch: dict):
        dev = self.device
        u = self.interests(batch["seq"])                        # (B, K, D)
        pos = _ids(batch["pos"], dev)
        att = torch.softmax(
            torch.einsum("bkd,bd->bk", u, self.items[pos]) * 2.0, dim=-1)
        q = torch.einsum("bk,bkd->bd", att, u)
        loss = _sampled_softmax(self.items, q, pos,
                                _ids(batch["neg"], dev))
        return loss, {"loss": loss}


RECSYS_REGISTRY = {
    "deepfm": DeepFM,
    "sasrec": SASRec,
    "bert4rec": BERT4Rec,
    "mind": MIND,
}
