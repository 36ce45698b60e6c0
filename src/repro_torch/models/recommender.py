"""The paper's Appendix-B recommender, an embedding-MLP rating model
(counterpart of repro.models.recommender).

User and item embeddings of width 20 and per-rating intercept vectors
of width 5; concat(e_u, e_i) -> 15 hidden -> ReLU -> dropout 0.1 -> 5
logits, plus the user's and the item's intercepts; softmax over the
ratings 1..5, whose probability-weighted sum is the predicted rating.
Trained with Adam (lr 0.01), batch 200, cross-entropy. The learned user
embeddings are the covariates X of the shadow-price predictors, and
`utilities` gives each user's utility vector u in [1, 5] over every item.

The forward keeps the JAX one's order: the embedding lookups are plain
gathers (their gradients are scatter-adds), dropout is h * keep / (1 - p)
with keep drawn from the caller's generator, and the Adam update
(optim.adam) stays dense over the whole tables. The parameters keep the
JAX names, so `load_numpy` / `state_numpy` carry them across.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init
from repro_torch.optim import adam_init, adam_update

PARAM_NAMES = ("user_emb", "item_emb", "user_int", "item_int", "w1", "b1",
               "w2", "b2")


@dataclass(frozen=True)
class RecommenderConfig:
    name: str = "paper_recommender"
    n_users: int = 1000
    n_items: int = 1000
    d_embed: int = 20
    n_ratings: int = 5
    d_hidden: int = 15
    dropout: float = 0.1
    dtype: torch.dtype = torch.float32

    @property
    def n_params(self) -> int:
        emb = (self.n_users + self.n_items) * (self.d_embed + self.n_ratings)
        mlp = (2 * self.d_embed) * self.d_hidden + self.d_hidden
        out = self.d_hidden * self.n_ratings + self.n_ratings
        return emb + mlp + out


def _logits(p: dict, uid, iid, keep, dropout: float) -> torch.Tensor:
    """(B,) user ids x (B,) item ids -> (B, n_ratings) logits under the
    parameters `p`; `keep` (B, d_hidden) bool masks the hidden units,
    None for no dropout."""
    h = torch.cat([p["user_emb"][uid], p["item_emb"][iid]], dim=-1)
    h = torch.relu(h @ p["w1"] + p["b1"])
    if keep is not None:
        h = h * keep / (1.0 - dropout)
    logits = h @ p["w2"] + p["b2"]
    return logits + p["user_int"][uid] + p["item_int"][iid]


def _nll(logits, rating) -> torch.Tensor:
    """Mean cross-entropy of ratings 1..n against the logits."""
    logp = torch.log_softmax(logits, dim=-1)
    labels = (rating - 1).long()
    return -torch.mean(torch.gather(logp, 1, labels[:, None]))


class PaperRecommender(nn.Module):
    """The recommender's parameters live on one device (None = the card);
    they are drawn from `gen` (on its own device) as the JAX init draws
    them: embeddings N(0, 0.1^2), intercepts and biases zero, w1 and w2
    by dense_init."""

    def __init__(self, cfg: RecommenderConfig, *,
                 gen: torch.Generator | None = None, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
        g = gen.device

        def normal(shape, scale):
            return torch.randn(shape, generator=gen, device=g) * scale

        init = {
            "user_emb": normal((cfg.n_users, cfg.d_embed), 0.1),
            "item_emb": normal((cfg.n_items, cfg.d_embed), 0.1),
            "user_int": torch.zeros((cfg.n_users, cfg.n_ratings)),
            "item_int": torch.zeros((cfg.n_items, cfg.n_ratings)),
            "w1": dense_init(gen, (2 * cfg.d_embed, cfg.d_hidden), cfg.dtype),
            "b1": torch.zeros((cfg.d_hidden,)),
            "w2": dense_init(gen, (cfg.d_hidden, cfg.n_ratings), cfg.dtype),
            "b2": torch.zeros((cfg.n_ratings,)),
        }
        for name in PARAM_NAMES:
            self.register_parameter(name, nn.Parameter(init[name].to(dev)))
        self.register_buffer("rating_values",
                             torch.arange(1.0, cfg.n_ratings + 1, device=dev),
                             persistent=False)

    @property
    def device(self) -> torch.device:
        return self.user_emb.device

    def params(self) -> dict:
        return {name: getattr(self, name) for name in PARAM_NAMES}

    # -- carrying parameters across ---------------------------------------

    def load_numpy(self, params: dict) -> "PaperRecommender":
        """Take the JAX recommender's parameter dict (arrays of the same
        names and shapes) as this model's parameters."""
        with torch.no_grad():
            for name in PARAM_NAMES:
                src = torch.from_numpy(np.array(params[name]))
                dst = getattr(self, name)
                if tuple(src.shape) != tuple(dst.shape):
                    raise ValueError(f"{name}: {tuple(src.shape)} != "
                                     f"{tuple(dst.shape)}")
                dst.copy_(src.to(dst.dtype))
        return self

    def state_numpy(self) -> dict:
        return {k: v.detach().cpu().numpy() for k, v in self.params().items()}

    # -- forward ----------------------------------------------------------

    def _keep(self, shape, gen):
        """The dropout mask: units kept with probability 1 - dropout,
        drawn from `gen`; None without a generator or dropout."""
        if gen is None or self.cfg.dropout <= 0:
            return None
        return (torch.rand(shape, generator=gen, device=gen.device)
                < 1.0 - self.cfg.dropout).to(self.device)

    def rating_logits(self, uid, iid, *, gen=None) -> torch.Tensor:
        """(B,) user ids x (B,) item ids -> (B, n_ratings) rating logits;
        dropout on the hidden units when a generator is given."""
        uid, iid = self._ids(uid), self._ids(iid)
        keep = self._keep((uid.shape[0], self.cfg.d_hidden), gen)
        return _logits(self.params(), uid, iid, keep, self.cfg.dropout)

    @torch.no_grad()
    def predict_rating(self, uid, iid) -> torch.Tensor:
        """Point prediction in [1, n_ratings]: probability-weighted sum."""
        probs = torch.softmax(self.rating_logits(uid, iid), dim=-1)
        return probs @ self.rating_values

    @torch.no_grad()
    def utilities(self, uid) -> torch.Tensor:
        """(B,) user ids -> (B, n_items) utility matrix u in [1, 5]."""
        uid = self._ids(uid)
        B, n_items = uid.shape[0], self.cfg.n_items
        uid_g = torch.repeat_interleave(uid, n_items)
        iid_g = torch.arange(n_items, device=self.device).repeat(B)
        return self.predict_rating(uid_g, iid_g).reshape(B, n_items)

    @torch.no_grad()
    def user_covariates(self, uid) -> torch.Tensor:
        """The learned user embeddings: the paper's covariates X."""
        return self.user_emb[self._ids(uid)].clone()

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(ids, device=self.device).long()

    # -- training (Appendix B) ----------------------------------------------

    def loss(self, batch: dict, *, gen=None):
        """(nll, {"loss": nll}) of a batch {uid, iid, rating}."""
        logits = self.rating_logits(batch["uid"], batch["iid"], gen=gen)
        nll = _nll(logits, self._ids(batch["rating"]))
        return nll, {"loss": nll}

    def train(self, data=True, *, gen: torch.Generator | None = None,
              epochs: int = 5, batch_size: int = 200, lr: float = 0.01):
        """Mini-batch Adam per Appendix B over `data` {uid, iid, rating}
        (flat tensors of observed ratings): each epoch a permutation of
        the ratings from `gen`, floor(n / batch_size) batches, dropout
        masks from `gen`. Updates the parameters in place and returns
        each epoch's last batch loss. (`train(True)` / `train(False)`,
        as nn.Module.eval calls it, only sets the module's mode.)"""
        if isinstance(data, bool):
            return super().train(data)
        if gen is None:
            raise ValueError("train needs a generator for the batch order "
                             "and the dropout masks")
        dev = self.device
        data = {k: torch.as_tensor(v, device=dev) for k, v in data.items()}
        n = data["uid"].shape[0]
        steps = max(n // batch_size, 1)
        params = {k: v.detach() for k, v in self.params().items()}
        opt = adam_init(params, device=dev)
        losses = []
        for _ in range(epochs):
            perm = torch.randperm(n, generator=gen, device=gen.device).to(dev)
            for s in range(steps):
                idx = perm[s * batch_size:(s + 1) * batch_size]
                uid, iid = data["uid"][idx].long(), data["iid"][idx].long()
                leaves = {k: v.requires_grad_(True)
                          for k, v in params.items()}
                keep = self._keep((idx.shape[0], self.cfg.d_hidden), gen)
                loss = _nll(_logits(leaves, uid, iid, keep, self.cfg.dropout),
                            data["rating"][idx])
                grads = torch.autograd.grad(loss, list(leaves.values()))
                params, opt = adam_update(dict(zip(leaves, grads)), opt,
                                          params, lr=lr)
            losses.append(float(loss.detach()))
        with torch.no_grad():
            for k, v in params.items():
                getattr(self, k).copy_(v)
        return losses
