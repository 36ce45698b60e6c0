"""Synthetic matched-statistics datasets for the paper's experiments
(counterpart of repro.data.synthetic).

MovieLens 25M and YOW are not available offline; these generators give
the statistical shape the experiments depend on: latent-factor ratings
1..5 for the Appendix-B recommender to learn, binary item topics at the
paper's rates (MovieLens: 4 tags at 5% and a release year; YOW: 8 topics
at the Table 1b shares) and the Table 1 constraint sets per scenario.

Everything is drawn from a torch.Generator. `_split` derives one
generator per stage from it, as the JAX module splits its key, so a
stage's draws do not depend on how many the others take. The JAX
package draws with jax.random, which torch cannot repeat: the two
packages' data agree in law, not in values; the tests carry the JAX
side's arrays across to compare the arithmetic.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.constraints import (
    ConstraintSet,
    dcg_discount,
    make_constraints,
)
from repro_torch.device import resolve_device
from repro_torch.models.recommender import PaperRecommender, RecommenderConfig

# --------------------------------------------------------------------------
# Latent-factor interaction data (feeds the Appendix-B recommender)
# --------------------------------------------------------------------------


def _split(gen: torch.Generator, n: int, dev: torch.device) -> list:
    """n generators on `dev`, each seeded by one draw from `gen`."""
    seeds = torch.randint(0, 2**62, (n,), generator=gen, device=gen.device)
    out = []
    for s in seeds.tolist():
        g = torch.Generator(device=dev)
        g.manual_seed(int(s))
        out.append(g)
    return out


@dataclass(frozen=True)
class InteractionData:
    n_users: int
    n_items: int
    uid: torch.Tensor         # (n_obs,) int64
    iid: torch.Tensor         # (n_obs,) int64
    rating: torch.Tensor      # (n_obs,) int32 in 1..5
    true_user: torch.Tensor   # (n_users, d_latent) ground-truth factors
    true_item: torch.Tensor   # (n_items, d_latent)


def make_interactions(gen: torch.Generator, *, n_users: int, n_items: int,
                      n_obs: int, d_latent: int = 8, noise: float = 0.35,
                      device=None) -> InteractionData:
    """Ratings r = clip(round(3 + 1.8 u.v + noise eps), 1, 5) from
    latent factors, on `device` (None = the card)."""
    dev = resolve_device(device)
    gu, gi, go, gj, gn = _split(gen, 5, dev)
    U = torch.randn((n_users, d_latent), generator=gu, device=dev) \
        / np.sqrt(d_latent)
    V = torch.randn((n_items, d_latent), generator=gi, device=dev)
    uid = torch.randint(0, n_users, (n_obs,), generator=go, device=dev)
    iid = torch.randint(0, n_items, (n_obs,), generator=gj, device=dev)
    raw = 3.0 + 1.8 * torch.sum(U[uid] * V[iid], dim=-1)
    raw = raw + noise * torch.randn((n_obs,), generator=gn, device=dev)
    rating = torch.clamp(torch.round(raw), 1, 5).to(torch.int32)
    return InteractionData(n_users=n_users, n_items=n_items, uid=uid,
                           iid=iid, rating=rating, true_user=U, true_item=V)


# --------------------------------------------------------------------------
# MovieLens-like corpus (topics + release year) and Table-1a constraints
# --------------------------------------------------------------------------

MOVIELENS_TOPICS = ("queer", "race_issues", "free_speech", "scifi")
# Paper: "top 5% of movies on the tag" -> 5% base rate per topic.
MOVIELENS_TOPIC_RATE = 0.05
# Table 1a quota per scenario (fraction of total exposure), m2 -> frac.
MOVIELENS_QUOTA = {50: 0.10, 500: 0.05, 1000: 0.015}

YOW_TOPICS = ("scitech", "health", "business", "entertainment",
              "world", "politics", "sport", "environment")
# Table 1b: empirical share of documents per topic in the YOW data.
YOW_TOPIC_RATE = (0.156, 0.096, 0.101, 0.141, 0.155, 0.092, 0.036, 0.019)
# (sign, {m2: quota_frac}) per Table 1b; +1 = ">=", -1 = "<=".
YOW_CONSTRAINTS = (
    (+1, {50: 0.30, 500: 0.30, 1000: 0.20}),   # sci&tech >=
    (+1, {50: 0.20, 500: 0.20, 1000: 0.15}),   # health >=
    (-1, {50: 0.10, 500: 0.10, 1000: 0.20}),   # business <=
    (-1, {50: 0.10, 500: 0.10, 1000: 0.20}),   # entertainment <=
    (-1, {50: 0.10, 500: 0.10, 1000: 0.20}),   # world <=
    (-1, {50: 0.10, 500: 0.10, 1000: 0.20}),   # politics <=
    (-1, {50: 0.10, 500: 0.10, 1000: 0.20}),   # sport <=
    (+1, {50: 0.05, 500: 0.05, 1000: 0.02}),   # environment >=
)


@dataclass(frozen=True)
class Corpus:
    """Item-side metadata: binary topic indicators (K_topics, n_items)
    and optional extra attribute rows (the scaled release-year delta)."""

    topics: torch.Tensor                # (K_topics, n_items) f32 0/1
    extra: torch.Tensor | None = None   # (K_extra, n_items)
    topic_names: tuple = ()


def make_movielens_corpus(gen: torch.Generator, n_items: int,
                          device=None) -> Corpus:
    dev = resolve_device(device)
    gt, gy = _split(gen, 2, dev)
    topics = (torch.rand((len(MOVIELENS_TOPICS), n_items), generator=gt,
                         device=dev) < MOVIELENS_TOPIC_RATE).float()
    # Release years skew recent, as MovieLens rating activity does: an
    # exponential tail back from 2019, clipped at 1950 (mean ~2007). A
    # uniform 1950-2019 draw makes the "mean release year >= 1990" row
    # infeasible at m2 = 1000, where every candidate is ranked.
    draw = torch.empty((n_items,), device=dev).exponential_(generator=gy)
    age = torch.floor(draw * 12.0)
    year = torch.clamp(2019.0 - age, 1950.0, 2019.0)
    year_delta = (year - 1990.0) / 100.0
    return Corpus(topics=topics, extra=year_delta[None, :],
                  topic_names=MOVIELENS_TOPICS)


def make_yow_corpus(gen: torch.Generator, n_items: int,
                    device=None) -> Corpus:
    dev = resolve_device(device)
    (g,) = _split(gen, 1, dev)
    rates = torch.tensor(YOW_TOPIC_RATE, device=dev)[:, None]
    topics = (torch.rand((len(YOW_TOPICS), n_items), generator=g,
                         device=dev) < rates).float()
    return Corpus(topics=topics, topic_names=YOW_TOPICS)


def _scenario(table: dict, m2: int):
    """The Table 1 entry of a paper scenario size; otherwise the nearest
    scenario's (reduced configs use small m2), the first in the table's
    order on a tie."""
    if m2 in table:
        return table[m2]
    nearest = min(table, key=lambda k: abs(k - m2))
    return table[nearest]


def _rows(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def movielens_constraints(corpus: Corpus, item_idx, gamma, m2: int,
                          device=None) -> ConstraintSet:
    """Table 1a over one user's m1 candidates item_idx (m1,): 4 topic
    quotas (>=) and the exposure-weighted release-year delta >= 0."""
    quota = _scenario(MOVIELENS_QUOTA, m2)
    total = float(torch.sum(torch.as_tensor(gamma)))
    idx = torch.as_tensor(item_idx, device=corpus.topics.device).long()
    a_rows = list(_rows(corpus.topics[:, idx]))
    b_rows = [quota * total] * len(a_rows)
    a_rows.append(_rows(corpus.extra[0][idx]))
    b_rows.append(0.0)
    return make_constraints(a_rows, b_rows, [1.0] * len(a_rows),
                            device=device)


def yow_constraints(corpus: Corpus, item_idx, gamma, m2: int,
                    device=None) -> ConstraintSet:
    """Table 1b over one user's candidates: 8 topic quotas with mixed
    >= / <= signs."""
    total = float(torch.sum(torch.as_tensor(gamma)))
    idx = torch.as_tensor(item_idx, device=corpus.topics.device).long()
    a_rows = list(_rows(corpus.topics[:, idx]))
    b_rows = [_scenario(by_m2, m2) * total for _, by_m2 in YOW_CONSTRAINTS]
    signs = [float(sign) for sign, _ in YOW_CONSTRAINTS]
    return make_constraints(a_rows, b_rows, signs, device=device)


# --------------------------------------------------------------------------
# Full experiment bundle: per-user (u, X, a, b) arrays, train/holdout split
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class RankingExperiment:
    """Everything Algorithm 1 needs, batched over users.

    u:   (n, m1) per-user utilities over their top-m1 candidate items
    X:   (n, d)  user covariates (learned embeddings)
    a:   (n, K, m1) per-user constraint attribute rows (sign-normalized)
    b:   (K,)    thresholds (sign-normalized)
    gamma: (m2,) rank discounts
    stage_s: seconds of build_experiment's stages on its device
    (synchronised): "training" (interactions and the recommender),
    "utilities" (every user over every item), "slates_constraints"
    (top-m1 slates, constraint rows, covariates, split).
    """

    u: torch.Tensor
    X: torch.Tensor
    a: torch.Tensor
    b: torch.Tensor
    gamma: torch.Tensor
    m2: int
    train_idx: torch.Tensor
    test_idx: torch.Tensor
    stage_s: dict = field(default_factory=dict)

    def split(self, which: str):
        idx = self.train_idx if which == "train" else self.test_idx
        return self.u[idx], self.X[idx], self.a[idx]


def candidate_slates(u_all, m1: int):
    """Each user's m1 highest-utility items, (top_u (n, m1), top_idx
    (n, m1) int64): a stable descending sort, so ties go to the lower
    item index, as jax.lax.top_k breaks them."""
    order = torch.sort(u_all, dim=1, descending=True, stable=True).indices
    top_idx = order[:, :m1]
    return torch.gather(u_all, 1, top_idx), top_idx


def slate_constraints(dataset: str, corpus: Corpus, top_idx, gamma,
                      m2: int) -> tuple:
    """The per-user constraint rows of every slate at once: (a (n, K,
    m1), b (K,)), element for element what movielens_constraints /
    yow_constraints give user by user. Every user shares b, so it comes
    from the per-user function on the first slate; a is one gather of
    the sign-flipped attribute rows."""
    cons_fn = movielens_constraints if dataset == "movielens" \
        else yow_constraints
    dev = corpus.topics.device
    b = cons_fn(corpus, top_idx[0], gamma, m2, device=dev).b
    if dataset == "movielens":
        attrs = torch.cat([corpus.topics, corpus.extra[:1]])
        signs = torch.ones((attrs.shape[0],), device=dev)
    else:
        attrs = corpus.topics
        signs = torch.tensor([float(s) for s, _ in YOW_CONSTRAINTS],
                             device=dev)
    rows = (attrs * signs[:, None]).T                  # (n_items, K)
    a = rows[top_idx].permute(0, 2, 1).contiguous()    # (n, K, m1)
    return a, b


def assemble_experiment(u_all, X, corpus: Corpus, perm, *, dataset: str,
                        m1: int, m2: int,
                        train_frac: float = 0.75) -> RankingExperiment:
    """Steps 2-4 of build_experiment on its products: the candidate
    slates of u_all (n_users, n_items), their constraints, the
    covariates X (n_users, d) and the split of the user permutation
    `perm` (the first round(train_frac * n) users train)."""
    gamma = dcg_discount(m2).to(u_all.device)
    top_u, top_idx = candidate_slates(u_all, m1)
    a, b = slate_constraints(dataset, corpus, top_idx, gamma, m2)
    n_train = int(round(train_frac * u_all.shape[0]))
    perm = torch.as_tensor(perm, device=u_all.device).long()
    return RankingExperiment(u=top_u, X=X, a=a, b=b, gamma=gamma, m2=m2,
                             train_idx=perm[:n_train],
                             test_idx=perm[n_train:])


def _sync(dev: torch.device) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def build_experiment(gen: torch.Generator, *, dataset: str = "movielens",
                     n_users: int = 200, n_items: int = 4000, m1: int = 1000,
                     m2: int = 50, n_obs: int | None = None,
                     train_frac: float = 0.75, recommender_epochs: int = 3,
                     device=None) -> RankingExperiment:
    """The data stage of the paper's experiment on `device` (None = the
    card):

    1. latent-factor interactions, on which the Appendix-B recommender
       is trained;
    2. per user, the m1 highest-utility items as the candidate slate
       (the paper ranks "top 50/500/1000 from among the 1000
       highest-utility items");
    3. the Table 1 constraints over each user's slate;
    4. the covariates: the learned user embeddings.
    """
    if dataset not in ("movielens", "yow"):
        raise ValueError(f"unknown dataset {dataset!r}")
    dev = resolve_device(device)
    gd, gc, gt, gr, gs = _split(gen, 5, dev)
    t0 = _sync(dev)
    inter = make_interactions(gd, n_users=n_users, n_items=n_items,
                              n_obs=n_obs or n_users * 60, device=dev)
    rec = PaperRecommender(RecommenderConfig(n_users=n_users,
                                             n_items=n_items),
                           gen=gt, device=dev)
    rec.train({"uid": inter.uid, "iid": inter.iid, "rating": inter.rating},
              gen=gr, epochs=recommender_epochs)
    t1 = _sync(dev)
    uid = torch.arange(n_users, device=dev)
    # chunks of about 65,536 (user, item) pairs bound the memory
    step = max(1, 65536 // max(n_items, 1))
    u_all = torch.cat([rec.utilities(uid[s:s + step])
                       for s in range(0, n_users, step)])
    t2 = _sync(dev)
    corpus = (make_movielens_corpus(gc, n_items, device=dev)
              if dataset == "movielens"
              else make_yow_corpus(gc, n_items, device=dev))
    exp = assemble_experiment(
        u_all, rec.user_covariates(uid), corpus,
        torch.randperm(n_users, generator=gs, device=dev), dataset=dataset,
        m1=m1, m2=m2, train_frac=train_frac)
    t3 = _sync(dev)
    return dataclasses.replace(exp, stage_s={
        "training": t1 - t0, "utilities": t2 - t1,
        "slates_constraints": t3 - t2})


# --------------------------------------------------------------------------
# Drifting-traffic generators (the refresh lane's scenario class)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class DriftSpec:
    """A mid-stream distribution shift, parameterized by stream
    position t in [0, 1]: nothing before `start`, a linear ramp to full
    `magnitude` by `end`, held thereafter.

    kind:
      'none'     stationary control: the phase stays 0.
      'tighten'  thresholds b scale by 1 + (magnitude-1)*phase: the
                 exposure floor rises mid-stream while utilities and
                 covariates stay, so a frozen predictor serves stale
                 (too small) lambda-hat.
      'shift'    the covariate mean moves by magnitude*phase along a
                 fixed unit direction, away from the train db.
      'grow'     with probability min(phase, 1) a user comes from a new
                 population cluster centred magnitude away.
    """

    kind: str = "none"
    start: float = 0.25
    end: float = 0.75
    magnitude: float = 3.0

    def __post_init__(self):
        if self.kind not in ("none", "tighten", "shift", "grow"):
            raise ValueError(f"unknown drift kind {self.kind!r}")
        if not 0.0 <= self.start <= self.end <= 1.0:
            raise ValueError(f"need 0 <= start <= end <= 1, got "
                             f"[{self.start}, {self.end}]")


def drift_phase(spec: DriftSpec, t: float) -> float:
    """Ramp position in [0, 1] at stream fraction `t`."""
    if spec.kind == "none" or t <= spec.start:
        return 0.0
    if t >= spec.end:
        return 1.0
    return (t - spec.start) / (spec.end - spec.start)


def drift_request_params(rng: np.random.Generator, spec: DriftSpec,
                         t: float, *, m1: int, m2: int, K: int, d_cov: int,
                         topic_rate: float = 0.15,
                         b_frac: float = 0.03) -> dict:
    """One request's synthetic payload at stream fraction `t` under
    `spec`, as host numpy arrays (the serving engine's input): utilities
    ~ U[1, 5], sparse binary topic rows, thresholds a fraction of the
    total slot discount, standard-normal covariates, with the drift
    kind's change at the current ramp phase. The draws are the JAX
    generator's, in its order."""
    phase = drift_phase(spec, t)
    u = rng.uniform(1.0, 5.0, m1).astype(np.float32)
    a = (rng.random((K, m1)) < topic_rate).astype(np.float32)
    gamma = dcg_discount(m2).numpy()
    frac = b_frac
    if spec.kind == "tighten":
        frac = b_frac * (1.0 + (spec.magnitude - 1.0) * phase)
    b = (frac * float(gamma.sum()) * np.ones(K, np.float32))
    X = rng.normal(size=d_cov).astype(np.float32)
    if spec.kind == "shift":
        direction = np.ones(d_cov, np.float32) / np.sqrt(d_cov)
        X = X + np.float32(spec.magnitude * phase) * direction
    elif spec.kind == "grow" and rng.random() < phase:
        center = np.full(d_cov, spec.magnitude / np.sqrt(d_cov), np.float32)
        X = X + center
    return {"u": u, "a": a, "b": b, "gamma": gamma, "X": X}
