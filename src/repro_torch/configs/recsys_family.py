"""RecSys-family cells and the arch constructor (counterpart of the
non-lowering part of repro.configs.recsys_family): train_batch /
serve_p99 / serve_bulk / retrieval_cand, the constrained head's
constants and the covariate width each backbone hands the lambda
predictor."""

from __future__ import annotations

from repro_torch.configs.registry import ArchSpec, Cell
from repro_torch.models.recsys import RecsysConfig

N_NEG = 127          # sampled-softmax negatives (training)
N_MASK = 20          # bert4rec masked positions (10% of seq 200)
RETRIEVAL_K = 5      # constraints in the retrieval head
RETRIEVAL_M2 = 50    # ranking slots
KNN_DB = 65536       # shadow-price train-user database (serving fleet)

RECSYS_CELLS = (
    Cell("train_batch", "train", {"batch": 65536}),
    Cell("serve_p99", "serve", {"batch": 512}),
    Cell("serve_bulk", "serve", {"batch": 262144}),
    Cell("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
)

RECSYS_SMOKE_CELLS = (
    Cell("train_batch", "train", {"batch": 16}),
    Cell("serve_p99", "serve", {"batch": 8}),
    Cell("serve_bulk", "serve", {"batch": 32}),
    Cell("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 512}),
)


def _covariate_dim(cfg: RecsysConfig) -> int:
    if cfg.kind == "deepfm":
        return cfg.embed_dim
    if cfg.kind == "mind":
        return cfg.n_interests * cfg.embed_dim
    return cfg.embed_dim


def recsys_arch(name: str, kind: str, full_kwargs: dict, smoke_kwargs: dict,
                notes: str = "", variants: dict | None = None) -> ArchSpec:
    def make_config(full: bool = True) -> RecsysConfig:
        kw = full_kwargs if full else smoke_kwargs
        return RecsysConfig(name=name, kind=kind, **kw)

    variant_fns = {
        vname: (lambda kw=vkw: RecsysConfig(name=name, kind=kind,
                                            **{**full_kwargs, **kw}))
        for vname, vkw in (variants or {}).items()
    }
    return ArchSpec(
        name=name, family="recsys",
        cells=RECSYS_CELLS,
        make_config=make_config,
        notes=notes,
        variants=variant_fns,
    )
