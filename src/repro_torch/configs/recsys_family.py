"""RecSys-family cells, their programs and the arch constructor
(counterpart of repro.configs.recsys_family): train_batch / serve_p99 /
serve_bulk / retrieval_cand, the constrained head's constants and the
covariate width each backbone hands the lambda predictor.

`build_recsys(cfg, cell, mesh)` gives the cell's Program, its arguments
as ArgSpec trees with JAX's shardings (the tables' rows over 'model'
unless cfg.replicate_tables, the batch over the batch axes, the 10^6
candidates over ('data', 'model')):

  train_batch     the functional train step (model.functional_step)
  serve_p99/bulk  model.serve
  retrieval_cand  the paper's online stage as one program over 10^6
                  candidates: retrieval_scores (DeepFM's context sum
                  through ops.embedding_bag), user_covariates, lambda-hat
                  over the KNN_DB-row database by ops.knn_lambda (the
                  knn_lambda kernel on the card), then the adjusted
                  top-RETRIEVAL_M2 s = u + (1 + 1e-4) lambda-hat^T a by
                  ops.fused_rank (the fused_rank kernel; its axpy
                  score), where JAX forms lambda-hat @ a and lax.top_k.
"""

from __future__ import annotations

import torch

from repro_torch.configs.registry import (
    ArchSpec,
    Cell,
    Program,
    abstract_adam,
    abstract_like,
    pad_up,
    sds,
)
from repro_torch.distributed.sharding import (
    RECSYS_RULES,
    NamedSharding,
    filter_rules,
    param_shardings,
)
from repro_torch.kernels import ops
from repro_torch.models.recsys import (
    RECSYS_REGISTRY,
    RecsysConfig,
    recsys_logical_axes,
)

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


def make_train_batch_specs(cfg: RecsysConfig, B: int) -> dict:
    """The train batch's schema per model kind (data/batches.py's
    layouts); shardings are attached by the caller."""
    S, i32 = cfg.seq_len, torch.int32
    if cfg.kind == "deepfm":
        return {"ids": sds((B, cfg.n_sparse), i32),
                "labels": sds((B,), i32)}
    if cfg.kind == "sasrec":
        return {"seq": sds((B, S), i32), "pos": sds((B, S), i32),
                "neg": sds((B, S, N_NEG), i32)}
    if cfg.kind == "bert4rec":
        return {"seq": sds((B, S), i32), "mask_pos": sds((B, N_MASK), i32),
                "mask_target": sds((B, N_MASK), i32),
                "neg": sds((B, N_MASK, N_NEG), i32)}
    if cfg.kind == "mind":
        return {"seq": sds((B, S), i32), "pos": sds((B,), i32),
                "neg": sds((B, N_NEG), i32)}
    raise ValueError(cfg.kind)


def build_recsys(cfg: RecsysConfig, cell: Cell, mesh) -> Program:
    """The cell's program over `mesh` (see the module docstring)."""
    base_rules = RECSYS_RULES
    if cfg.replicate_tables:
        base_rules = base_rules.override(table_rows=None)
    rules = filter_rules(base_rules, mesh)
    cls = RECSYS_REGISTRY[cfg.kind]
    shard = param_shardings(recsys_logical_axes(cfg), mesh, rules)
    params = abstract_like(cls(cfg, device="meta").params(), shard)
    by_rank = {n: NamedSharding(mesh, rules.resolve(
        "batch", *[None] * (n - 1))) for n in (1, 2, 3)}
    batch_vec, batch_mat = by_rank[1], by_rank[2]
    f32, i32 = torch.float32, torch.int32

    if cell.kind == "train":
        specs = make_train_batch_specs(cfg, cell["batch"])
        batch = {k: sds(v.shape, v.dtype, by_rank[len(v.shape)])
                 for k, v in specs.items()}
        opt = abstract_adam(params, shard, mesh)

        def fn(params, opt, batch):
            return cls.bound(cfg, params).functional_step(params, opt, batch)

        return Program(fn=fn, args=(params, opt, batch), rules=rules)

    if cell.kind == "serve":
        B = cell["batch"]
        if cfg.kind == "deepfm":
            def fn(params, ids):
                return cls.bound(cfg, params).serve(ids)

            return Program(fn=fn, args=(
                params, sds((B, cfg.n_sparse), i32, batch_mat)), rules=rules)

        def fn(params, seq, target):
            return cls.bound(cfg, params).serve(seq, target)

        return Program(fn=fn, args=(params,
                                    sds((B, cfg.seq_len), i32, batch_mat),
                                    sds((B,), i32, batch_vec)), rules=rules)

    if cell.kind == "retrieval":
        # batch 1: one query against 10^6 candidates; the candidate axis
        # carries the parallelism, padded to the mesh
        B, n_cand = cell["batch"], pad_up(cell["n_candidates"])
        db_sh = NamedSharding(mesh, rules.resolve("users_db", None))
        width = cfg.n_sparse - 1 if cfg.kind == "deepfm" else cfg.seq_len
        args = (params,
                sds((B, width), i32, batch_mat),
                sds((n_cand,), i32,
                    NamedSharding(mesh, rules.resolve("candidates"))),
                sds((RETRIEVAL_K, n_cand), f32,
                    NamedSharding(mesh, rules.resolve(None, "candidates"))),
                sds((KNN_DB, _covariate_dim(cfg)), f32, db_sh),
                sds((KNN_DB, RETRIEVAL_K), f32, db_sh))
        m2 = min(RETRIEVAL_M2, n_cand)

        def fn(params, user_in, cand_ids, a, X_db, lam_db):
            # Algorithm 1's online stage, end to end
            model = cls.bound(cfg, params)
            dev = model.device
            scores = model.retrieval_scores(user_in, cand_ids)   # (B, n)
            X = model.user_covariates(user_in)                   # (B, d)
            lam_hat = ops.knn_lambda(X, X_db, lam_db, k=10, device=dev)
            a = torch.as_tensor(a, device=dev)
            vals, idx = ops.fused_rank(
                scores, a[None].expand(scores.shape[0], -1, -1), lam_hat,
                m2=m2, eps=1e-4, device=dev)
            return vals, idx, lam_hat

        return Program(fn=fn, args=args, rules=rules)

    raise ValueError(cell.kind)


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
        build=build_recsys,
        notes=notes,
        variants=variant_fns,
    )
