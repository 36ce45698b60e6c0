"""LM-family cells, their programs and the arch constructor
(counterpart of repro.configs.lm_family): train_4k, prefill_32k,
decode_32k and long_500k, all four on one parameterization
(models/transformer.py), each naming the entry point it runs:

  train_4k     lm_train_step    tokens (256, 4096)
  prefill_32k  lm_prefill       tokens (32, 32768)
  decode_32k   lm_decode_step   1 token against a 32k cache, batch 128
  long_500k    lm_decode_step   1 token against a 524,288 cache, batch 1
               (the cache re-sharded: sequence over ('data', 'model'),
               the batch axes unsharded)

`build_lm(cfg, cell, mesh)` gives the cell's Program: its arguments as
ArgSpec trees with JAX's shardings (parameters FSDP/TP by
lm_logical_axes, Adam's moments likewise, the batch over the batch
axes), shapes from the meta device, nothing materialised. Its `fn`
enters the mesh and the cell's rules, so a dense config's program runs
partitioned (models.transformer.lm_plan: one shard body a mesh
position, FSDP over 'data', tensor parallelism over 'model', the batch
and the cache by their specs), as JAX's jit partitions the annotated
program; an argument may be a tensor (laid by its spec at entry) or a
launch.mesh.Sharded laid so, and the parameters, moments, caches and
logits come back Sharded. An MoE config's program runs global (its
'shmap' dispatch in shard bodies of its own).
"""

from __future__ import annotations

import torch

from repro_torch.configs.registry import (
    ArchSpec,
    Cell,
    Program,
    abstract_adam,
    abstract_like,
    sds,
)
from repro_torch.distributed.sharding import (
    LM_RULES,
    NamedSharding,
    filter_rules,
    param_shardings,
    use_mesh_rules,
)
from repro_torch.models.transformer import (
    LMConfig,
    cache_logical_axes,
    lm_decode_step,
    lm_init,
    lm_logical_axes,
    lm_prefill,
    lm_train_step,
    make_decode_cache,
)

LM_CELLS = (
    Cell("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    Cell("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    Cell("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    Cell("long_500k", "decode", {"seq_len": 524288, "global_batch": 1}),
)

# Reduced cells for smoke tests (same kinds, tiny sizes).
LM_SMOKE_CELLS = (
    Cell("train_4k", "train", {"seq_len": 64, "global_batch": 2}),
    Cell("prefill_32k", "prefill", {"seq_len": 32, "global_batch": 2}),
    Cell("decode_32k", "decode", {"seq_len": 32, "global_batch": 2}),
    Cell("long_500k", "decode", {"seq_len": 128, "global_batch": 1}),
)


def _cell_rules(cell: Cell, cfg: LMConfig):
    rules = LM_RULES
    if cell.name == "long_500k":
        # B = 1: nothing to gain from batch sharding; spread the KV cache
        # over ('data', 'model') instead
        rules = rules.override(batch=None, kv_batch=None,
                               seq_shard=("data", "model"))
    return rules


def _abstract_params(cfg: LMConfig, mesh, rules):
    shard = param_shardings(lm_logical_axes(cfg), mesh, rules)
    return abstract_like(lm_init(None, cfg, device="meta"), shard), shard


def build_lm(cfg: LMConfig, cell: Cell, mesh) -> Program:
    """The cell's program over `mesh`: train (params, AdamState, batch)
    -> lm_train_step; prefill (params, tokens) -> lm_prefill; decode
    (params, cache, token, pos) -> lm_decode_step over
    make_decode_cache's tree."""
    rules = filter_rules(_cell_rules(cell, cfg), mesh)
    S, B = cell["seq_len"], cell["global_batch"]
    batch_sh = NamedSharding(mesh, rules.resolve("batch", None))
    params, shard = _abstract_params(cfg, mesh, rules)

    if cell.kind == "train":
        opt = abstract_adam(params, shard, mesh, cfg.moment_dtype)
        batch = {"tokens": sds((B, S), torch.int32, batch_sh),
                 "labels": sds((B, S), torch.int32, batch_sh)}

        def fn(params, opt, batch):
            with use_mesh_rules(mesh, rules):
                return lm_train_step(params, opt, batch, cfg)

        return Program(fn=fn, args=(params, opt, batch), rules=rules)

    if cell.kind == "prefill":
        tokens = sds((B, S), torch.int32, batch_sh)

        def fn(params, tokens):
            with use_mesh_rules(mesh, rules):
                return lm_prefill(params, tokens, cfg)

        return Program(fn=fn, args=(params, tokens), rules=rules)

    if cell.kind == "decode":
        cache = abstract_like(
            make_decode_cache(cfg, B, S, device="meta"),
            param_shardings(cache_logical_axes(cfg), mesh, rules))
        token = sds((B,), torch.int32,
                    NamedSharding(mesh, rules.resolve("batch")))
        pos = sds((), torch.int32, NamedSharding(mesh, ()))

        def fn(params, cache, token, pos):
            with use_mesh_rules(mesh, rules):
                return lm_decode_step(params, cache, token, pos, cfg)

        return Program(fn=fn, args=(params, cache, token, pos), rules=rules)

    raise ValueError(cell.kind)


def lm_arch(name: str, full_kwargs: dict, smoke_kwargs: dict,
            notes: str = "", variants: dict | None = None) -> ArchSpec:
    def make_config(full: bool = True) -> LMConfig:
        kw = full_kwargs if full else smoke_kwargs
        return LMConfig(name=name, **kw)

    variant_fns = {
        vname: (lambda kw=vkw: LMConfig(name=name, **{**full_kwargs, **kw}))
        for vname, vkw in (variants or {}).items()
    }
    return ArchSpec(
        name=name, family="lm",
        cells=LM_CELLS,
        make_config=make_config,
        build=build_lm,
        notes=notes,
        variants=variant_fns,
    )
