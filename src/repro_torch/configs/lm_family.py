"""LM-family cells and the arch constructor (counterpart of the
non-lowering part of repro.configs.lm_family): train_4k, prefill_32k,
decode_32k and long_500k, all four on one parameterization
(models/transformer.py), each naming the entry point it runs:

  train_4k     lm_train_step    tokens (256, 4096)
  prefill_32k  lm_prefill       tokens (32, 32768)
  decode_32k   lm_decode_step   1 token against a 32k cache, batch 128
  long_500k    lm_decode_step   1 token against a 524,288 cache, batch 1

`build` is None: the JAX build gives a cell's program over sharded
abstract parameters for the dry run, which waits for training and the
mesh-context half of distribution (ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

from repro_torch.configs.registry import ArchSpec, Cell
from repro_torch.models.transformer import LMConfig

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
        notes=notes,
        variants=variant_fns,
    )
