"""kimi-k2-1t-a32b — trillion-param MoE [arXiv:2501.kimi2; unverified].

61L d_model=7168 64H (GQA kv=8) vocab=163840, MoE 384 experts top-8 with
per-expert d_ff=2048. ~1.03T total / ~32B active params. As in the JAX
package: d_head 7168/64 = 112 -> 128 (non-square attention), bf16 Adam
moments.
"""

import torch

from repro_torch.configs.lm_family import lm_arch
from repro_torch.configs.registry import register

FULL = dict(
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=2048, vocab=163840,
    moe=True, n_experts=384, top_k=8, d_ff_moe=2048,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    moment_dtype=torch.bfloat16, remat="full",
)

SMOKE = dict(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256,
    moe=True, n_experts=8, top_k=2, d_ff_moe=64,
    dtype=torch.float32, param_dtype=torch.float32,
    dense_attn_threshold=4096,
)

SPEC = register(lm_arch(
    "kimi-k2-1t-a32b", FULL, SMOKE,
    notes="1T MoE; d_head 112->128 aligned; bf16 moments; "
          "train cells sized for the multi-pod mesh.",
    variants={
        "moe-sort-dispatch": dict(moe_dispatch="sort"),
        "moe-shmap": dict(moe_dispatch="shmap"),
        "opt": dict(moe_dispatch="shmap", dense_attn_threshold=4096),
    },
))
