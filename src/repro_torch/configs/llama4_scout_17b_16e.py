"""llama4-scout-17b-a16e — MoE, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified].

48L d_model=5120 40H (GQA kv=8) vocab=202048, MoE 16 experts top-1,
expert d_ff=8192, a shared expert. The early-fusion frontend is out of
scope (LM backbone only): text tokens in, logits out.
"""

import torch

from repro_torch.configs.lm_family import lm_arch
from repro_torch.configs.registry import register

FULL = dict(
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
    d_ff=8192, vocab=202048,
    moe=True, n_experts=16, top_k=1, d_ff_moe=8192, shared_expert=True,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    moment_dtype=torch.bfloat16, remat="full",
)

SMOKE = dict(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256,
    moe=True, n_experts=4, top_k=1, d_ff_moe=128, shared_expert=True,
    dtype=torch.float32, param_dtype=torch.float32,
    dense_attn_threshold=4096,
)

SPEC = register(lm_arch(
    "llama4-scout-17b-a16e", FULL, SMOKE,
    notes="top-1 routed + shared expert (Llama-4 routing).",
    variants={
        "opt": dict(moe_dispatch="shmap", dense_attn_threshold=4096),
    },
))
