"""phi3-medium-14b — dense RoPE SwiGLU GQA [arXiv:2404.14219; unverified].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352.
"""

import torch

from repro_torch.configs.lm_family import lm_arch
from repro_torch.configs.registry import register

FULL = dict(
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, d_head=128,
    d_ff=17920, vocab=100352,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    moment_dtype=torch.bfloat16, remat="full",
)

SMOKE = dict(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=160, vocab=256,
    dtype=torch.float32, param_dtype=torch.float32,
    dense_attn_threshold=4096,
)

SPEC = register(lm_arch(
    "phi3-medium-14b", FULL, SMOKE,
    variants={
        # the JAX package's dense attention with the query axis sharded
        # (40 heads do not divide its 16-way model axis)
        "attn-seq-shard": dict(dense_attn_threshold=4096),
    },
))
