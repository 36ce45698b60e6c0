"""mistral-nemo-12b — 128k ctx [hf:mistralai/Mistral-Nemo-Base-2407; hf].

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072, d_head=128
(the HF config's non-square attention: H*Dh = 4096 != d_model).
"""

import torch

from repro_torch.configs.lm_family import lm_arch
from repro_torch.configs.registry import register

FULL = dict(
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, d_head=128,
    d_ff=14336, vocab=131072,
    rope_theta=1_000_000.0,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    moment_dtype=torch.bfloat16, remat="full",
)

SMOKE = dict(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=112, vocab=256,
    dtype=torch.float32, param_dtype=torch.float32,
    dense_attn_threshold=4096,
)

SPEC = register(lm_arch(
    "mistral-nemo-12b", FULL, SMOKE,
    variants={
        # the JAX package's Sq-sharded dense attention at train length
        "opt": dict(dense_attn_threshold=4096),
    },
))
