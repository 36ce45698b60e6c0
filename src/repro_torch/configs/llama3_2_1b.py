"""llama3.2-1b — small llama3 [hf:meta-llama/Llama-3.2-1B].

16L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=128256, d_head=64,
tied embeddings (as shipped).
"""

import torch

from repro_torch.configs.lm_family import lm_arch
from repro_torch.configs.registry import register

FULL = dict(
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, d_head=64,
    d_ff=8192, vocab=128256, tie_embeddings=True,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16,
    moment_dtype=torch.float32, remat="full",
)

SMOKE = dict(
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
    d_ff=128, vocab=256, tie_embeddings=True,
    dtype=torch.float32, param_dtype=torch.float32,
    dense_attn_threshold=4096,
)

SPEC = register(lm_arch("llama3.2-1b", FULL, SMOKE))
