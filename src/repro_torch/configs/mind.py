"""mind — multi-interest dynamic-routing retrieval [arXiv:1904.08030;
unverified].

embed_dim=64 n_interests=4 capsule_iters=3 interaction=multi-interest.
Behaviour window seq_len=50 (MIND paper's short-term window); serve =
max over interest capsules.
"""

from repro_torch.configs.recsys_family import recsys_arch
from repro_torch.configs.registry import register

FULL = dict(n_items=1_000_000, embed_dim=64, seq_len=50,
            n_interests=4, capsule_iters=3)
SMOKE = dict(n_items=1000, embed_dim=16, seq_len=12, n_interests=2,
             capsule_iters=2)

SPEC = register(recsys_arch("mind", "mind", FULL, SMOKE))
