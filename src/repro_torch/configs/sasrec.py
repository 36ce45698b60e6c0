"""sasrec — self-attentive sequential recommendation [arXiv:1808.09781; paper].

embed_dim=50 n_blocks=2 n_heads=1 seq_len=50 interaction=self-attn-seq.
10^6-item catalogue, sampled softmax (1 + 127 negatives).
"""

from repro_torch.configs.recsys_family import recsys_arch
from repro_torch.configs.registry import register

FULL = dict(n_items=1_000_000, embed_dim=50, n_blocks=2, n_heads=1,
            seq_len=50)
SMOKE = dict(n_items=1000, embed_dim=16, n_blocks=2, n_heads=1, seq_len=12)

SPEC = register(recsys_arch(
    "sasrec", "sasrec", FULL, SMOKE,
    variants={
        # the JAX package's sharding variant: the 10^6 x 50 table
        # replicated instead of row-sharded
        "replicated-table": dict(replicate_tables=True),
    },
))
