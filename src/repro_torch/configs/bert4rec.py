"""bert4rec — bidirectional masked-item model [arXiv:1904.06690; paper].

embed_dim=64 n_blocks=2 n_heads=2 seq_len=200 interaction=bidir-seq.
Encoder-only.
"""

from repro_torch.configs.recsys_family import recsys_arch
from repro_torch.configs.registry import register

FULL = dict(n_items=1_000_000, embed_dim=64, n_blocks=2, n_heads=2,
            seq_len=200)
SMOKE = dict(n_items=1000, embed_dim=16, n_blocks=2, n_heads=2, seq_len=16)

SPEC = register(recsys_arch("bert4rec", "bert4rec", FULL, SMOKE))
