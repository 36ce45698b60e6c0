"""deepfm — FM + deep CTR [arXiv:1703.04247; paper].

n_sparse=39 embed_dim=10 mlp=400-400-400 interaction=fm. Criteo-scale
tables: 10^6 rows per field -> one flat 39M x 10 table.
"""

from repro_torch.configs.recsys_family import recsys_arch
from repro_torch.configs.registry import register

FULL = dict(n_sparse=39, field_vocab=1_000_000, embed_dim=10,
            mlp_dims=(400, 400, 400))
SMOKE = dict(n_sparse=6, field_vocab=500, embed_dim=8, mlp_dims=(32, 32))

SPEC = register(recsys_arch("deepfm", "deepfm", FULL, SMOKE))
