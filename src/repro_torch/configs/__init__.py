"""Architecture configs of the port (counterpart of repro.configs): the
five LM archs, the four recsys backbones, the GNN (meshgraphnet) and
the paper's own arch, paper-ranking. Importing this package registers
them (side effect)."""

from repro_torch.configs import (  # noqa: F401
    bert4rec,
    deepfm,
    kimi_k2_1t_a32b,
    llama3_2_1b,
    llama4_scout_17b_16e,
    meshgraphnet,
    mind,
    mistral_nemo_12b,
    paper,
    phi3_medium_14b,
    sasrec,
)
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_REGISTRY,
    ArchSpec,
    Cell,
    Program,
    all_archs,
    get_arch,
)
