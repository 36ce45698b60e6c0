"""Architecture configs of the port (counterpart of repro.configs): the
four recsys backbones and the paper's own arch, paper-ranking.
Importing this package registers them (side effect)."""

from repro_torch.configs import (  # noqa: F401
    bert4rec,
    deepfm,
    mind,
    paper,
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
