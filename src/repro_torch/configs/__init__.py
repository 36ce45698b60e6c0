"""Architecture configs of the port (counterpart of repro.configs): the
four recsys backbones. Importing this package registers them (side
effect)."""

from repro_torch.configs import bert4rec, deepfm, mind, sasrec  # noqa: F401
from repro_torch.configs.registry import (  # noqa: F401
    ARCH_REGISTRY,
    ArchSpec,
    Cell,
    all_archs,
    get_arch,
)
