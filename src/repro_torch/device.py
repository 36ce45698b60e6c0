"""Device resolution shared by every entry point of the port.

`device=None` means the card. Without CUDA that raises instead of
quietly running the plain PyTorch path on the CPU; the CPU runs only
when a caller asks for it with `device="cpu"`, as the tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch.device an entry point runs on (a CUDA device carries
    its index, so it compares equal to a tensor's `.device`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
