"""Device resolution shared by every entry point of the port.

`device=None` means the card. Without CUDA that raises instead of
quietly running the plain PyTorch path on the CPU; the CPU runs only
when a caller asks for it with `device="cpu"`, as the tests do.
"""

from __future__ import annotations

import threading

import torch

# Cost traces running on this thread (launch/graph_cost.py), in
# FAKE_CARD_TRACES.n: while one runs, `resolve_device` on its thread
# takes the fake card, the meta device its shape-only tensors lie on, as
# the card. Never a fallback: a traced program runs the card's route and
# no op on the CPU; outside a trace, and on every other thread during
# one (an engine's pipeline worker, say), the meta device is refused and
# a missing card raises as always.
FAKE_CARD_TRACES = threading.local()


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
    elif dev.type != "cpu" and not (
            dev.type == "meta" and getattr(FAKE_CARD_TRACES, "n", 0)):
        raise ValueError(f"unsupported device {dev}")
    return dev
