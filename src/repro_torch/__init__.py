"""PyTorch/CUDA port of the constrained-ranking system (see `repro` for
the JAX reference it is held against).

f32 products run in full fp32 on the card: TF32 would keep about three
decimal digits and break the parity contracts the tests state.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The kernel package's __init__ exports the dispatcher's entry points,
# whose modules import core.predictors, which in turn imports
# kernels.common. Loading the kernel package here, before anything else
# of the port, gives that cycle one order that always resolves.
import repro_torch.kernels  # noqa: E402,F401
