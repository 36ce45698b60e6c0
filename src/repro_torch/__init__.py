"""PyTorch/CUDA port of the constrained-ranking system (see `repro` for
the JAX reference it is held against).

f32 products run in full fp32 on the card: TF32 would keep about three
decimal digits and break the parity contracts the tests state.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
