"""Optimisers of the port (counterpart of repro.optim): Adam, which the
paper's recommender, the MLP shadow-price predictor, the recsys
backbones and the LMs train with, the factored Adafactor-style Adam,
the learning-rate schedules and global-norm clipping."""

from repro_torch.optim.adafactor import (
    FactoredState,
    adafactor_init,
    adafactor_update,
)
from repro_torch.optim.adam import AdamState, adam_init, adam_update
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.schedules import (
    constant_schedule,
    cosine_schedule,
    linear_warmup_cosine,
)

__all__ = ["AdamState", "FactoredState", "adafactor_init",
           "adafactor_update", "adam_init", "adam_update",
           "clip_by_global_norm", "constant_schedule", "cosine_schedule",
           "global_norm", "linear_warmup_cosine"]
