"""Optimisers of the port (counterpart of repro.optim): Adam, which the
paper's recommender, the MLP shadow-price predictor and the recsys
backbones train with, and global-norm clipping."""

from repro_torch.optim.adam import AdamState, adam_init, adam_update
from repro_torch.optim.clip import clip_by_global_norm, global_norm

__all__ = ["AdamState", "adam_init", "adam_update", "clip_by_global_norm",
           "global_norm"]
