"""Optimisers of the port (counterpart of repro.optim): Adam, which the
paper's recommender and the MLP shadow-price predictor train with."""

from repro_torch.optim.adam import AdamState, adam_init, adam_update

__all__ = ["AdamState", "adam_init", "adam_update"]
