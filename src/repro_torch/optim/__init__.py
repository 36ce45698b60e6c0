"""Optimisers of the port (counterpart of repro.optim): Adam, which the
paper's recommender, the MLP shadow-price predictor, the recsys
backbones and the LMs train with, the factored Adafactor-style Adam,
the learning-rate schedules, global-norm clipping and the int8
compressed psum with error feedback."""

from repro_torch.optim.adafactor import (
    FactoredState,
    adafactor_init,
    adafactor_update,
)
from repro_torch.optim.adam import AdamState, adam_init, adam_update
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.compression import (
    compress_int8,
    compressed_psum,
    decompress_int8,
    psum_with_error_feedback,
)
from repro_torch.optim.schedules import (
    constant_schedule,
    cosine_schedule,
    linear_warmup_cosine,
)

__all__ = ["AdamState", "FactoredState", "adafactor_init",
           "adafactor_update", "adam_init", "adam_update",
           "clip_by_global_norm", "compress_int8", "compressed_psum",
           "constant_schedule", "cosine_schedule", "decompress_int8",
           "global_norm", "linear_warmup_cosine",
           "psum_with_error_feedback"]
