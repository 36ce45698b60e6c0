"""Data of the port (counterpart of repro.data): the paper's synthetic
MovieLens / YOW experiments, the drifting-traffic generators and the
synthetic LM and recsys batches."""

from repro_torch.data.batches import (
    lm_bigram_batch,
    make_deepfm_batch,
    make_lm_batch,
    make_seqrec_batch,
)
from repro_torch.data.synthetic import (
    Corpus,
    DriftSpec,
    InteractionData,
    RankingExperiment,
    build_experiment,
    drift_phase,
    drift_request_params,
    make_interactions,
    make_movielens_corpus,
    make_yow_corpus,
    movielens_constraints,
    yow_constraints,
)

__all__ = ["Corpus", "DriftSpec", "InteractionData", "RankingExperiment",
           "build_experiment", "drift_phase", "drift_request_params",
           "lm_bigram_batch", "make_deepfm_batch", "make_interactions",
           "make_lm_batch", "make_movielens_corpus", "make_seqrec_batch",
           "make_yow_corpus",
           "movielens_constraints", "yow_constraints"]
