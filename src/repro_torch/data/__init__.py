"""Data of the port (counterpart of repro.data): the paper's synthetic
MovieLens / YOW experiments and the drifting-traffic generators."""

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
           "make_interactions", "make_movielens_corpus", "make_yow_corpus",
           "movielens_constraints", "yow_constraints"]
