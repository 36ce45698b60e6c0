"""Ranking core of the port: discounts and constraints, the assignment
solvers, the Monge checks, the batched dual solver, the lambda
predictors and the ranking pipeline (every name repro.core exports)."""

from repro_torch.core.assignment import (
    auction,
    brute_force,
    brute_force_constrained,
    greedy_half_approx,
    rank_by_sort,
)
from repro_torch.core.constraints import (
    ConstraintSet,
    dcg_discount,
    exposure_quota_constraints,
    geometric_discount,
    make_constraints,
    movielens_style_constraints,
)
from repro_torch.core.dual_solver import (
    DualSolution,
    serve_rank,
    solve_dual,
    solve_dual_batch,
)
from repro_torch.core.monge import (
    is_inverse_monge,
    is_permuted_inverse_monge,
    monge_defect,
)
from repro_torch.core.predictors import (
    KNNLambdaPredictor,
    LinearLambdaPredictor,
    MeanLambdaPredictor,
    MLPLambdaPredictor,
    knn_predict,
)
from repro_torch.core.ranking import (
    AUDIT_TOL,
    EPS_GRID,
    RankingOutput,
    RankingPipeline,
    audit_selected,
    fit_pipeline,
    rank_given_lambda,
    rank_with_strategy,
    serve,
    tune_eps,
)

__all__ = [
    "auction", "brute_force", "brute_force_constrained",
    "greedy_half_approx", "rank_by_sort",
    "is_inverse_monge", "is_permuted_inverse_monge", "monge_defect",
    "ConstraintSet", "dcg_discount", "exposure_quota_constraints",
    "geometric_discount", "make_constraints", "movielens_style_constraints",
    "DualSolution", "serve_rank", "solve_dual", "solve_dual_batch",
    "KNNLambdaPredictor", "LinearLambdaPredictor", "MeanLambdaPredictor",
    "MLPLambdaPredictor", "knn_predict",
    "AUDIT_TOL", "EPS_GRID", "RankingOutput", "RankingPipeline",
    "audit_selected", "fit_pipeline", "rank_given_lambda",
    "rank_with_strategy", "serve", "tune_eps",
]
