"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(ref.py) and the dispatcher (ops.py), whose entry points are exported
here as `repro.kernels` exports its own."""

from repro_torch.kernels import ref
from repro_torch.kernels.ops import (
    embedding_bag,
    fused_rank,
    knn_lambda,
    knn_predict_kernel,
    knn_topk,
    predict_rank_audited,
    predict_rank_audited_stateful,
    rank_audited,
)

__all__ = ["embedding_bag", "fused_rank", "knn_lambda", "knn_predict_kernel",
           "knn_topk", "predict_rank_audited",
           "predict_rank_audited_stateful", "ref", "rank_audited"]
