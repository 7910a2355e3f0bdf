"""Evaluation of the port: the leave-n-out split and recall@k, NDCG@k and
RMSE. NumPy only, and the same code as the JAX package's ``evaluate``
(kept as a copy: that package's ``__init__`` imports JAX)."""

from recommendation_models_tpu_torch.evaluate.metrics import (
    rmse,
    recall_at_k,
    ndcg_at_k,
    take_groups,
)
from recommendation_models_tpu_torch.evaluate.protocol import (
    grouped_by_user,
    leave_n_out,
    relevant_by_user,
)

__all__ = ["rmse", "recall_at_k", "ndcg_at_k", "take_groups",
           "grouped_by_user", "leave_n_out", "relevant_by_user"]
