"""Retrieval evaluation."""

from multimodal_similarity_tpu_torch.eval.metrics import (
    average_precision,
    evaluate,
    evaluate_simple,
    retrieval_metrics,
)

__all__ = ["average_precision", "evaluate", "evaluate_simple",
           "retrieval_metrics"]
