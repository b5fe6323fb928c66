"""Retrieval evaluation and the evaluation CLIs.

The metrics import here; the CLIs' public functions (``select_eval_triplets``
and the ``analysis`` helpers) load with their module at first access, so
that ``python -m`` of a CLI does not find it imported already."""

import importlib

from multimodal_similarity_tpu_torch.eval.metrics import (
    average_precision,
    evaluate,
    evaluate_simple,
    retrieval_metrics,
)

_CLI_EXPORTS = {
    "select_eval_triplets": "evaluate_pairsim",
    "label_distribution": "analysis",
    "format_confusion": "analysis",
    "plot_confusion": "analysis",
    "summarize_results": "analysis",
}


def __getattr__(name):
    if name in _CLI_EXPORTS:
        module = importlib.import_module(f"{__name__}.{_CLI_EXPORTS[name]}")
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["average_precision", "evaluate", "evaluate_simple",
           "retrieval_metrics", *_CLI_EXPORTS]
