"""Evaluation & metrics (reference L10, code/evaluation.py)."""

from gasfm.eval.metrics import (
    compute_core_errors,
    compute_errors,
    get_dummy_errors,
    prepare_predictions,
    unpad_predictions,
)

__all__ = [
    "compute_core_errors",
    "compute_errors",
    "get_dummy_errors",
    "prepare_predictions",
    "unpad_predictions",
]
