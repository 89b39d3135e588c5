"""Experiment orchestration (reference L2): single-scene optimization and
multi-scene learning drivers."""

from gasfm.experiments.single_scene import train_model_single_scene
from gasfm.experiments.multi_scene import (
    create_eval_dataloaders,
    eval_model,
    optimization_all_test_scenes,
    train_model,
)

__all__ = [
    "create_eval_dataloaders",
    "eval_model",
    "optimization_all_test_scenes",
    "train_model",
    "train_model_single_scene",
]
