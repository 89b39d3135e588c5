"""Training subsystem: loop controller, optimizer/schedules, checkpoints.

Parity surface: reference code/train.py (L3)."""

from gasfm.train.loop import (
    TrainingSession,
    aggregate_val_metric,
    epoch_evaluation,
    epoch_train,
    eval_errors_table,
    get_dummy_train_stats,
    train,
)
from gasfm.train.schedules import build_lr_schedule, schedule_from_conf
from gasfm.train.state import (
    TrainState,
    build_optimizer,
    create_train_state,
    load_params,
    restore_checkpoint,
    save_checkpoint,
    save_params,
)

__all__ = [
    "TrainState",
    "TrainingSession",
    "aggregate_val_metric",
    "build_lr_schedule",
    "build_optimizer",
    "create_train_state",
    "epoch_evaluation",
    "epoch_train",
    "eval_errors_table",
    "get_dummy_train_stats",
    "load_params",
    "restore_checkpoint",
    "save_checkpoint",
    "save_params",
    "schedule_from_conf",
    "train",
]
