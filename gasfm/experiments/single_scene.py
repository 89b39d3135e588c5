"""Single-scene optimization / fine-tuning driver.

Parity: reference code/single_scene_optimization.py:15-123 — build one
SceneData, run the training loop, evaluate final (and best) params with BA,
tolerate OOM with dummy-error rows, append per-scene rows to the results
table joined with train stats.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gasfm.data.dataset import SceneLoader, ScenesDataSet
from gasfm.data.loaders import create_scene_data
from gasfm.eval.metrics import get_dummy_errors
from gasfm.train.loop import (
    TrainingSession,
    epoch_evaluation,
    eval_errors_table,
    get_dummy_train_stats,
    train,
)
from gasfm.train.loop import _is_oom_error
from gasfm.utils.observability import write_results
from gasfm.utils.paths import get_additional_identifiers_for_outlier_injection


def _write_train_res(conf, errors, train_stats, file_name: str, ids):
    rows = [{**row, **train_stats} for row in errors if row["Scene"] != "Mean"]
    write_results(conf, rows, file_name=file_name, additional_identifiers=ids, append=True)


def train_model_single_scene(
    conf,
    model,
    params,
    phase,
    additional_identifier: Optional[str] = None,
    crash_on_scene_exhausting_memory: bool = True,
    rng: Optional[np.random.Generator] = None,
):
    additional_identifiers = [] if additional_identifier is None else [additional_identifier]
    outlier_injection_rate = conf.get_float("train.outlier_injection_rate", default=None)
    run_ba = conf.get_bool("ba.run_ba", default=True)
    stdout_log_eval_memory = conf.get_bool("memory.stdout_log_eval_memory_consumption", default=False)
    no_crash_post_train = conf.get_bool(
        "memory.post_train_eval_no_crash_on_scene_exhausting_memory", default=True
    )
    outlier_ids = get_additional_identifiers_for_outlier_injection(outlier_injection_rate)
    if rng is None:
        rng = np.random.default_rng(conf.get_int("random_seed", default=0))

    scene_data = create_scene_data(conf)
    scene_dataset = ScenesDataSet([scene_data], return_all=True)
    scene_loader = SceneLoader(scene_dataset, batch_size=1, shuffle=False, prefetch=0)

    trained_params, train_stats = train(
        conf, scene_loader, model, params, phase, additional_identifier=additional_identifier, rng=rng
    )

    session = TrainingSession(conf, model)
    best_train_errors = None
    try:
        final_train_errors = epoch_evaluation(
            scene_loader, session, trained_params["final_model"], conf, -1, phase,
            outlier_injection_rate=outlier_injection_rate, dump_and_plot_predictions=True,
            additional_identifiers=additional_identifiers + outlier_ids,
            bundle_adjustment=run_ba, log_memory_consumption=stdout_log_eval_memory,
            crash_on_scene_exhausting_memory=not no_crash_post_train, rng=rng,
        )
        final_train_errors_outlierfree = None
        if outlier_injection_rate is not None:
            final_train_errors_outlierfree = epoch_evaluation(
                scene_loader, session, trained_params["final_model"], conf, -1, phase,
                dump_and_plot_predictions=True, additional_identifiers=additional_identifiers,
                bundle_adjustment=run_ba, log_memory_consumption=stdout_log_eval_memory,
                crash_on_scene_exhausting_memory=not no_crash_post_train, rng=rng,
            )
        if conf.get_string("train.validation_metric", default=None) is not None:
            assert "best_model" in trained_params
            best_train_errors = epoch_evaluation(
                scene_loader, session, trained_params["best_model"], conf, None, phase,
                outlier_injection_rate=outlier_injection_rate, dump_and_plot_predictions=True,
                additional_identifiers=additional_identifiers + outlier_ids,
                bundle_adjustment=run_ba, log_memory_consumption=stdout_log_eval_memory,
                crash_on_scene_exhausting_memory=not no_crash_post_train, rng=rng,
            )
            if outlier_injection_rate is not None:
                best_train_errors_outlierfree = epoch_evaluation(
                    scene_loader, session, trained_params["best_model"], conf, None, phase,
                    dump_and_plot_predictions=True, additional_identifiers=additional_identifiers,
                    bundle_adjustment=run_ba, log_memory_consumption=stdout_log_eval_memory,
                    crash_on_scene_exhausting_memory=not no_crash_post_train, rng=rng,
                )
    except Exception as e:  # noqa: BLE001 - OOM-tolerance parity (sso.py:50-78)
        if not _is_oom_error(e):
            raise
        if crash_on_scene_exhausting_memory:
            raise
        print(f"Ran out of memory when fine-tuning on {scene_data.scene_name}.")
        errors = get_dummy_errors(conf, run_ba)
        errors["Inference time"] = float("nan")
        errors["Scene"] = scene_data.scene_name
        final_train_errors = eval_errors_table([errors])
        final_train_errors_outlierfree = None
        if conf.get_string("train.validation_metric", default=None) is not None:
            best_train_errors = eval_errors_table([dict(errors)])
        train_stats = get_dummy_train_stats()

    _write_train_res(
        conf, final_train_errors, train_stats,
        f"final_train_errors_{phase.name}", additional_identifiers + outlier_ids,
    )
    if outlier_injection_rate is not None and final_train_errors_outlierfree is not None:
        _write_train_res(
            conf, final_train_errors_outlierfree, train_stats,
            f"final_train_errors_{phase.name}", additional_identifiers,
        )
    if best_train_errors is not None:
        _write_train_res(
            conf, best_train_errors, train_stats,
            f"best_train_errors_{phase.name}", additional_identifiers + outlier_ids,
        )

    return trained_params, train_stats, final_train_errors
