"""Multi-scene learning driver.

Parity: reference code/multiple_scenes_learning.py:14-136 — build train/val/
test scene sets and loaders, training wrapper, 3-way eval writer, and the
fine-tuning orchestrator that deep-copies the conf with fine-tune overrides
and runs single-scene optimization per test scene.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from gasfm.data.dataset import SceneLoader, ScenesDataSet
from gasfm.data.loaders import create_scene_data_from_list
from gasfm.experiments.single_scene import train_model_single_scene
from gasfm.train.loop import TrainingSession, epoch_evaluation, train
from gasfm.utils.observability import write_results
from gasfm.utils.paths import get_additional_identifiers_for_outlier_injection
from gasfm.utils.phases import Phases


def create_eval_dataloaders(conf, rng: Optional[np.random.Generator] = None) -> Tuple[Dict, Dict]:
    """Parity: reference multiple_scenes_learning.py:14-53."""
    min_views = conf.get_int("dataset.min_num_views_sampled")
    max_views = conf.get_int("dataset.max_num_views_sampled")
    inplane = conf.get_float("dataset.inplane_rot_aug_max_angle", default=None)
    tilt = conf.get_float("dataset.tilt_rot_aug_max_angle", default=None)
    if rng is None:
        rng = np.random.default_rng(conf.get_int("random_seed", default=0))

    test_scenes = create_scene_data_from_list(conf.get_list("dataset.test_set"), conf)
    validation_scenes = create_scene_data_from_list(conf.get_list("dataset.validation_set"), conf)
    train_scenes = create_scene_data_from_list(conf.get_list("dataset.train_set"), conf)

    datasets = {
        "train_set": ScenesDataSet(
            train_scenes,
            return_all=False,
            min_num_views_sampled=min_views,
            max_num_views_sampled=max_views,
            inplane_rot_aug_max_angle=inplane,
            tilt_rot_aug_max_angle=tilt,
            rng=rng,
        ),
        "train_set_for_eval": ScenesDataSet(train_scenes, return_all=True),
        "validation_set": ScenesDataSet(validation_scenes, return_all=True),
        "test_set": ScenesDataSet(test_scenes, return_all=True),
    }
    eval_data_loaders = {
        "train_loader_for_eval": SceneLoader(datasets["train_set_for_eval"], batch_size=1),
        "validation_loader": SceneLoader(datasets["validation_set"], batch_size=1),
        "test_loader": SceneLoader(datasets["test_set"], batch_size=1),
    }
    return datasets, eval_data_loaders


def train_model(conf, model, params, train_set, eval_data_loaders, phase, rng=None):
    """Parity: reference multiple_scenes_learning.py:55-72."""
    assert phase == Phases.TRAINING
    batch_size = conf.get_int("dataset.batch_size")
    train_loader = SceneLoader(
        train_set, batch_size=batch_size, shuffle=True,
        rng=rng if rng is not None else np.random.default_rng(conf.get_int("random_seed", default=0)),
        # Reference DataLoader worker processes (multiple_scenes_learning.py:
        # 48-50); 0/null keeps the in-process prefetch-thread path.
        num_workers=conf.get_int("dataset.dataloader_num_workers", default=0) or 0,
    )
    try:
        trained_params, train_stats = train(
            conf, train_loader, model, params, phase,
            train_loader_for_eval=eval_data_loaders["train_loader_for_eval"],
            val_loader=eval_data_loaders["validation_loader"],
            test_loader=eval_data_loaders["test_loader"],
            rng=rng,
        )
    finally:
        # Terminate the fork worker pool (if any) deterministically at the
        # end of training instead of relying on __del__ (advisor round 2).
        train_loader.close()
    write_results(conf, [train_stats], file_name="train_stats")
    return trained_params, train_stats


def eval_model(conf, model, params, data_loaders, store_as_epoch, filename_prefix, rng=None):
    """Parity: reference multiple_scenes_learning.py:75-99."""
    outlier_injection_rate = conf.get_float("train.outlier_injection_rate", default=None)
    run_ba = conf.get_bool("ba.run_ba", default=True)
    stdout_log_eval_memory = conf.get_bool("memory.stdout_log_eval_memory_consumption", default=False)
    no_crash = conf.get_bool("memory.post_train_eval_no_crash_on_scene_exhausting_memory", default=True)
    outlier_ids = get_additional_identifiers_for_outlier_injection(outlier_injection_rate)

    session = TrainingSession(conf, model)
    loaders_phases = [
        ("train_loader_for_eval", Phases.TRAINING, "train_errors"),
        ("validation_loader", Phases.VALIDATION, "val_errors"),
        ("test_loader", Phases.TEST, "test_errors"),
    ]
    results = {}
    for loader_key, ph, name in loaders_phases:
        errors = epoch_evaluation(
            data_loaders[loader_key], session, params, conf, store_as_epoch, ph,
            outlier_injection_rate=outlier_injection_rate, dump_and_plot_predictions=True,
            additional_identifiers=outlier_ids, bundle_adjustment=run_ba,
            log_memory_consumption=stdout_log_eval_memory,
            crash_on_scene_exhausting_memory=not no_crash, rng=rng,
        )
        write_results(conf, errors, file_name=filename_prefix + name,
                      additional_identifiers=outlier_ids)
        results[name] = errors
        if outlier_injection_rate is not None:
            errors_of = epoch_evaluation(
                data_loaders[loader_key], session, params, conf, store_as_epoch, ph,
                dump_and_plot_predictions=True, additional_identifiers=[],
                bundle_adjustment=run_ba, log_memory_consumption=stdout_log_eval_memory,
                crash_on_scene_exhausting_memory=not no_crash, rng=rng,
            )
            write_results(conf, errors_of, file_name=filename_prefix + name)
    return results


def optimization_all_test_scenes(conf, model, params, phase, additional_identifier=None, rng=None):
    """Fine-tune / short-optimize every test scene from the given params.

    Parity: reference multiple_scenes_learning.py:102-136. NOTE: the
    reference writes its finetune eval-interval override to the never-read
    key ``train.eval_interval`` (msl.py:124), so upstream fine-tuning
    silently keeps the global ``eval.eval_interval``; here the override is
    applied to the key that is actually read.
    """
    finetune_n_epochs = conf.get_int("train.finetune_n_epochs")
    finetune_eval_interval = conf.get_int("train.finetune_eval_interval")
    finetune_dump_model_interval = conf.get_int("train.finetune_dump_model_interval", default=None)
    finetune_dump_plot_interval = conf.get_int("train.finetune_dump_and_plot_pred_interval", default=None)
    finetune_lr = conf.get_float("train.finetune_lr")
    finetune_warmup = conf.get_int("train.finetune_lr_warmup_n_steps", default=0)
    no_crash = conf.get_bool("memory.finetune_no_crash_on_scene_exhausting_memory", default=True)

    test_scenes_list = conf.get_list("dataset.test_set")

    conf_test = conf.copy()
    # Fine-tuning has no validation set, so no best-model tracking. (In the
    # reference, a learning conf with train.validation_metric set would trip
    # the 'best_model' assert in single_scene_optimization.py:31 during
    # FINE_TUNE — latent upstream bug; cleared here per evident intent.)
    conf_test.put("train.validation_metric", None)
    conf_test.put("train.n_epochs", finetune_n_epochs)
    conf_test.put("eval.eval_interval", finetune_eval_interval)
    conf_test.put("train.finetune_dump_model_interval", finetune_dump_model_interval)
    conf_test.put("train.finetune_dump_and_plot_pred_interval", finetune_dump_plot_interval)
    conf_test.put("train.lr", finetune_lr)
    conf_test.put("train.lr_schedule.lr_warmup_n_steps", finetune_warmup)
    conf_test.put("train.lr_schedule.main_scheduler", "constant")

    initial_params_flat = [np.asarray(x) for x in __import__("jax").tree_util.tree_leaves(params)]
    results = {}
    for scene in test_scenes_list:
        conf_test.put("dataset.scene", scene)
        # Sanity: initial parameters must not have been mutated in place by a
        # previous optimization loop (parity: msl.py:134-135).
        current_flat = [np.asarray(x) for x in __import__("jax").tree_util.tree_leaves(params)]
        for a, b in zip(initial_params_flat, current_flat):
            assert np.array_equal(a, b)
        results[scene] = train_model_single_scene(
            conf_test, model, params, phase,
            additional_identifier=additional_identifier,
            crash_on_scene_exhausting_memory=not no_crash,
            rng=rng,
        )
    return results
