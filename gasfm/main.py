"""CLI entry point.

Parity: reference code/main.py (245 LoC): two subcommands
(``single-scene-optim``, ``multi-scene-learning``), HOCON conf load +
``--external_params`` merge + schema check, seeding, model init by
``model.type``, pretrained-weight loading tolerant of missing head keys,
experiment-dir management, and the phase state machine
(TRAINING -> eval(final/best) -> FINE_TUNE from final/best ->
SHORT_OPTIMIZATION).

Usage:
    python -m gasfm.main single-scene-optim --conf optim_synth_gasfm.conf
    python -m gasfm.main multi-scene-learning --conf learning_synth_gasfm.conf
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Optional

import numpy as np


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    subparsers = parser.add_subparsers(help="Mode-specific arguments.", dest="mode")
    subparsers.required = True

    sso = subparsers.add_parser("single-scene-optim", aliases=["single_scene_optim"])
    sso.set_defaults(mode="single_scene_optim")
    sso.add_argument("--scene", type=str, default=None)
    sso.add_argument(
        "--scene-name-exp-subdir", "--scene_name_exp_subdir", action="store_true", default=False
    )

    msl = subparsers.add_parser("multi-scene-learning", aliases=["multi_scene_learning"])
    msl.set_defaults(mode="multi_scene_learning", scene=None, scene_name_exp_subdir=None)
    msl.add_argument("--old-exp-dir", "--old_exp_dir", type=str, default=None)
    msl.add_argument("--pretrained-model-filename", "--pretrained_model_filename", type=str, default=None)
    msl.add_argument("--skip-training", "--skip_training", action="store_true", default=False)
    msl.add_argument("--skip-fine-tuning", "--skip_fine_tuning", action="store_true", default=False)
    msl.add_argument(
        "--skip-fine-tuning-from-best", "--skip_fine_tuning_from_best",
        action="store_true", default=False,
    )
    msl.add_argument(
        "--skip-fine-tuning-from-final", "--skip_fine_tuning_from_final",
        action="store_true", default=False,
    )
    msl.add_argument("--skip-short-optim", "--skip_short_optim", action="store_true", default=False)

    for p in (sso, msl):
        p.add_argument("--conf", type=str, required=True)
        p.add_argument("--exp-dir", "--exp_dir", type=str, default=None)
        p.add_argument("--overwrite-exp", "--overwrite_exp", action="store_true", default=False)
        p.add_argument("--external-params", "--external_params", type=str, nargs="*", default=[])
        p.add_argument("--pretrained-model-path", "--pretrained_model_path", type=str, default=None)
        # Reference --gpu-not-required (main.py:50): permits accelerator-free
        # init for dry runs; here CPU-backed JAX is always functional, so the
        # flag is accepted for CLI compatibility and ignored.
        p.add_argument(
            "--accelerator-not-required", "--gpu-not-required", "--gpu_not_required",
            action="store_true", default=False,
        )
        p.add_argument(
            "--count-model-params-and-die", "--count_model_params_and_die",
            action="store_true", default=False,
        )

    return parser.parse_args(argv)


def init_exp(args):
    """Conf load + CLI merges + schema validation + seeding
    (parity: main.py:74-132)."""
    from gasfm.config import load_config
    from gasfm.utils.paths import gen_dflt_exp_dir

    conf = load_config(args.conf, external_params=args.external_params)
    if args.scene is not None:
        conf.put("dataset.scene", args.scene)
    exp_dir = args.exp_dir or conf.get_string("exp_dir", default=None) or gen_dflt_exp_dir()
    if args.scene_name_exp_subdir:
        exp_dir = os.path.join(exp_dir, conf.get_string("dataset.scene"))
    conf.put("exp_dir", exp_dir)

    seed = conf.get_int("random_seed", default=0)
    random.seed(seed)
    np.random.seed(seed)
    rng = np.random.default_rng(seed)
    return conf, rng


def init_model(conf, pretrained_model_path: Optional[str] = None):
    """Build the model + init params; optionally restore pretrained weights
    with head-key tolerance (parity: main.py:134-190)."""
    import jax

    from gasfm.data.loaders import create_scene_data
    from gasfm.models import get_model
    from gasfm.train.state import load_params

    model = get_model(conf)
    # Initialize against a small synthetic graph (weights are shape-agnostic).
    from gasfm.data.synthetic import generate_synthetic_scene

    probe = generate_synthetic_scene(n_views=8, n_points=64, seed=0,
                                     calibrated=conf.get_bool("dataset.calibrated"))
    graph = probe.to_scene_graph().graph
    params = model.init(
        jax.random.PRNGKey(conf.get_int("random_seed", default=0)), graph
    )
    n_params = sum(x.size for x in jax.tree_util.tree_leaves(params))
    print(f"#Trainable parameters: {n_params}")
    if pretrained_model_path is not None:
        params = load_params(pretrained_model_path, params)
    return model, params, n_params


def main(argv=None):
    from gasfm.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    args = parse_args(argv)
    conf, rng = init_exp(args)

    from gasfm.experiments import (
        create_eval_dataloaders,
        eval_model,
        optimization_all_test_scenes,
        train_model,
        train_model_single_scene,
    )
    from gasfm.utils.observability import log_code
    from gasfm.utils.phases import Phases

    # Multi-host runtime startup (conf `parallel.distributed.*`) — must run
    # before any device query so the global mesh spans every host's devices.
    from gasfm.parallel import initialize_distributed

    initialize_distributed(conf)

    pretrained = args.pretrained_model_path
    if pretrained is None and getattr(args, "old_exp_dir", None):
        name = getattr(args, "pretrained_model_filename", None) or "best_model.npz"
        pretrained = os.path.join(args.old_exp_dir, "models", name)

    model, params, n_params = init_model(conf, pretrained)
    if args.count_model_params_and_die:
        return 0

    # Optionally wipe an existing experiment dir (parity: main.py:154-157).
    if getattr(args, "overwrite_exp", False):
        import shutil

        from gasfm.utils.paths import path_to_exp

        exp_path = path_to_exp(conf, create=False)
        if os.path.exists(exp_path):
            shutil.rmtree(exp_path)

    log_code(conf)

    if args.mode == "single_scene_optim":
        train_model_single_scene(conf, model, params, Phases.OPTIMIZATION, rng=rng)
    else:
        datasets, eval_loaders = create_eval_dataloaders(conf, rng=rng)
        if not getattr(args, "skip_training", False):
            trained, _ = train_model(conf, model, params, datasets["train_set"], eval_loaders,
                                     Phases.TRAINING, rng=rng)
        else:
            trained = {"final_model": params, "best_model": params}

        eval_model(conf, model, trained["final_model"], eval_loaders, -1, "final_", rng=rng)
        if "best_model" in trained:
            eval_model(conf, model, trained["best_model"], eval_loaders, None, "best_", rng=rng)

        # Fine-tune each test scene from the trained weights
        # (parity: main.py:224-229).
        skip_ft = getattr(args, "skip_fine_tuning", False)
        if not skip_ft and not getattr(args, "skip_fine_tuning_from_final", False):
            optimization_all_test_scenes(conf, model, trained["final_model"], Phases.FINE_TUNE,
                                         additional_identifier="from_final", rng=rng)
        if (
            "best_model" in trained
            and not skip_ft
            and not getattr(args, "skip_fine_tuning_from_best", False)
        ):
            optimization_all_test_scenes(conf, model, trained["best_model"], Phases.FINE_TUNE,
                                         additional_identifier="from_best", rng=rng)

        # Short optimization from fresh weights (parity: main.py:237-240).
        if not getattr(args, "skip_short_optim", False):
            _, fresh_params, _ = init_model(conf)
            optimization_all_test_scenes(conf, model, fresh_params, Phases.SHORT_OPTIMIZATION,
                                         rng=rng)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
