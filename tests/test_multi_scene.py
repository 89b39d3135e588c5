"""Multi-scene learning pipeline smoke test: dataloaders, training with
validation-based early stopping, 3-way eval writer, and per-test-scene
fine-tuning — the full phase state machine of the reference main.py."""

import os

import numpy as np
import pandas as pd
import pytest

import jax

from gasfm.config import load_config
from gasfm.experiments import (
    create_eval_dataloaders,
    eval_model,
    optimization_all_test_scenes,
    train_model,
)
from gasfm.models import get_model
from gasfm.utils import paths
from gasfm.utils.phases import Phases


@pytest.fixture(autouse=True)
def results_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setenv("GASFM_RESULTS_PATH", str(tmp_path))
    import gasfm.utils.observability as obs

    obs.reset_tb_writer()
    yield
    obs.reset_tb_writer()


def test_multi_scene_learning_pipeline():
    conf = load_config(os.path.join("synth", "learning_synth_gasfm.conf"))
    conf.put("exp_dir", "msl_test")
    rng = np.random.default_rng(0)

    datasets, eval_loaders = create_eval_dataloaders(conf, rng=rng)
    assert len(datasets["train_set"]) == 3
    assert len(datasets["test_set"]) == 2

    model = get_model(conf)
    probe = datasets["validation_set"].data_list[0]
    params = model.init(jax.random.PRNGKey(0), probe.to_scene_graph().graph)

    trained, train_stats = train_model(
        conf, model, params, datasets["train_set"], eval_loaders, Phases.TRAINING, rng=rng
    )
    assert "final_model" in trained and "best_model" in trained
    assert np.isfinite(train_stats["best_validation_metric"])

    # 3-way eval writer
    eval_model(conf, model, trained["final_model"], eval_loaders, -1, "final_", rng=rng)
    exp = paths.path_to_exp(conf)
    for name in ("final_train_errors", "final_val_errors", "final_test_errors"):
        path = os.path.join(exp, f"{name}.csv")
        assert os.path.exists(path), path
        df = pd.read_csv(path)
        assert "our_repro" in df.columns

    # Fine-tune each test scene from the trained weights
    results = optimization_all_test_scenes(
        conf, model, trained["best_model"], Phases.FINE_TUNE,
        additional_identifier="from_best", rng=rng,
    )
    assert set(results.keys()) == {"synth_test0", "synth_test1"}
    ft_csv = os.path.join(exp, "final_train_errors_FINE_TUNE_from_best.csv")
    assert os.path.exists(ft_csv)
    df = pd.read_csv(ft_csv)
    assert len(df) == 2  # one row per test scene
