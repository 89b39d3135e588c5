"""End-to-end single-scene optimization: the full pipeline (data -> graph ->
model -> loss -> optimizer -> eval -> BA -> artifacts) on a synthetic scene.

This is the port of the reference's only true integration fixture — the
"use_gt" zero-error consistency mode (SURVEY section 4 item 2): on
noise-free data a short optimization must drive reprojection error down
substantially and BA must then refine close to zero.
"""

import os

import numpy as np
import pandas as pd
import pytest

import jax

from gasfm.config import load_config
from gasfm.data.dataset import SceneLoader, ScenesDataSet
from gasfm.data.loaders import create_scene_data
from gasfm.models import get_model
from gasfm.train.loop import TrainingSession, aggregate_val_metric, epoch_evaluation, train
from gasfm.utils.phases import Phases


@pytest.fixture(autouse=True)
def results_tmpdir(tmp_path, monkeypatch):
    monkeypatch.setenv("GASFM_RESULTS_PATH", str(tmp_path))
    import gasfm.utils.observability as obs

    obs.reset_tb_writer()
    yield
    obs.reset_tb_writer()


def short_conf(name, n_epochs=60, eval_interval=1000):
    conf = load_config(os.path.join("synth", name))
    conf.put("exp_dir", "e2e_test")
    conf.put("train.n_epochs", n_epochs)
    conf.put("eval.eval_interval", eval_interval)  # no mid-train evals
    conf.put("eval.eval_init", False)
    conf.put("train.print_interval", None)
    return conf


def run_short_optimization(conf):
    data = create_scene_data(conf)
    loader = SceneLoader(ScenesDataSet([data], return_all=True), batch_size=1, prefetch=0)
    model = get_model(conf)
    graph = data.to_scene_graph().graph
    params = model.init(jax.random.PRNGKey(0), graph)

    session = TrainingSession(conf, model)
    errors_before = epoch_evaluation(
        loader, session, params, conf, -1, Phases.OPTIMIZATION,
        bundle_adjustment=False, crash_on_scene_exhausting_memory=True,
    )

    trained, _ = train(conf, loader, model, params, Phases.OPTIMIZATION)

    errors_after = epoch_evaluation(
        loader, session, trained["final_model"], conf, -1, Phases.OPTIMIZATION,
        bundle_adjustment=True, crash_on_scene_exhausting_memory=True,
    )
    return errors_before, errors_after, data


class TestEndToEnd:
    def test_dpesfm_optimization_improves_and_ba_refines(self):
        conf = short_conf("optim_synth_dpesfm.conf", n_epochs=150)
        before, after, data = run_short_optimization(conf)
        repro_before = aggregate_val_metric(before, "our_repro")
        repro_after = aggregate_val_metric(after, "our_repro")
        assert np.isfinite(repro_after)
        # Training must reduce reprojection error dramatically from the
        # random initialization.
        assert repro_after < repro_before * 0.5
        # BA on the final prediction refines further (noise-free scene).
        assert aggregate_val_metric(after, "repro_ba") <= repro_after + 1e-6
        # Rotation errors must be meaningful numbers.
        assert np.isfinite(aggregate_val_metric(after, "R_err_mean"))

    def test_gasfm_optimization_improves(self):
        conf = short_conf("optim_synth_gasfm.conf", n_epochs=80)
        conf.put("ba.run_ba", True)
        before, after, data = run_short_optimization(conf)
        assert aggregate_val_metric(after, "our_repro") < aggregate_val_metric(before, "our_repro")
        assert np.isfinite(aggregate_val_metric(after, "repro_ba"))


class TestSingleSceneDriver:
    def test_train_model_single_scene_writes_artifacts(self, tmp_path):
        from gasfm.experiments import train_model_single_scene
        from gasfm.utils import paths

        conf = short_conf("optim_synth_dpesfm.conf", n_epochs=10)
        conf.put("ba.run_ba", False)
        data = create_scene_data(conf)
        model = get_model(conf)
        params = model.init(jax.random.PRNGKey(0), data.to_scene_graph().graph)

        trained, stats, errors = train_model_single_scene(
            conf, model, params, Phases.OPTIMIZATION
        )
        exp_path = paths.path_to_exp(conf)
        results_csv = os.path.join(exp_path, "final_train_errors_OPTIMIZATION.csv")
        assert os.path.exists(results_csv)
        df = pd.read_csv(results_csv)
        assert "our_repro" in df.columns
        # final model weights dumped
        models_dir = paths.path_to_models_dir(conf, Phases.OPTIMIZATION)
        assert os.path.exists(os.path.join(models_dir, "final_model.npz"))


class TestProjectiveEndToEnd:
    """The uncalibrated pipeline end-to-end: Differentiable-Chirality head
    normalization, projective evaluation (alignment w/o calibration), and
    proj_ba (the reference's projective benchmark path — driver config #4;
    reference baseNet.py:59-81, ba_functions.py:75-136)."""

    def test_projective_optimization_improves_and_proj_ba_runs(self):
        conf = short_conf("optim_synth_proj_gasfm.conf", n_epochs=150)
        before, after, data = run_short_optimization(conf)
        assert not data.calibrated
        repro_before = aggregate_val_metric(before, "our_repro")
        repro_after = aggregate_val_metric(after, "our_repro")
        assert np.isfinite(repro_after)
        # The target is in px because the start varies two-fold between
        # initial draws (188-397 px for seeds 0-5 of the initializer), while
        # 150 epochs bring every one of them to 100-141 px.
        assert repro_after < repro_before
        assert repro_after < 150.0
        # proj_ba ran and produced finite refined errors.
        assert np.isfinite(aggregate_val_metric(after, "repro_ba"))
        assert aggregate_val_metric(after, "repro_ba") <= repro_after + 1e-6


class TestDepthHeadEndToEnd:
    """Depth-only training: DirectDepthLoss on GT depths + the random-2view
    backprojection reprojection metric as the validation signal (reference
    loss_functions.py:24-66, evaluation.py:393-464, train.py:396-401)."""

    def test_depth_training_reduces_loss_and_backproj_error(self):
        conf = short_conf("optim_synth_depth_gasfm.conf", n_epochs=300)
        conf.put("train.lr", 0.003)
        data = create_scene_data(conf)
        assert data.depths is not None  # GT depth targets derived
        loader = SceneLoader(ScenesDataSet([data], return_all=True), batch_size=1, prefetch=0)
        model = get_model(conf)
        sg = data.to_scene_graph()
        params = model.init(jax.random.PRNGKey(0), sg.graph)

        from gasfm.losses import get_loss_func

        loss_func = get_loss_func(conf)
        session = TrainingSession(conf, model)
        before = epoch_evaluation(
            loader, session, params, conf, -1, Phases.OPTIMIZATION,
            bundle_adjustment=False, crash_on_scene_exhausting_memory=True,
        )
        loss_before = float(loss_func(model.apply(params, sg.graph), sg))
        trained, _ = train(conf, loader, model, params, Phases.OPTIMIZATION)
        after = epoch_evaluation(
            loader, session, trained["final_model"], conf, -1, Phases.OPTIMIZATION,
            bundle_adjustment=False, crash_on_scene_exhausting_memory=True,
        )
        loss_after = float(loss_func(model.apply(trained["final_model"], sg.graph), sg))

        # DirectDepthLoss decreased (convergence to GT depths is a
        # long-horizon affair — the reference trains 1e5 epochs — so the CI
        # bar is monotone improvement plus a healthy metric battery).
        assert loss_after < loss_before
        col = "repro_backproj_rnd_gt_2view"
        assert col in after[-1]  # the Mean row
        assert np.isfinite(aggregate_val_metric(after, col))
        # Margin 1.10: this is a "did not get WORSE" guard on a noisy
        # secondary metric after only 300 of the reference's 1e5 epochs —
        # measured runs land within ~3% of the starting value either way
        # (the primary criteria are the strict loss/depth-error decreases
        # above/below).
        assert aggregate_val_metric(after, col) <= aggregate_val_metric(before, col) * 1.10
        for stat_col in ("depth_pred_err_mean", "depth_pred_norm_q50", "depth_gt_norm_q50"):
            assert np.isfinite(aggregate_val_metric(after, stat_col))
        assert aggregate_val_metric(after, "depth_pred_err_mean") < aggregate_val_metric(before, "depth_pred_err_mean")
