"""Training-component tests: LR schedule parity with torch schedulers,
optimizer construction, checkpoint save/restore round trips."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gasfm.config import ConfigFactory
from gasfm.train.schedules import build_lr_schedule
from gasfm.train.state import (
    TrainState,
    create_train_state,
    load_params,
    restore_checkpoint,
    save_checkpoint,
    save_params,
)


def torch_lr_trace(base_lr, warmup, main, n_steps, **kw):
    """The reference scheduler chain (train.py:437-472) stepped per batch."""
    p = torch.nn.Parameter(torch.zeros(1))
    opt = torch.optim.Adam([p], lr=base_lr)
    if main == "constant":
        lr_main = None
    elif main == "exponential":
        gamma = kw["exp_gamma_after_n_steps"] ** (1.0 / kw["exp_n_steps"])
        lr_main = torch.optim.lr_scheduler.ExponentialLR(opt, gamma=gamma)
    elif main == "multistep":
        lr_main = torch.optim.lr_scheduler.MultiStepLR(
            opt, milestones=kw["milestones"], gamma=kw["gamma"]
        )
    warm = torch.optim.lr_scheduler.LinearLR(
        opt, start_factor=1.0 / (warmup + 1), end_factor=1.0, total_iters=warmup
    )
    if lr_main is not None:
        sched = torch.optim.lr_scheduler.SequentialLR(
            opt, schedulers=[warm, lr_main], milestones=[warmup]
        )
    else:
        sched = warm
    out = []
    for _ in range(n_steps):
        out.append(sched.get_last_lr()[0])
        opt.step()
        sched.step()
    return np.array(out)


class TestSchedules:
    def test_warmup_exponential_matches_torch(self):
        kw = dict(exp_gamma_after_n_steps=0.1, exp_n_steps=100.0)
        ref = torch_lr_trace(1e-3, 10, "exponential", 60, **kw)
        sched = build_lr_schedule(1e-3, "exponential", lr_warmup_n_steps=10,
                                  exp_gamma_after_n_steps=0.1, exp_n_steps=100.0)
        ours = np.array([float(sched(t)) for t in range(60)])
        np.testing.assert_allclose(ours, ref, rtol=1e-5)

    def test_warmup_constant_matches_torch(self):
        ref = torch_lr_trace(1e-3, 5, "constant", 20)
        sched = build_lr_schedule(1e-3, "constant", lr_warmup_n_steps=5)
        ours = np.array([float(sched(t)) for t in range(20)])
        np.testing.assert_allclose(ours, ref, rtol=1e-5)

    def test_warmup_multistep_matches_torch(self):
        ref = torch_lr_trace(1e-2, 4, "multistep", 40, milestones=[10, 20], gamma=0.5)
        sched = build_lr_schedule(1e-2, "multistep", lr_warmup_n_steps=4,
                                  multistep_milestones=[10, 20], multistep_gamma=0.5)
        ours = np.array([float(sched(t)) for t in range(40)])
        np.testing.assert_allclose(ours, ref, rtol=1e-5)

    def test_no_warmup(self):
        sched = build_lr_schedule(1e-3, "constant", lr_warmup_n_steps=0)
        assert float(sched(0)) == pytest.approx(1e-3)


CONF = """
train {
  lr = 0.001
  lr_schedule { lr_warmup_n_steps = 0, main_scheduler = "constant" }
}
loss { grad_clip_mode = null }
"""


class TestCheckpointing:
    def _params(self):
        k = jax.random.PRNGKey(0)
        return {
            "dense": {"kernel": jax.random.normal(k, (8, 4)), "bias": jnp.zeros(4)},
            "scale": jnp.ones(3),
        }

    def test_full_state_roundtrip(self, tmp_path):
        conf = ConfigFactory.parse_string(CONF)
        params = self._params()
        state, tx, _ = create_train_state(conf, params)
        state = TrainState(params=state.params, opt_state=state.opt_state,
                           step=jnp.asarray(17, jnp.int32))
        ckpt_dir = str(tmp_path / "ckpt")
        save_checkpoint(ckpt_dir, state, keep=2)
        template, _, _ = create_train_state(conf, self._params())
        restored = restore_checkpoint(ckpt_dir, template)
        assert restored is not None
        assert int(restored.step) == 17
        for a, b in zip(jax.tree_util.tree_leaves(state.params),
                        jax.tree_util.tree_leaves(restored.params)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    def test_restore_missing_dir_returns_none(self, tmp_path):
        conf = ConfigFactory.parse_string(CONF)
        template, _, _ = create_train_state(conf, self._params())
        assert restore_checkpoint(str(tmp_path / "nope"), template) is None

    def test_params_npz_roundtrip_with_missing_keys(self, tmp_path):
        params = self._params()
        path = str(tmp_path / "w.npz")
        save_params(path, params)
        # Template with an extra head: missing keys keep their init values
        template = dict(params)
        template["extra_head"] = {"kernel": jnp.full((2, 2), 7.0)}
        out = load_params(path, template)
        np.testing.assert_array_equal(np.asarray(out["dense"]["kernel"]),
                                      np.asarray(params["dense"]["kernel"]))
        np.testing.assert_array_equal(np.asarray(out["extra_head"]["kernel"]),
                                      np.full((2, 2), 7.0))


class TestTrainLoopResume:
    def test_checkpoint_resume_continues_training(self, tmp_path, monkeypatch):
        monkeypatch.setenv("GASFM_RESULTS_PATH", str(tmp_path))
        import gasfm.utils.observability as obs

        obs.reset_tb_writer()
        import os

        from gasfm.config import load_config
        from gasfm.data.dataset import SceneLoader, ScenesDataSet
        from gasfm.data.loaders import create_scene_data
        from gasfm.models import get_model
        from gasfm.train.loop import train
        from gasfm.utils.phases import Phases

        conf = load_config(os.path.join("synth", "optim_synth_dpesfm.conf"))
        conf.put("exp_dir", "resume_test")
        conf.put("train.n_epochs", 4)
        conf.put("eval.eval_interval", 100)
        conf.put("eval.eval_init", False)
        conf.put("train.print_interval", None)
        conf.put("checkpoint.enabled", True)
        conf.put("checkpoint.interval", 2)
        conf.put("checkpoint.resume", True)

        data = create_scene_data(conf)
        loader = SceneLoader(ScenesDataSet([data], return_all=True), batch_size=1, prefetch=0)
        model = get_model(conf)
        params = model.init(jax.random.PRNGKey(0), data.to_scene_graph().graph)

        # First run: 4 epochs, checkpoints at 2 and 4.
        trained1, _ = train(conf, loader, model, params, Phases.OPTIMIZATION)
        ckpt_dir = os.path.join(
            str(tmp_path), "resume_test", "OPTIMIZATION", data.scene_name, "models", "train_state"
        )
        assert os.path.isdir(ckpt_dir)

        # Second run with more epochs resumes from epoch 4.
        conf.put("train.n_epochs", 6)
        import io
        from contextlib import redirect_stdout

        buf = io.StringIO()
        with redirect_stdout(buf):
            trained2, _ = train(conf, loader, model, params, Phases.OPTIMIZATION)
        assert "resumed at epoch 4" in buf.getvalue()

        # The resumed run's checkpoints carry ALL FOUR counters (review
        # round 5): [next_epoch, n_updates, total_n_batches,
        # n_epochs_post_warmup+1] — resume used to zero total_n_batches and
        # the post-warmup epoch count, silently restarting the
        # view-increment curriculum and TB step indices while the restored
        # LR schedule continued at its old position.
        from gasfm.train.state import TrainState, restore_checkpoint

        template = TrainState(
            params=params,
            opt_state=create_train_state(conf, params)[0].opt_state,
            step=jnp.zeros((4,), jnp.int32),
        )
        final = restore_checkpoint(ckpt_dir, template)
        assert final is not None
        st = np.asarray(final.step)
        assert st.shape == (4,)
        assert st[0] == 6  # next epoch
        assert st[2] == 6  # one batch per epoch -> total_n_batches resumed
        # lr_warmup_n_steps = 50 in this conf; 6 batches < 50 -> still in
        # warmup, n_epochs_post_warmup is None, encoded as 0.
        assert st[3] == 0
        obs.reset_tb_writer()


class TestDepthOnlyValidationMetricFailFast:
    def test_missing_backproj_flag_raises_at_train_start(self, tmp_path, monkeypatch):
        """Depth-head-only TRAINING defaults validation_metric to
        'repro_backproj_rnd_gt_2view', a column compute_errors only emits
        when eval.calc_reprojerr_with_gtposes_for_depth_pred is on — the
        first validation used to die with a bare KeyError deep in
        aggregate_val_metric (review round 5). train() must fail fast with
        a descriptive error instead."""
        monkeypatch.setenv("GASFM_RESULTS_PATH", str(tmp_path))
        import os

        import pytest as _pytest

        from gasfm.config import load_config
        from gasfm.data.dataset import SceneLoader, ScenesDataSet
        from gasfm.data.loaders import create_scene_data
        from gasfm.models import get_model
        from gasfm.train.loop import train
        from gasfm.utils.phases import Phases

        conf = load_config(os.path.join("synth", "optim_synth_depth_gasfm.conf"))
        conf.put("exp_dir", "depth_failfast_test")
        conf.put("train.n_epochs", 1)
        conf.put("eval.calc_reprojerr_with_gtposes_for_depth_pred", False)

        data = create_scene_data(conf)
        ds = ScenesDataSet([data], return_all=True)
        loader = SceneLoader(ds, batch_size=1, prefetch=0)
        model = get_model(conf)
        params = model.init(jax.random.PRNGKey(0), data.to_scene_graph().graph)
        with _pytest.raises(ValueError, match="calc_reprojerr_with_gtposes_for_depth_pred"):
            train(conf, loader, model, params, Phases.TRAINING,
                  train_loader_for_eval=loader, val_loader=loader, test_loader=loader)


class TestScheduleAdvanceOnSkippedBatch:
    def test_advance_schedule_count_matches_reference_semantics(self):
        """The reference steps its scheduler on EVERY batch but the optimizer
        only on batches with valid samples (train.py:152 vs :133);
        advance_schedule_count reproduces that split: after one skipped
        batch, the first real update applies schedule(1), while Adam's bias
        correction stays at its first step."""
        import optax

        from gasfm.config import ConfigFactory
        from gasfm.train.state import advance_schedule_count, build_optimizer

        conf = ConfigFactory.parse_string("""
train { lr = 0.001,
  lr_schedule { main_scheduler = multistep, lr_warmup_n_steps = 0,
                multistep_milestones = [1, 4], multistep_gamma = 0.1 } }
""")
        for nu_dtype in [None, "bf16"]:
            if nu_dtype:
                conf.put("train.adam_nu_dtype", nu_dtype)
            tx, sched = build_optimizer(conf)
            p = {"w": jnp.ones((3,))}
            o = tx.init(p)
            o = advance_schedule_count(o)  # the skipped batch
            u, o = tx.update({"w": jnp.full((3,), 0.1)}, o, p)
            # First real update: Adam's debiased direction is sign(g)=1, so
            # the applied magnitude is (within eps) the LR at schedule step 1.
            np.testing.assert_allclose(float(-u["w"][0]), float(sched(1)), rtol=1e-4)

    def test_epoch_train_invalid_batch_advances_schedule_only(self, tmp_path, monkeypatch):
        monkeypatch.setenv("GASFM_RESULTS_PATH", str(tmp_path))
        import os

        import optax

        from gasfm.config import load_config
        from gasfm.data.dataset import SceneLoader, ScenesDataSet
        from gasfm.data.synthetic import generate_synthetic_scene
        from gasfm.models import get_model
        from gasfm.train.loop import TrainingSession, epoch_train
        from gasfm.utils.phases import Phases

        conf = load_config(os.path.join("synth", "learning_synth_gasfm.conf"))
        conf.put("exp_dir", "sched_adv_test")
        # A scene that fails is_valid_sample: zero out view 0's observations
        # so it sees < 8 points (MIN_N_POINTS_PER_VIEW).
        from gasfm.data.scene import SceneData

        src = generate_synthetic_scene(n_views=8, n_points=64, seed=0)
        M = np.array(src.M)
        M[0:2, 4:] = 0.0
        bad = SceneData(M, src.Ns, src.y, scene_name="bad", calibrated=True)
        assert not bad.is_valid_sample()
        model = get_model(conf)
        session = TrainingSession(conf, model)
        good = generate_synthetic_scene(n_views=8, n_points=64, seed=1)
        graph = session.bucketize(good).graph
        params = model.init(jax.random.PRNGKey(0), graph)
        opt_state = session.tx.init(params)

        loader = SceneLoader(ScenesDataSet([bad], return_all=True), batch_size=1, prefetch=0)
        params2, opt_state2, n_updates, mean_loss, _, n_batches = epoch_train(
            conf, session, loader, params, opt_state, 0, 0, Phases.TRAINING,
            tb_writer=None,
        )
        assert n_batches == 1
        # Params untouched, but every LR-schedule count stepped once.
        for a, b in zip(jax.tree_util.tree_leaves(params),
                        jax.tree_util.tree_leaves(params2)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        counts = [
            int(s.count)
            for s in jax.tree_util.tree_leaves(
                opt_state2, is_leaf=lambda x: isinstance(x, optax.ScaleByScheduleState)
            )
            if isinstance(s, optax.ScaleByScheduleState)
        ]
        assert counts and all(c == 1 for c in counts)


class TestProfilerWindow:
    def test_null_profile_n_epochs(self, tmp_path, monkeypatch):
        """ref.conf ships `observability.profile_n_epochs = null` (the
        repo's "unset" idiom); get_int returns that stored None in
        preference to the default, which used to TypeError inside
        maybe_stop (`start + None`) mid-run. Null must behave as the
        1-epoch default."""
        from gasfm.config import ConfigFactory
        from gasfm.utils.observability import ProfilerWindow

        monkeypatch.setenv("GASFM_RESULTS_PATH", str(tmp_path))
        conf = ConfigFactory.parse_string(
            'exp_dir = "profile_null_test"\n'
            "observability { profile_start_epoch = 2, profile_n_epochs = null }"
        )
        w = ProfilerWindow(conf)
        assert w.n_epochs == 1
        # Exercise maybe_stop's window-end comparison (the old crash site)
        # without starting a real trace: epoch 0 is before the window end,
        # so close() is not reached.
        w._active = True
        try:
            w.maybe_stop(0)
        finally:
            w._active = False

    def test_profile_window_writes_trace(self, tmp_path, monkeypatch):
        """observability.profile_start_epoch captures a jax.profiler trace of
        the configured epoch window into <tb_events>/profile (SURVEY section 5:
        beyond the reference's wall-clock-only timing)."""
        monkeypatch.setenv("GASFM_RESULTS_PATH", str(tmp_path))
        import gasfm.utils.observability as obs

        obs.reset_tb_writer()
        import glob
        import os

        from gasfm.config import load_config
        from gasfm.data.dataset import SceneLoader, ScenesDataSet
        from gasfm.data.loaders import create_scene_data
        from gasfm.models import get_model
        from gasfm.train.loop import train
        from gasfm.utils import paths
        from gasfm.utils.phases import Phases

        conf = load_config(os.path.join("synth", "optim_synth_dpesfm.conf"))
        conf.put("exp_dir", "profile_test")
        conf.put("train.n_epochs", 3)
        conf.put("eval.eval_interval", 100)
        conf.put("eval.eval_init", False)
        conf.put("train.print_interval", None)
        conf.put("observability.profile_start_epoch", 1)
        conf.put("observability.profile_n_epochs", 1)

        data = create_scene_data(conf)
        loader = SceneLoader(ScenesDataSet([data], return_all=True), batch_size=1, prefetch=0)
        model = get_model(conf)
        params = model.init(jax.random.PRNGKey(0), data.to_scene_graph().graph)
        train(conf, loader, model, params, Phases.OPTIMIZATION)

        logdir = os.path.join(paths.path_to_tb_events(conf), "profile")
        xplanes = glob.glob(os.path.join(logdir, "plugins", "profile", "*", "*.xplane.pb"))
        assert xplanes, f"no xplane trace under {logdir}"
        obs.reset_tb_writer()


class TestAdamNuDtype:
    """_scale_by_adam_cast: optax.adam parity in f32, bounded drift in bf16."""

    def _conf(self, extra=""):
        return ConfigFactory.parse_string(
            'train { lr = 0.001, lr_schedule { lr_warmup_n_steps = 0, '
            'main_scheduler = "constant" } %s }' % extra
        )

    def test_f32_clone_bit_matches_optax_adam(self):
        import optax

        from gasfm.train.state import _scale_by_adam_cast, build_optimizer

        params = {"a": jnp.arange(12.0).reshape(3, 4) / 7.0, "b": jnp.ones((5,))}
        g = {"a": jnp.cos(params["a"]), "b": -0.3 * jnp.ones((5,))}
        ref = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
        mine = _scale_by_adam_cast(0.9, 0.999, 1e-8)
        s_r, s_m = ref.init(params), mine.init(params)
        for _ in range(5):
            u_r, s_r = ref.update(g, s_r, params)
            u_m, s_m = mine.update(g, s_m, params)
            for k in u_r:
                np.testing.assert_array_equal(np.asarray(u_r[k]), np.asarray(u_m[k]))

        # Conf-built chain applies the descent sign.
        tx, _ = build_optimizer(self._conf(', adam_nu_dtype = "bf16"'))
        st = tx.init(params)
        u, st = tx.update(g, st, params)
        assert float(u["a"][0, 0]) < 0  # positive gradient -> negative update
        assert st[0].nu["a"].dtype == jnp.bfloat16

    def test_bf16_nu_tracks_f32(self):
        from gasfm.train.state import _scale_by_adam_cast

        params = {"a": jnp.arange(12.0).reshape(3, 4) / 7.0}
        g = {"a": jnp.cos(params["a"])}
        f32 = _scale_by_adam_cast(0.9, 0.999, 1e-8)
        bf = _scale_by_adam_cast(0.9, 0.999, 1e-8, nu_dtype=jnp.bfloat16)
        s_f, s_b = f32.init(params), bf.init(params)
        for _ in range(20):
            u_f, s_f = f32.update(g, s_f, params)
            u_b, s_b = bf.update(g, s_b, params)
        rel = np.abs(np.asarray(u_b["a"]) - np.asarray(u_f["a"])) / (
            np.abs(np.asarray(u_f["a"])) + 1e-8
        )
        assert rel.max() < 0.02


class TestMixedPrecisionParams:
    """train.param_dtype=bf16: bf16 model params, f32 master in opt state."""

    def _conf(self):
        return ConfigFactory.parse_string(
            'train { lr = 0.01, lr_schedule { lr_warmup_n_steps = 0, '
            'main_scheduler = "constant" }, param_dtype = "bf16" }'
        )

    def test_params_land_on_bf16_master(self):
        import optax

        from gasfm.train.state import (
            apply_param_updates,
            build_optimizer,
            cast_params_for_training,
        )

        conf = self._conf()
        p0 = {"a": jnp.arange(12.0).reshape(3, 4) / 7.0 + 0.5}
        g = {"a": jnp.cos(p0["a"])}
        tx, _ = build_optimizer(conf)
        pb = cast_params_for_training(conf, p0)
        assert pb["a"].dtype == jnp.bfloat16
        st = tx.init(pb)
        assert st.master["a"].dtype == jnp.float32
        for _ in range(10):
            u, st = tx.update(g, st, pb)
            pb = apply_param_updates(pb, u, st)
        np.testing.assert_array_equal(
            np.asarray(pb["a"]), np.asarray(st.master["a"].astype(jnp.bfloat16))
        )

        # And the master tracks a plain f32 Adam on the same gradients.
        conf32 = ConfigFactory.parse_string(
            'train { lr = 0.01, lr_schedule { lr_warmup_n_steps = 0, '
            'main_scheduler = "constant" } }'
        )
        tx32, _ = build_optimizer(conf32)
        p32, st32 = dict(p0), tx32.init(p0)
        for _ in range(10):
            u32, st32 = tx32.update(g, st32, p32)
            p32 = optax.apply_updates(p32, u32)
        rel = np.abs(np.asarray(st.master["a"]) - np.asarray(p32["a"])).max()
        rel /= np.abs(np.asarray(p32["a"])).max()
        assert rel < 0.01

    def test_full_model_step_runs_bf16(self):
        from gasfm.data.synthetic import generate_synthetic_scene
        from gasfm.losses import get_loss_func
        from gasfm.models import get_model
        from gasfm.train.state import (
            apply_param_updates,
            build_optimizer,
            cast_params_for_training,
        )
        from __graft_entry__ import _flagship_conf

        conf = _flagship_conf(small=True)
        conf.put("train.param_dtype", "bf16")
        model = get_model(conf)
        loss_func = get_loss_func(conf)
        data = generate_synthetic_scene(n_views=8, n_points=64, seed=0)
        scene = data.to_scene_graph()
        params = model.init(jax.random.PRNGKey(0), scene.graph)
        params = cast_params_for_training(conf, params)
        tx, _ = build_optimizer(conf)
        st = tx.init(params)

        @jax.jit
        def step(p, s):
            def loss_fn(q):
                return loss_func(model.apply(q, scene.graph), scene)

            loss, g = jax.value_and_grad(loss_fn)(p)
            u, s = tx.update(g, s, p)
            return apply_param_updates(p, u, s), s, loss

        l0 = None
        for _ in range(3):
            params, st, loss = step(params, st)
            assert np.isfinite(float(loss))
            l0 = float(loss) if l0 is None else l0
        assert all(
            x.dtype == jnp.bfloat16 for x in jax.tree_util.tree_leaves(params)
        )
