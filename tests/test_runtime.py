"""Runtime plumbing: the compile-cache helper, chip_smoke.py's CLI contract,
the core-only import set of the main path, TensorBoard event files, result
tables and npz train-state checkpoints."""

import json
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(tmp_path, **extra):
    env = dict(os.environ)
    env.update(JAX_PLATFORMS="cpu", JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"),
               PYTHONPATH=REPO, **extra)
    return env


# -- compile cache -------------------------------------------------------------


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_to_checkout(monkeypatch, restore_cache_dir):
    from gasfm.utils.compile_cache import configure_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = configure_compile_cache()
    assert path == os.path.join(REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_compile_cache_env_wins_and_nothing_is_set(monkeypatch, tmp_path, restore_cache_dir):
    from gasfm.utils.compile_cache import configure_compile_cache

    jax.config.update("jax_compilation_cache_dir", "/untouched")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "/untouched"


# -- chip_smoke.py -------------------------------------------------------------


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_the_cpu(tmp_path, where):
    """No GPU: a non-zero exit and no result line, whether or not the rest
    of the repository is beside the script."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if where == "alone":
        cwd = str(tmp_path / "lone")
        os.makedirs(cwd)
        script = shutil.copy(script, cwd)
    env = _env(tmp_path)
    if where == "alone":
        env.pop("PYTHONPATH")
    out = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_phase_selection():
    import chip_smoke

    assert chip_smoke.phases_for(multi=True) == ["multi"]
    one = chip_smoke.phases_for(multi=False)
    assert one == ["optim", "learning", "reference"] and "multi" not in one


def test_chip_smoke_result_line_format():
    import types

    import chip_smoke

    devs = [types.SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")] * 4
    line = chip_smoke.result_line(devs)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 4}}')
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}}
    assert "\n" not in line


def test_chip_smoke_multi_phase_on_cpu_mesh():
    """The four-device phase at a tiny width on four virtual CPU devices:
    layout checks on the compiled step, and the [1, 4] and [2, 2] steps
    against the one-device step."""
    import chip_smoke

    tiny = {"model.n_heads": 2, "model.n_feat_proj": 16, "model.n_feat_scenepoint": 16,
            "model.n_feat_view": 32, "model.n_feat_global": 32,
            "model.view_head.n_hidden_layers": 1, "model.scenepoint_head.n_hidden_layers": 1,
            "train.lr": 1e-3}
    chip_smoke.phase_multi(flagship=tiny, scene={"n_views": 16, "n_points": 512,
                                                 "visibility": 0.5}, layers=2)


def test_behind_share_counts_valid_projections_below_the_margin():
    import types

    import chip_smoke

    Ps = np.zeros((2, 3, 4))
    Ps[:, 2, 3] = [1.0, -1.0]  # depth = +1 in camera 0, -1 in camera 1
    pred = {"Ps_norm": Ps, "pts3D": np.ones((4, 3))}
    graph = types.SimpleNamespace(cam_idx=np.array([0, 1, 1, 0]), pt_idx=np.array([0, 1, 2, 2]),
                                  edge_mask=np.array([True, True, False, True]))
    assert chip_smoke.behind_share(pred, graph, margin=1e-4) == pytest.approx(1 / 3)
    assert chip_smoke.behind_share(pred, graph, margin=2.0) == 1.0


# -- the main path imports only the installed core -------------------------------


def test_main_path_trains_without_optional_packages(tmp_path):
    code = textwrap.dedent("""
        import sys
        BLOCKED = ("flax", "pandas", "orbax", "torch")
        for name in BLOCKED:
            sys.modules[name] = None  # any import of it now raises ImportError
        from gasfm.main import main
        rc = main(["single-scene-optim", "--conf", "synth/optim_synth_gasfm.conf",
                   "--exp-dir", "core_only", "--external-params",
                   "train.n_epochs=3", "eval.eval_interval=3", "eval.eval_init=false",
                   "ba.run_ba=false", "train.print_interval=null"])
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in BLOCKED and sys.modules[m] is not None)
        print("RESULT", rc, leaked)
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_env(tmp_path, GASFM_RESULTS_PATH=str(tmp_path)),
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "RESULT 0 []" in out.stdout
    csv_path = os.path.join(tmp_path, "core_only", "final_train_errors_OPTIMIZATION.csv")
    assert os.path.exists(csv_path)


# -- TensorBoard event files ---------------------------------------------------


def test_event_writer_round_trip(tmp_path):
    from gasfm.utils.events import EventWriter, crc32c, read_scalars

    assert crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value
    w = EventWriter(str(tmp_path))
    w.add_scalar("TRAINING-all-scenes/batch/loss", 0.25, global_step=3)
    w.add_scalar("x/epoch/our_repro", np.float32(-1.5), global_step=0)
    w.add_scalar("neg", 2, global_step=-1)
    w.close()
    assert read_scalars(w.path) == [
        ("TRAINING-all-scenes/batch/loss", 3, 0.25), ("x/epoch/our_repro", 0, -1.5),
        ("neg", -1, 2.0)]


def test_event_file_reads_as_tensorflow_events(tmp_path):
    event_pb2 = pytest.importorskip("tensorboard.compat.proto.event_pb2")
    import struct

    from gasfm.utils.events import EventWriter

    w = EventWriter(str(tmp_path))
    w.add_scalar("a/b", 1.25, global_step=7)
    w.close()
    with open(w.path, "rb") as f:
        buf = f.read()
    events, i = [], 0
    while i < len(buf):
        (n,) = struct.unpack("<Q", buf[i:i + 8])
        events.append(event_pb2.Event.FromString(buf[i + 12:i + 12 + n]))
        i += 16 + n
    assert events[0].file_version == "brain.Event:2"
    assert events[1].step == 7
    assert [(v.tag, v.simple_value) for v in events[1].summary.value] == [("a/b", 1.25)]


# -- result tables -------------------------------------------------------------


def test_eval_table_mean_row_and_lookup():
    from gasfm.train.loop import aggregate_val_metric, eval_errors_table

    rows = eval_errors_table([
        {"Scene": "a", "repro": 1.0, "note": "x", "n": 2},
        {"Scene": "b", "repro": float("nan"), "n": 4, "extra": 7.0},
    ])
    assert [r["Scene"] for r in rows] == ["a", "b", "Mean"]
    mean = rows[-1]
    assert mean["repro"] == 1.0 and mean["n"] == 3.0 and mean["extra"] == 7.0
    assert "note" not in mean
    assert aggregate_val_metric(rows, "repro") == 1.0
    assert aggregate_val_metric(rows, "n", scene="b") == 4
    with pytest.raises(KeyError):
        aggregate_val_metric(rows, "missing")
    with pytest.raises(KeyError):
        aggregate_val_metric(rows, "repro", scene="c")


def test_write_results_appends_and_merges_columns(tmp_path, monkeypatch):
    import csv

    from gasfm.config import ConfigFactory
    from gasfm.utils.observability import write_results

    monkeypatch.setenv("GASFM_RESULTS_PATH", str(tmp_path))
    conf = ConfigFactory.parse_string('exp_dir = "t"')
    write_results(conf, [{"Scene": "s1", "v": 1.23456}], file_name="R", append=True)
    path = write_results(conf, [{"Scene": "s2", "w": 2.0, "v": float("nan")}],
                         file_name="R", append=True)
    with open(path, newline="") as f:
        back = list(csv.reader(f))
    assert back == [["Scene", "v", "w"], ["s1", "1.235", "NULL"], ["s2", "NULL", "2.0"]]


# -- train-state checkpoints -----------------------------------------------------


def _state(step, dtype=jnp.float32):
    from gasfm.train.state import TrainState

    k = jax.random.PRNGKey(step)
    params = {"w": jax.random.normal(k, (3, 4)).astype(dtype), "b": jnp.arange(4.0, dtype=dtype)}
    opt = (jnp.zeros((3, 4), jnp.float32), {"count": jnp.asarray(step, jnp.int32)})
    return TrainState(params=params, opt_state=opt, step=jnp.asarray([step, 2 * step], jnp.int32))


def test_checkpoint_keeps_newest_steps(tmp_path):
    from gasfm.train.state import restore_checkpoint, save_checkpoint

    for step in range(1, 6):
        save_checkpoint(str(tmp_path), _state(step), step=step, keep=3)
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "5"]
    latest = restore_checkpoint(str(tmp_path), _state(0))
    assert list(np.asarray(latest.step)) == [5, 10]
    older = restore_checkpoint(str(tmp_path), _state(0), step=4)
    np.testing.assert_array_equal(np.asarray(older.params["w"]), np.asarray(_state(4).params["w"]))


def test_checkpoint_round_trips_bfloat16_exactly(tmp_path):
    from gasfm.train.state import restore_checkpoint, save_checkpoint

    state = _state(7, dtype=jnp.bfloat16)
    save_checkpoint(str(tmp_path), state, step=7)
    back = restore_checkpoint(str(tmp_path), _state(0, dtype=jnp.bfloat16))
    assert back.params["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back.params["w"], np.float32),
                                  np.asarray(state.params["w"], np.float32))
    with pytest.raises(ValueError, match="shape"):
        from gasfm.train.state import TrainState

        bad = TrainState(params={"w": jnp.zeros((2, 2)), "b": jnp.zeros(4)},
                         opt_state=state.opt_state, step=state.step)
        restore_checkpoint(str(tmp_path), bad)


# -- trace reduction (scripts/trace_step.py) -----------------------------------


def test_trace_summary_merges_overlaps_and_splits_kinds():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "trace_step", os.path.join(REPO, "scripts", "trace_step.py"))
    trace_step = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace_step)

    events = [("input_scatter_fusion", 0.0, 10.0), ("loop_add_fusion", 5.0, 10.0),
              ("cutlass_gemm", 30.0, 5.0), ("gather.3", 50.0, 5.0)]
    out = trace_step.summarize(events, window_us=100.0)
    assert out["busy_ms"] == pytest.approx(0.025)  # [0, 15] + [30, 35] + [50, 55]
    assert out["idle_share"] == pytest.approx(0.75)
    assert out["share"] == pytest.approx(
        {"scatter": 10 / 30, "other": 10 / 30, "matmul": 5 / 30, "gather": 5 / 30})
