"""Reference-checkpoint parity runbook (scripts/reference_parity.py):
round-trip a torch-SERIALIZED checkpoint file from disk — the reference's
``torch.save(model.state_dict(), path)`` format (code/train.py:656) — through
the runbook's load + convert + validate path, and run the one-command
evaluation battery it produces. Exercises exactly what a user would run the
moment real reference weights exist."""

import sys
from pathlib import Path

import numpy as np
import torch

import jax

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

import torch_oracle as oracle
from gasfm.config import ConfigFactory


def _conf(tmp_path):
    from gasfm.config import load_config

    conf = load_config("gasfm/confs/synth/optim_synth_gasfm.conf")
    for key, val in dict(
        n_heads=2, n_feat_proj=12, n_feat_scenepoint=16, n_feat_view=24,
        n_feat_global=32, num_layers=3,
        n_hidden_layers_scenepoint_update=1, n_hidden_layers_view_update=1,
        n_hidden_layers_global_update=1, n_hidden_layers_proj_update=1,
    ).items():
        conf.put(f"model.{key}", val)
    conf.put("model.view_head.n_hidden_layers", 1)
    conf.put("model.scenepoint_head.n_hidden_layers", 1)
    return conf


def test_checkpoint_file_roundtrip_and_battery(tmp_path, capsys):
    torch.manual_seed(0)
    torch.set_default_dtype(torch.float64)
    ref = oracle.GraphAttnSfMNet(
        num_layers=3, n_heads=2, n_feat_proj=12, n_feat_scenepoint=16,
        n_feat_view=24, n_feat_global=32, stateful_global_features=True,
        add_skipconn_from_init_projfeat=True, use_norm_proj_update=True,
        add_residual_skipconn_proj_update=True,
        n_hidden_layers_scenepoint_update=1, n_hidden_layers_view_update=1,
        n_hidden_layers_global_update=1, n_hidden_layers_proj_update=1,
        view_head_n_hidden_layers=1, scenepoint_head_n_hidden_layers=1,
    )
    ckpt = tmp_path / "model_epoch000042.pt"
    sd = {k: v.to(torch.float32) for k, v in ref.state_dict().items()}
    torch.save(sd, str(ckpt))

    import reference_parity as rp

    conf = _conf(tmp_path)
    model, params = rp.convert_checkpoint(conf, str(ckpt))

    # The from-disk conversion must agree exactly with the in-memory one.
    from gasfm.models.convert import convert_reference_state_dict

    direct = convert_reference_state_dict(sd, "graph_attn_sfm.GraphAttnSfMNet")
    for (pa, a), (pb, b) in zip(
        jax.tree_util.tree_flatten_with_path(params)[0],
        jax.tree_util.tree_flatten_with_path(direct)[0],
    ):
        assert jax.tree_util.keystr(pa) == jax.tree_util.keystr(pb)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # One-command battery over a synthetic scene: finite metrics out.
    table = _run_battery(rp, conf, ckpt)
    from gasfm.train.loop import aggregate_val_metric

    assert np.isfinite(aggregate_val_metric(table, "our_repro"))


def _run_battery(rp, conf, ckpt):
    from gasfm.data.dataset import SceneLoader, ScenesDataSet
    from gasfm.data.synthetic import generate_synthetic_scene
    from gasfm.train.loop import TrainingSession, epoch_evaluation
    from gasfm.utils.phases import Phases

    model, params = rp.convert_checkpoint(conf, str(ckpt))
    scenes = [generate_synthetic_scene(n_views=8, n_points=200, seed=0)]
    loader = SceneLoader(ScenesDataSet(scenes, return_all=True), batch_size=1,
                         prefetch=0)
    session = TrainingSession(conf, model)
    return epoch_evaluation(
        loader, session, params, conf, -1, Phases.OPTIMIZATION,
        bundle_adjustment=False, crash_on_scene_exhausting_memory=True,
    )
