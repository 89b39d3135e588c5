"""Per-graph edge-chunk selection: the chunk is a static property of each
ViewGraph, picked automatically by the production bucketizer from the
scene's mean window run (view_graph.choose_chunk), and graphs with
different chunks coexist in one process — one compiled program per
(caps, chunk) key. The dense bench scene (mean window run ~1800) gets 2048,
the power-law scene (~370) 512.
"""

from __future__ import annotations

import numpy as np
import pytest

from gasfm.config import ConfigFactory
from gasfm.data.synthetic import generate_synthetic_scene
from gasfm.graph.view_graph import WINDOW, choose_chunk


def _bucketizer(n_edge_shards=1, **conf_puts):
    from gasfm.train.loop import GraphBucketizer

    conf = ConfigFactory.parse_string("dataset { calibrated = true }")
    for k, v in conf_puts.items():
        conf.put(k, v)
    return GraphBucketizer(conf, n_edge_shards=n_edge_shards)


class TestChooseChunk:
    def test_rule_anchors(self, monkeypatch):
        monkeypatch.delenv("GASFM_CHUNK", raising=False)
        # Dense bench scene: 115,605 valid edges / 8,192 points -> mean
        # window run ~1806 -> 2048.
        assert choose_chunk(115605, 8192) == 2048
        # Mid-density: run ~1250 -> 1024.
        assert choose_chunk(80000, 8192) == 1024
        # Power-law scene: 70,465 / 24,576 -> run ~367 -> 512.
        assert choose_chunk(70465, 24576) == 512
        # Very sparse / tiny scenes -> 256.
        assert choose_chunk(100, 1024) == 256
        # Boundaries: run == threshold picks the larger chunk.
        assert choose_chunk(1792, WINDOW) == 2048  # run == 1792
        assert choose_chunk(1024, WINDOW) == 1024  # run == 1024
        assert choose_chunk(256, WINDOW) == 512  # run == 256

    def test_env_override_wins(self, monkeypatch):
        monkeypatch.setenv("GASFM_CHUNK", "512")
        import gasfm.graph.view_graph as vg

        # choose_chunk defers to the env-pinned process default.
        assert choose_chunk(115605, 8192) == vg.CHUNK


class TestBucketizerChunk:
    def test_per_scene_chunks(self, monkeypatch):
        monkeypatch.delenv("GASFM_CHUNK", raising=False)
        b = _bucketizer()
        dense = generate_synthetic_scene(n_views=48, n_points=512,
                                         visibility=0.5, seed=0)
        sparse = generate_synthetic_scene(n_views=133, n_points=4096,
                                          track_length_dist="powerlaw", seed=0)
        sg_d = b(dense)
        sg_s = b(sparse)
        assert sg_d.graph.chunk == 2048  # run = 48*0.5*128 ~ 3072
        assert sg_s.graph.chunk == 512
        # Layout invariants hold per chunk.
        for sg in (sg_d, sg_s):
            g = sg.graph
            assert g.num_edges % g.chunk == 0
            wb = np.asarray(g.pt_window).reshape(-1, g.chunk)
            assert (wb == wb[:, :1]).all(), "chunk spans one point window"

    def test_pinned_chunk_conf(self, monkeypatch):
        monkeypatch.delenv("GASFM_CHUNK", raising=False)
        b = _bucketizer(**{"compile.chunk": 512})
        dense = generate_synthetic_scene(n_views=48, n_points=512,
                                         visibility=0.5, seed=0)
        assert b(dense).graph.chunk == 512

    def test_env_override_beats_conf_pin(self, monkeypatch):
        """GASFM_CHUNK is the documented sweep escape hatch: it must win
        even when the conf pins compile.chunk, or a sweep against a pinned
        conf silently measures one configuration repeatedly."""
        monkeypatch.setenv("GASFM_CHUNK", "1024")
        b = _bucketizer(**{"compile.chunk": 512})
        dense = generate_synthetic_scene(n_views=48, n_points=512,
                                         visibility=0.5, seed=0)
        assert b.chunk_for(dense) == 1024

    def test_off_grid_chunk_rejected(self):
        """chunk > 1024 must be a 1024-multiple (the grid of the chunk
        rule), and every chunk a multiple of 128."""
        data = generate_synthetic_scene(n_views=10, n_points=256, seed=0)
        with pytest.raises(ValueError, match="1024"):
            data.to_scene_graph(chunk=1536)
        with pytest.raises(ValueError, match="128"):
            data.to_scene_graph(chunk=100)

    def test_sharded_edge_multiple_follows_chunk(self, monkeypatch):
        monkeypatch.delenv("GASFM_CHUNK", raising=False)
        b = _bucketizer(n_edge_shards=2)
        dense = generate_synthetic_scene(n_views=48, n_points=512,
                                         visibility=0.5, seed=0)
        g = b(dense).graph
        assert g.num_edges % (2 * g.chunk) == 0


class TestMixedChunkEpoch:
    def test_two_auto_chunks_through_production_epoch_train(self, tmp_path, monkeypatch):
        """Two scenes whose automatic chunks DIFFER run through one
        production epoch_train (one TrainingSession, one fused-step jit
        cache keyed on the static graph.chunk) — the loop-level guarantee
        behind per-scene chunk selection."""
        import os

        import jax

        monkeypatch.delenv("GASFM_CHUNK", raising=False)
        monkeypatch.setenv("GASFM_RESULTS_PATH", str(tmp_path))
        from gasfm.config import load_config
        from gasfm.data.dataset import SceneLoader, ScenesDataSet
        from gasfm.models import get_model
        from gasfm.train.loop import TrainingSession, epoch_train
        from gasfm.utils.phases import Phases

        conf = load_config(os.path.join("synth", "learning_synth_gasfm.conf"))
        conf.put("exp_dir", "mixed_chunk_test")
        dense = generate_synthetic_scene(n_views=16, n_points=256,
                                         visibility=0.9, seed=0)  # chunk 1024
        sparse = generate_synthetic_scene(n_views=40, n_points=1024,
                                          track_length_dist="powerlaw", seed=1)
        model = get_model(conf)
        session = TrainingSession(conf, model)
        assert session.bucketize.chunk_for(dense) != session.bucketize.chunk_for(sparse)

        loader = SceneLoader(
            ScenesDataSet([dense, sparse], return_all=True),
            batch_size=1, shuffle=False, prefetch=0,
        )
        graph = session.bucketize(dense).graph
        params = model.init(jax.random.PRNGKey(0), graph)
        opt_state = session.tx.init(params)
        params, opt_state, n_updates, mean_loss, losses, n_batches = epoch_train(
            conf, session, loader, params, opt_state, 0, 0, Phases.TRAINING,
            tb_writer=None,
        )
        assert n_batches == 2 and n_updates == 2
        assert np.isfinite(mean_loss) and len(losses) == 2


class TestChunkCoexistence:
    @pytest.mark.parametrize("chunks", [(512, 1024), (512, 2048)])
    def test_two_chunks_one_process(self, chunks, monkeypatch):
        """The same scene built at two different chunks produces exactly the
        same model output in ONE process."""
        import jax

        from gasfm.models import get_model

        monkeypatch.delenv("GASFM_CHUNK", raising=False)
        c_a, c_b = chunks
        conf = ConfigFactory.parse_string("""
dataset { calibrated = true }
model {
  type = "graph_attn_sfm.GraphAttnSfMNet"
  n_heads = 2, stateful_global_features = true
  global2view_and_global2scenepoint_enabled = false
  n_feat_proj = 32, n_feat_scenepoint = 16, n_feat_view = 32
  n_feat_global = 64, num_layers = 3
  n_hidden_layers_scenepoint_update = 0, n_hidden_layers_view_update = 0
  n_hidden_layers_global_update = 0, n_hidden_layers_proj_update = 0
  use_norm_proj_update = true, add_residual_skipconn_proj_update = true
  add_skipconn_from_init_projfeat = true, pos_emb_n_freq = 0
  depth_head { enabled = false }
  view_head { enabled = true, n_hidden_layers = 2, rot_representation = "quat" }
  scenepoint_head { enabled = true, n_hidden_layers = 2 }
}
""")
        model = get_model(conf)
        data = generate_synthetic_scene(n_views=10, n_points=256, seed=0)
        outs = {}
        for chunk in chunks:
            sg = data.to_scene_graph(chunk=chunk)
            params = model.init(jax.random.PRNGKey(0), sg.graph)
            pred = jax.jit(model.apply)(params, sg.graph)
            outs[chunk] = np.asarray(pred["Ps_norm"])
        np.testing.assert_array_equal(outs[c_a], outs[c_b])
