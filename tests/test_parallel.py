"""Multi-chip sharding tests on the virtual 8-device CPU mesh: the
edge-partitioned step must be numerically identical to the single-device
step (forward, loss, gradients, parameter updates)."""

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gasfm.config import ConfigFactory
from gasfm.data.synthetic import generate_synthetic_scene
from gasfm.losses import get_loss_func
from gasfm.models import get_model
from gasfm.parallel import (
    make_mesh,
    make_sharded_forward,
    make_sharded_train_step,
    stack_scene_graphs,
)
from gasfm.train.state import build_optimizer

CONF = """
dataset { calibrated = true }
model {
  type = "graph_attn_sfm.GraphAttnSfMNet"
  n_heads = 2
  stateful_global_features = true
  global2view_and_global2scenepoint_enabled = false
  n_feat_proj = 16
  n_feat_scenepoint = 16
  n_feat_view = 32
  n_feat_global = 32
  num_layers = 2
  n_hidden_layers_scenepoint_update = 0
  n_hidden_layers_view_update = 0
  n_hidden_layers_global_update = 0
  n_hidden_layers_proj_update = 0
  use_norm_proj_update = true
  add_residual_skipconn_proj_update = true
  add_skipconn_from_init_projfeat = true
  pos_emb_n_freq = 0
  depth_head { enabled = false }
  view_head { enabled = true, n_hidden_layers = 1, rot_representation = "quat" }
  scenepoint_head { enabled = true, n_hidden_layers = 1 }
}
train {
  lr = 0.001
  lr_schedule { lr_warmup_n_steps = 0, main_scheduler = "constant" }
}
loss {
  func = "ESFMLoss"
  infinity_pts_margin = 0.0001
  pts_grad_equalization_pre_perspective_divide = true
  normalize_grad_wrt_valid_projections_only = true
  hinge_loss = true
  hinge_loss_weight = 1
}
"""


@contextlib.contextmanager
def float64(*trees):
    """Run a sharded-vs-single-device comparison in float64, yielding
    ``trees`` with their floating leaves cast to float64.

    In float32 the two differ by the reassociation of the psum's partial
    sums: ~1e-8 absolute on gradient entries near zero, which crosses the
    comparisons' absolute floors for some initial draws (and near zero depth
    1/depth magnifies it in the loss). In float64 that noise is ~1e-16
    relative, far below every tolerance, so the comparison decides on the
    sharding logic for any draw: a dropped or doubled cross-shard term is an
    O(1) error."""

    def cast(x):
        x = np.asarray(x)
        return x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) else x

    jax.config.update("jax_enable_x64", True)
    try:
        yield [jax.tree_util.tree_map(cast, t) for t in trees]
    finally:
        jax.config.update("jax_enable_x64", False)


def make_scenes(n, caps=None):
    scenes = []
    for seed in range(n):
        data = generate_synthetic_scene(n_views=6, n_points=48, seed=seed)
        scenes.append(data.to_scene_graph(caps=caps))
    return scenes


def assert_spans_shards(scene, n_edge):
    """Guard: the scene's VALID edges must land on more than one edge shard.

    The round-3 test scenes fit inside one CHUNK, so every valid edge sat on
    shard 0 and the sharded-gradient tests never exercised cross-shard
    gradient coupling — which is exactly where the round-3 identity-transpose
    scheme was wrong (93/162 corrupted leaves, see ops/segment.py). Keep the
    scenes big enough that this cannot silently regress."""
    em = np.asarray(scene.graph.edge_mask).reshape(n_edge, -1)
    per_shard = em.sum(axis=1)
    assert (per_shard > 0).sum() >= 2, (
        f"test scene does not span edge shards (valid edges per shard: "
        f"{per_shard}); enlarge the scene"
    )


def make_spanning_scenes(n, n_edge_shards, caps_chunks=4):
    """Scenes whose valid edges span multiple edge shards (2 point windows,
    each window's run longer than one chunk-aligned shard slice)."""
    from gasfm.graph.view_graph import CHUNK

    scenes = []
    for seed in range(n):
        data = generate_synthetic_scene(n_views=12, n_points=256, seed=3 + seed)
        scene = data.to_scene_graph(caps=(16, 256, caps_chunks * CHUNK))
        assert_spans_shards(scene, n_edge_shards)
        scenes.append(scene)
    return scenes


@pytest.fixture(scope="module")
def setup():
    from gasfm.graph.view_graph import CHUNK

    conf = ConfigFactory.parse_string(CONF)
    model = get_model(conf)
    # Chunk-aligned caps (the production GraphBucketizer contract: edge cap
    # a multiple of n_edge_shards * CHUNK) AND valid edges spanning several
    # shards — the regime where cross-shard gradient coupling is live.
    scenes = make_spanning_scenes(2, n_edge_shards=4, caps_chunks=4)
    params = model.init(jax.random.PRNGKey(0), scenes[0].graph)
    return conf, model, scenes, params


class TestShardedForward:
    def test_matches_single_device(self, setup):
        conf, model, scenes, params = setup
        mesh = make_mesh(n_edge=4, n_data=1)
        fwd = make_sharded_forward(conf, model, mesh)
        batched = stack_scene_graphs(scenes[:1])
        pred_sharded = fwd(params, batched)
        pred_single = model.apply(params, scenes[0].graph)
        np.testing.assert_allclose(
            np.asarray(pred_sharded["Ps_norm"]), np.asarray(pred_single["Ps_norm"]), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(pred_sharded["pts3D"]), np.asarray(pred_single["pts3D"]), atol=1e-5
        )


class TestShardedTrainStep:
    def test_matches_single_device_update(self, setup):
        conf, model, scenes, params = setup
        with float64(scenes, params) as (scenes, params):
            self._check_matches_single_device_update(conf, model, scenes, params)

    def _check_matches_single_device_update(self, conf, model, scenes, params):
        loss_func = get_loss_func(conf)

        # Single-device reference: batch-accumulated grads over both scenes.
        def loss_fn(p, scene):
            return loss_func(model.apply(p, scene.graph), scene)

        total_loss = 0.0
        grads_sum = None
        for scene in scenes:
            loss, grads = jax.value_and_grad(loss_fn)(params, scene)
            total_loss += loss
            grads_sum = grads if grads_sum is None else jax.tree_util.tree_map(
                jnp.add, grads_sum, grads
            )
        # Sharded gradients: data=2 x edge=4 mesh.
        from jax.sharding import PartitionSpec as P

        from gasfm.ops.segment import edge_partitioned
        from gasfm.parallel import DATA_AXIS, EDGE_AXIS, scene_graph_specs

        mesh = make_mesh(n_edge=4, n_data=2)

        def per_device(p, scene):
            scene = jax.tree_util.tree_map(lambda x: x[0], scene)
            with edge_partitioned(EDGE_AXIS):
                loss, grads = jax.value_and_grad(loss_fn)(p, scene)
            return (
                jax.lax.psum(loss, DATA_AXIS),
                jax.lax.psum(grads, (EDGE_AXIS, DATA_AXIS)),
            )

        grads_fn = jax.jit(
            jax.shard_map(
                per_device, mesh=mesh,
                in_specs=(P(), scene_graph_specs(batched=True)),
                out_specs=(P(), P()), check_vma=False,
            )
        )
        batched = stack_scene_graphs(scenes)
        loss_sharded, grads_sharded = grads_fn(params, batched)

        assert float(loss_sharded) == pytest.approx(float(total_loss), rel=1e-5)
        flat_ref = jax.tree_util.tree_leaves(grads_sum)
        flat_sh = jax.tree_util.tree_leaves(grads_sharded)
        assert len(flat_ref) == len(flat_sh)
        for a, b in zip(flat_ref, flat_sh):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype == np.float64
            scale = max(np.abs(a).max(), 1e-2)
            np.testing.assert_allclose(a, b, atol=2e-5 * scale, rtol=1e-3)

    def test_multiple_steps_stay_finite(self, setup):
        conf, model, scenes, params = setup
        tx, _ = build_optimizer(conf)
        mesh = make_mesh(n_edge=2, n_data=2)
        step = make_sharded_train_step(conf, model, mesh)
        batched = stack_scene_graphs(scenes)
        opt_state = tx.init(params)
        p = params
        losses = []
        for _ in range(5):
            p, opt_state, loss = step(p, opt_state, batched)
            losses.append(float(loss))
        assert all(np.isfinite(losses))
        assert losses[-1] < losses[0]  # optimizing


class TestProductionMeshTrainer:
    """The PRODUCTION trainer (TrainingSession / epoch_train) running on the
    mesh must be numerically identical to the single-device trainer — the
    multi-chip path is the same code the CLI runs, switched on by conf
    `parallel.mesh_shape` (VERDICT round 1, item 2)."""

    def _run_epochs(self, conf, scenes_data, n_epochs=2, batch_size=2):
        from gasfm.data.dataset import SceneLoader, ScenesDataSet
        from gasfm.train.loop import TrainingSession, epoch_train
        from gasfm.utils.phases import Phases

        model = get_model(conf)
        session = TrainingSession(conf, model)
        graph0 = session.bucketize(scenes_data[0]).graph
        params = model.init(jax.random.PRNGKey(0), graph0)
        opt_state = session.tx.init(params)
        ds = ScenesDataSet(scenes_data, return_all=True)
        n_updates = 0
        mean_loss = float("nan")
        for epoch in range(n_epochs):
            loader = SceneLoader(ds, batch_size=batch_size, shuffle=False)
            params, opt_state, n_updates, mean_loss, _, _ = epoch_train(
                conf, session, loader, params, opt_state, n_updates, epoch,
                Phases.TRAINING, tb_writer=None,
            )
        return session, params, mean_loss

    def test_epoch_train_matches_single_device(self):
        from gasfm.data.synthetic import generate_synthetic_scene

        scenes_data = [
            generate_synthetic_scene(n_views=6, n_points=48, seed=s, scene_name=f"synth{s}")
            for s in range(3)
        ]
        conf_single = ConfigFactory.parse_string(CONF)
        conf_mesh = ConfigFactory.parse_string(
            # table_sharding pinned off: these tests assert (near-)bit
            # exactness vs single device; the round-5 default (on for
            # n_edge > 1) reorders point-side sums — covered at
            # tolerance by TestTableSharding and the default-path check
            # in TestProductionMeshTrainer.
            CONF + "\nparallel { mesh_shape = [2, 4], table_sharding = false }\n"
        )

        # ONE epoch, ONE batch of 3 valid samples > n_data=2: exercises the
        # production accumulation path (per-sample sharded grads summed, one
        # update). A single update keeps the comparison tight — Adam on
        # near-zero gradients amplifies psum float-reassociation noise
        # chaotically over multiple updates (single-step exactness is also
        # covered by test_weight_padded_group_step).
        _, p_single, loss_single = self._run_epochs(
            conf_single, scenes_data, n_epochs=1, batch_size=3
        )
        session_mesh, p_mesh, loss_mesh = self._run_epochs(
            conf_mesh, scenes_data, n_epochs=1, batch_size=3
        )
        assert session_mesh.mesh is not None  # conf switched the mesh on

        assert loss_mesh == pytest.approx(loss_single, rel=1e-4)
        for a, b in zip(jax.tree_util.tree_leaves(p_single), jax.tree_util.tree_leaves(p_mesh)):
            a, b = np.asarray(a), np.asarray(b)
            np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-3)

        # DEFAULT mesh path (table_sharding on for n_edge > 1): the owned-row
        # point pool is exact math with different float association, so
        # compare LOSS and GRADIENTS at tolerance —
        # post-Adam params are not comparable on zero-gradient leaves
        # (Adam's first debiased update is ±lr whatever the gradient
        # magnitude, so noise-level sign flips move params by 2*lr).
        from gasfm.train.loop import TrainingSession

        conf_mesh_dflt = ConfigFactory.parse_string(
            CONF + "\nparallel { mesh_shape = [2, 4] }\n"
        )
        model = get_model(conf_mesh_dflt)
        session_dflt = TrainingSession(conf_mesh_dflt, model)
        assert conf_mesh_dflt.get_bool("parallel.table_sharding", default=None) is None
        session_rep = TrainingSession(conf_mesh, model)
        sg = session_dflt.bucketize(scenes_data[0])
        params0 = model.init(jax.random.PRNGKey(7), sg.graph)
        l_d, _, g_d = session_dflt.loss_and_grads(params0, sg)
        l_r, _, g_r = session_rep.loss_and_grads(params0, sg)
        assert float(l_d) == pytest.approx(float(l_r), rel=1e-5)
        for a, b in zip(jax.tree_util.tree_leaves(g_r), jax.tree_util.tree_leaves(g_d)):
            a, b = np.asarray(a), np.asarray(b)
            scale = max(float(np.abs(a).max()), 1e-3)
            np.testing.assert_allclose(a, b, atol=5e-4 * scale, rtol=2e-3)

        # The production eval forward on the mesh matches too.
        sg = session_mesh.bucketize(scenes_data[0])
        pred_mesh = session_mesh.forward(p_mesh, sg)
        conf2 = ConfigFactory.parse_string(CONF)
        model2 = get_model(conf2)
        pred_single = model2.apply(p_mesh, sg.graph)
        np.testing.assert_allclose(
            np.asarray(pred_mesh["Ps_norm"]), np.asarray(pred_single["Ps_norm"]), atol=1e-5
        )

    def test_weight_padded_group_step(self):
        """A short scene group (1 valid scene on a 2-slot data axis) must
        produce exactly the single-scene update (padded slot weight 0)."""
        from gasfm.data.synthetic import generate_synthetic_scene
        from gasfm.train.loop import TrainingSession

        # table_sharding pinned off: this is an EXACTNESS test (see the
        # pin note in test_epoch_train_matches_single_device).
        conf_mesh = ConfigFactory.parse_string(
            CONF + "\nparallel { mesh_shape = [2, 2], table_sharding = false }\n"
        )
        conf_single = ConfigFactory.parse_string(CONF)
        data = generate_synthetic_scene(n_views=6, n_points=48, seed=0)

        session_m = TrainingSession(conf_mesh, get_model(conf_mesh))
        sg_m = session_m.bucketize(data)
        params = get_model(conf_mesh).init(jax.random.PRNGKey(0), sg_m.graph)
        opt_m = session_m.tx.init(params)
        p_m, _, loss_m, repro_m, gn_m = session_m.fused_step(
            jax.tree_util.tree_map(jnp.array, params), opt_m, sg_m
        )

        session_s = TrainingSession(conf_single, get_model(conf_single))
        sg_s = session_s.bucketize(data)
        opt_s = session_s.tx.init(params)
        p_s, _, loss_s, repro_s, gn_s = session_s.fused_step(
            jax.tree_util.tree_map(jnp.array, params), opt_s, sg_s
        )

        assert float(loss_m) == pytest.approx(float(loss_s), rel=1e-5)
        assert float(repro_m) == pytest.approx(float(repro_s), rel=1e-4)
        assert float(gn_m) == pytest.approx(float(gn_s), rel=1e-3)
        for a, b in zip(jax.tree_util.tree_leaves(p_s), jax.tree_util.tree_leaves(p_m)):
            a, b = np.asarray(a), np.asarray(b)
            scale = max(np.abs(a).max(), 1e-3)
            np.testing.assert_allclose(a, b, atol=5e-5 * scale, rtol=2e-3)


class TestDistributedInit:
    """Conf gating of the multi-host runtime startup (jax.distributed
    bootstrap — SURVEY section 2.7's communication-backend row)."""

    def test_disabled_by_default_and_kwargs_plumbed(self, monkeypatch):
        from gasfm.config import ConfigFactory
        from gasfm.parallel.edge_sharding import initialize_distributed

        conf = ConfigFactory.parse_string("parallel { }")
        assert initialize_distributed(conf) is False

        calls = {}

        def fake_init(**kwargs):
            calls.update(kwargs)

        import jax as _jax

        monkeypatch.setattr(_jax.distributed, "initialize", fake_init)
        conf = ConfigFactory.parse_string("""
parallel { distributed {
  enabled = true
  coordinator_address = "10.0.0.1:1234"
  num_processes = 4
  process_id = 2
} }
""")
        assert initialize_distributed(conf) is True
        assert calls == {"coordinator_address": "10.0.0.1:1234",
                         "num_processes": 4, "process_id": 2}


class TestGroupedMeshEval:
    """epoch_evaluation on a (data, edge) mesh shards DIFFERENT scenes
    across the data axis (one per group) and must produce the same error
    table as the single-device evaluation."""

    def test_grouped_eval_matches_single_device(self):
        from gasfm.data.dataset import SceneLoader, ScenesDataSet
        from gasfm.data.synthetic import generate_synthetic_scene
        from gasfm.train.loop import TrainingSession, epoch_evaluation
        from gasfm.utils.phases import Phases

        scenes_data = [
            generate_synthetic_scene(n_views=6, n_points=48, seed=s, scene_name=f"synth{s}")
            for s in range(3)
        ]
        conf_single = ConfigFactory.parse_string(CONF)
        conf_mesh = ConfigFactory.parse_string(
            # table_sharding pinned off: these tests assert (near-)bit
            # exactness vs single device; the round-5 default (on for
            # n_edge > 1) reorders point-side sums — covered at
            # tolerance by TestTableSharding and the default-path check
            # in TestProductionMeshTrainer.
            CONF + "\nparallel { mesh_shape = [2, 4], table_sharding = false }\n"
        )

        model = get_model(conf_single)
        session_s = TrainingSession(conf_single, model)
        graph0 = session_s.bucketize(scenes_data[0]).graph
        params = model.init(jax.random.PRNGKey(3), graph0)

        def run(conf, session):
            loader = SceneLoader(ScenesDataSet(scenes_data, return_all=True),
                                 batch_size=2, prefetch=0)
            return epoch_evaluation(
                loader, session, params, conf, -1, Phases.OPTIMIZATION,
                bundle_adjustment=False, crash_on_scene_exhausting_memory=True,
            )

        df_single = run(conf_single, session_s)
        session_m = TrainingSession(conf_mesh, get_model(conf_mesh))
        assert session_m.mesh is not None and session_m.n_data == 2
        df_mesh = run(conf_mesh, session_m)

        assert [r["Scene"] for r in df_single] == [r["Scene"] for r in df_mesh]
        for col in ("our_repro", "t_err_mean", "R_err_mean"):
            np.testing.assert_allclose(
                [r[col] for r in df_mesh], [r[col] for r in df_single],
                rtol=2e-3, atol=1e-4, err_msg=col,
            )

    def test_grouped_eval_mixed_capacities(self):
        """Scenes of DIFFERENT sizes must group (bucket-padded to the
        group maximum — round-3 verdict item 7) instead of silently
        falling back to one scene replicated per call."""
        from gasfm.data.dataset import SceneLoader, ScenesDataSet
        from gasfm.data.synthetic import generate_synthetic_scene
        from gasfm.train.loop import TrainingSession, epoch_evaluation
        from gasfm.utils.phases import Phases

        # Three sizes -> three distinct capacity buckets.
        scenes_data = [
            generate_synthetic_scene(n_views=6, n_points=48, seed=0, scene_name="small"),
            generate_synthetic_scene(n_views=10, n_points=300, seed=1, scene_name="large"),
            generate_synthetic_scene(n_views=8, n_points=120, seed=2, scene_name="mid"),
        ]
        conf_single = ConfigFactory.parse_string(CONF)
        conf_mesh = ConfigFactory.parse_string(
            # table_sharding pinned off: these tests assert (near-)bit
            # exactness vs single device; the round-5 default (on for
            # n_edge > 1) reorders point-side sums — covered at
            # tolerance by TestTableSharding and the default-path check
            # in TestProductionMeshTrainer.
            CONF + "\nparallel { mesh_shape = [2, 4], table_sharding = false }\n"
        )

        model = get_model(conf_single)
        session_s = TrainingSession(conf_single, model)
        graph0 = session_s.bucketize(scenes_data[0]).graph
        params = model.init(jax.random.PRNGKey(3), graph0)
        caps = {session_s.bucketize(d).graph.num_edges for d in scenes_data}
        assert len(caps) >= 2, "scene sizes must land in different buckets"

        def run(conf, session):
            loader = SceneLoader(ScenesDataSet(scenes_data, return_all=True),
                                 batch_size=2, prefetch=0)
            return epoch_evaluation(
                loader, session, params, conf, -1, Phases.OPTIMIZATION,
                bundle_adjustment=False, crash_on_scene_exhausting_memory=True,
            )

        df_single = run(conf_single, session_s)
        session_m = TrainingSession(conf_mesh, get_model(conf_mesh))
        df_mesh = run(conf_mesh, session_m)

        assert [r["Scene"] for r in df_single] == [r["Scene"] for r in df_mesh]
        for col in ("our_repro", "t_err_mean", "R_err_mean"):
            np.testing.assert_allclose(
                [r[col] for r in df_mesh], [r[col] for r in df_single],
                rtol=2e-3, atol=1e-4, err_msg=col,
            )

    def test_grouped_eval_mixed_capacities_table_sharded(self):
        """Mixed-capacity grouped eval with the DEFAULT table-sharded point
        pool (on for n_edge > 1): the _flush re-pad rebuilds minority scenes
        at group caps / group-min chunk, which shifts shard boundaries and
        with them the owned rows; the sharded metrics must still track
        single-device evaluation."""
        from gasfm.data.dataset import SceneLoader, ScenesDataSet
        from gasfm.data.synthetic import generate_synthetic_scene
        from gasfm.train.loop import TrainingSession, epoch_evaluation
        from gasfm.utils.phases import Phases

        scenes_data = [
            generate_synthetic_scene(n_views=6, n_points=48, seed=0, scene_name="small"),
            generate_synthetic_scene(n_views=10, n_points=300, seed=1, scene_name="large"),
            generate_synthetic_scene(n_views=8, n_points=120, seed=2, scene_name="mid"),
        ]
        conf_single = ConfigFactory.parse_string(CONF)
        # table_sharding unset -> defaults ON at n_edge = 2.
        conf_mesh = ConfigFactory.parse_string(CONF + "\nparallel { mesh_shape = [2, 2] }\n")

        model = get_model(conf_single)
        session_s = TrainingSession(conf_single, model)
        graph0 = session_s.bucketize(scenes_data[0]).graph
        params = model.init(jax.random.PRNGKey(3), graph0)
        caps = {session_s.bucketize(d).graph.num_edges for d in scenes_data}
        assert len(caps) >= 2, "scene sizes must land in different buckets"

        def run(conf, session):
            loader = SceneLoader(ScenesDataSet(scenes_data, return_all=True),
                                 batch_size=2, prefetch=0)
            return epoch_evaluation(
                loader, session, params, conf, -1, Phases.OPTIMIZATION,
                bundle_adjustment=False, crash_on_scene_exhausting_memory=True,
            )

        df_single = run(conf_single, session_s)
        session_m = TrainingSession(conf_mesh, get_model(conf_mesh))
        df_mesh = run(conf_mesh, session_m)

        assert [r["Scene"] for r in df_single] == [r["Scene"] for r in df_mesh]
        # The owned-row pool reorders point-side sums, so this is a
        # tolerance check, not exactness (exactness: TestTableSharding).
        for col in ("our_repro", "t_err_mean", "R_err_mean"):
            np.testing.assert_allclose(
                [r[col] for r in df_mesh], [r[col] for r in df_single],
                rtol=5e-3, atol=1e-3, err_msg=col,
            )


class TestSubChunkShardGradients:
    """Edge shards SMALLER than one CHUNK (outside the bucketizer's shard
    contract): per-shard edge arrays are not chunk-aligned, and the
    gradients must STILL match single-device execution. An identity
    transpose of the cross-shard sums would keep only same-shard gradient
    paths and break here; the interior psum transpose (ops/segment.py)
    is exact for any sharding."""

    def test_64_edge_shards_match_single_device(self, setup):
        from jax.sharding import PartitionSpec as P

        from gasfm.graph.view_graph import CHUNK
        from gasfm.ops.segment import edge_partitioned
        from gasfm.parallel import EDGE_AXIS, make_mesh, scene_graph_specs

        conf, model, _, _ = setup
        loss_func = get_loss_func(conf)

        # Edge cap = 1 CHUNK split across 8 shards -> CHUNK/8 edges each.
        data = generate_synthetic_scene(n_views=6, n_points=48, seed=0)
        scene = data.to_scene_graph(caps=(8, 256, CHUNK))
        assert_spans_shards(scene, 8)
        params = model.init(jax.random.PRNGKey(0), scene.graph)

        def loss_fn(p, sc):
            return loss_func(model.apply(p, sc.graph), sc)

        mesh = make_mesh(n_edge=8, n_data=1)

        def per_device(p, sc):
            sc = jax.tree_util.tree_map(lambda x: x[0], sc)
            with edge_partitioned(EDGE_AXIS):
                loss, grads = jax.value_and_grad(loss_fn)(p, sc)
            return loss, jax.lax.psum(grads, EDGE_AXIS)

        sharded = jax.shard_map(
            per_device, mesh=mesh,
            in_specs=(P(), scene_graph_specs(batched=True)),
            out_specs=(P(), P()), check_vma=False,
        )
        with float64(params, scene) as (params, scene):
            l_ref, g_ref = jax.value_and_grad(loss_fn)(params, scene)
            l_sh, g_sh = jax.jit(sharded)(params, stack_scene_graphs([scene]))

        assert float(l_sh) == pytest.approx(float(l_ref), rel=1e-5)
        for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(g_ref),
            jax.tree_util.tree_leaves(g_sh),
        ):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype == np.float64
            scale = max(np.abs(a).max(), 1e-3)
            np.testing.assert_allclose(
                b, a, atol=2e-5 * scale, rtol=1e-3,
                err_msg=f"grad mismatch at {jax.tree_util.keystr(path)}",
            )


class TestTableSharding:
    """parallel.table_sharding: the point->global pool combines owned-row
    softmax triples across shards, and pts3D is assembled by ONE masked
    psum. Forward, loss and EVERY gradient leaf must match single-device
    execution."""

    def _conf_model_scene(self):
        from gasfm.graph.view_graph import CHUNK

        conf = ConfigFactory.parse_string(
            CONF + "\nparallel { mesh_shape = [1, 4], table_sharding = true }\n"
        )
        model = get_model(conf)
        data = generate_synthetic_scene(n_views=12, n_points=256, seed=3)
        scene = data.to_scene_graph(caps=(16, 256, 4 * CHUNK))
        assert_spans_shards(scene, 4)
        return conf, model, scene

    def test_sharded_grads_match_single_device(self):
        from jax.sharding import PartitionSpec as P

        from gasfm.ops.segment import edge_partitioned, table_sharded
        from gasfm.parallel import (
            EDGE_AXIS,
            compute_owned_points,
            make_mesh,
            scene_graph_specs,
        )

        conf, model, scene = self._conf_model_scene()
        loss_func = get_loss_func(conf)
        params = model.init(jax.random.PRNGKey(0), scene.graph)

        def loss_fn(p, sc):
            return loss_func(model.apply(p, sc.graph), sc)

        mesh = make_mesh(n_edge=4, n_data=1)

        def per_device(p, sc):
            sc = jax.tree_util.tree_map(lambda x: x[0], sc)
            with edge_partitioned(EDGE_AXIS), table_sharded(
                compute_owned_points(sc.graph, EDGE_AXIS)
            ):
                loss, grads = jax.value_and_grad(loss_fn)(p, sc)
            return loss, jax.lax.psum(grads, EDGE_AXIS)

        sharded = jax.shard_map(
            per_device, mesh=mesh,
            in_specs=(P(), scene_graph_specs(batched=True)),
            out_specs=(P(), P()), check_vma=False,
        )
        with float64(params, scene) as (params, scene):
            l_ref, g_ref = jax.value_and_grad(loss_fn)(params, scene)
            l_sh, g_sh = jax.jit(sharded)(params, stack_scene_graphs([scene]))

        assert float(l_sh) == pytest.approx(float(l_ref), rel=1e-5)
        for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(g_ref),
            jax.tree_util.tree_leaves(g_sh),
        ):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype == np.float64
            scale = max(np.abs(a).max(), 1e-2)
            np.testing.assert_allclose(
                b, a, atol=2e-5 * scale, rtol=1e-3,
                err_msg=f"grad mismatch at {jax.tree_util.keystr(path)}",
            )

    def test_production_forward_combines_tables(self):
        from gasfm.parallel import make_mesh, make_sharded_forward

        conf, model, scene = self._conf_model_scene()
        params = model.init(jax.random.PRNGKey(0), scene.graph)
        mesh = make_mesh(n_edge=4, n_data=1)
        fwd = make_sharded_forward(conf, model, mesh)
        pred_sh = fwd(params, stack_scene_graphs([scene]))
        pred_ref = model.apply(params, scene.graph)
        np.testing.assert_allclose(
            np.asarray(pred_sh["Ps_norm"]), np.asarray(pred_ref["Ps_norm"]), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(pred_sh["pts3D"]), np.asarray(pred_ref["pts3D"]), atol=1e-5
        )
