"""Loss tests: GT-oracle check (port of the reference's executable self-test,
SceneData.py:509-526), edge-form vs dense-form equivalence, and the
grad-equalization custom VJP."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gasfm.config import ConfigFactory
from gasfm.data.synthetic import generate_synthetic_scene
from gasfm.geometry.triangulation import n_view_triangulation
from gasfm.losses import ESFMLoss, ExpDepthRegularizedOSELoss, get_loss_func, project_edges

LOSS_CONF = """
dataset { calibrated = true }
model {
  view_head { enabled = true }
  scenepoint_head { enabled = true }
  depth_head { enabled = false }
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


def make_scene(seed=0, **kw):
    data = generate_synthetic_scene(n_views=7, n_points=50, seed=seed, **kw)
    return data, data.to_scene_graph()


def gt_pred_dict(data, scene):
    """GT-pose prediction dict: normalized GT cameras + triangulated points
    (parity: reference prepare_cameras_for_loss_func, SceneData.py:521-526)."""
    Ps_norm = np.einsum("mij,mjk->mik", data.Ns.astype(np.float64), data.y.astype(np.float64))
    X = n_view_triangulation(data.y.astype(np.float64), data.M.astype(np.float64), data.Ns.astype(np.float64))
    m_cap = scene.graph.num_cams
    n_cap = scene.graph.num_pts
    Ps_pad = np.tile(np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1), (m_cap, 1, 1))
    Ps_pad[: data.num_views] = Ps_norm
    X_pad = np.zeros((4, n_cap))
    X_pad[3] = 1.0
    X_pad[:, : data.num_points] = np.nan_to_num(X)
    return {
        "Ps_norm": jnp.asarray(Ps_pad, dtype=jnp.float32),
        "pts3D": jnp.asarray(X_pad, dtype=jnp.float32),
    }


def random_pred_dict(scene, seed=0):
    rng = np.random.default_rng(seed)
    m_cap, n_cap = scene.graph.num_cams, scene.graph.num_pts
    return {
        "Ps_norm": jnp.asarray(rng.normal(size=(m_cap, 3, 4)), dtype=jnp.float32),
        "pts3D": jnp.asarray(
            np.concatenate([rng.normal(size=(3, n_cap)), np.ones((1, n_cap))], axis=0),
            dtype=jnp.float32,
        ),
    }


class TestESFMOracle:
    def test_gt_far_better_than_random(self):
        conf = ConfigFactory.parse_string(LOSS_CONF)
        loss_fn = get_loss_func(conf)
        data, scene = make_scene()
        loss_gt = float(loss_fn(gt_pred_dict(data, scene), scene))
        loss_rand = float(loss_fn(random_pred_dict(scene), scene))
        assert np.isfinite(loss_gt) and np.isfinite(loss_rand)
        assert loss_gt < 1e-3  # noise-free synthetic: ~zero reprojection
        assert loss_rand > 10 * max(loss_gt, 1e-6)

    def test_edge_form_matches_dense_reference_formula(self):
        """The O(E) edge-form ESFM loss must equal the reference's dense
        (m,3,n) formulation masked by valid_pts."""
        conf = ConfigFactory.parse_string(LOSS_CONF)
        loss_fn = ESFMLoss(conf)
        data, scene = make_scene(seed=1, noise_px=1.0)
        pred = random_pred_dict(scene, seed=2)
        edge_loss = float(loss_fn(pred, scene))

        # Dense reference computation (NumPy):
        margin = conf.get_float("loss.infinity_pts_margin")
        w = conf.get_float("loss.hinge_loss_weight")
        m, n = data.num_views, data.num_points
        Ps = np.asarray(pred["Ps_norm"])[:m].astype(np.float64)
        X = np.asarray(pred["pts3D"])[:, :n].astype(np.float64)
        pts2d = Ps @ X  # (m, 3, n)
        pos = pts2d[:, 2, :] >= margin
        hinge = (margin - pts2d[:, 2, :]) * w
        denom = np.where(pos, pts2d[:, 2, :], 1.0)
        proj = pts2d / denom[:, None, :]
        norm_M_t = data.norm_M.transpose(0, 2, 1)  # (m, 2, n)
        reproj = np.linalg.norm(proj[:, 0:2, :] - norm_M_t, axis=1)
        dense_loss = np.where(pos, reproj, hinge)[data.valid_pts].mean()
        assert edge_loss == pytest.approx(dense_loss, rel=1e-4)

    def test_hinge_replaces_reprojection_behind_camera(self):
        conf = ConfigFactory.parse_string(LOSS_CONF)
        loss_fn = ESFMLoss(conf)
        data, scene = make_scene(seed=3)
        pred = gt_pred_dict(data, scene)
        # Flip all cameras: all depths negative -> pure hinge loss, positive
        pred_flipped = dict(pred)
        pred_flipped["Ps_norm"] = -pred["Ps_norm"]
        loss = float(loss_fn(pred_flipped, scene))
        assert loss > 0.0


class TestGradEqualization:
    def _grads(self, conf_overrides, seed=4):
        conf = ConfigFactory.parse_string(LOSS_CONF)
        for k, v in conf_overrides.items():
            conf.put(k, v)
        loss_fn = ESFMLoss(conf)
        data, scene = make_scene(seed=seed)
        pred = gt_pred_dict(data, scene)

        def f(Ps):
            return loss_fn({"Ps_norm": Ps, "pts3D": pred["pts3D"]}, scene)

        return np.asarray(jax.grad(f)(pred["Ps_norm"]))

    def test_grad_equalization_changes_grads_and_stays_finite(self):
        g_eq = self._grads({"loss.pts_grad_equalization_pre_perspective_divide": True})
        g_raw = self._grads({"loss.pts_grad_equalization_pre_perspective_divide": False})
        assert np.isfinite(g_eq).all() and np.isfinite(g_raw).all()
        assert not np.allclose(g_eq, g_raw)

    def test_both_normalization_variants_run(self):
        g1 = self._grads({"loss.normalize_grad_wrt_valid_projections_only": True})
        g2 = self._grads({"loss.normalize_grad_wrt_valid_projections_only": False})
        assert np.isfinite(g1).all() and np.isfinite(g2).all()

    def test_equalized_edge_grad_directions_are_unit(self):
        """After equalization, d loss/d proj_e must have equal magnitude
        (1/count) for every positively-projected edge — the defining effect
        of the reference's hook."""
        conf = ConfigFactory.parse_string(LOSS_CONF)
        loss_fn = ESFMLoss(conf)
        data, scene = make_scene(seed=5)
        pred = gt_pred_dict(data, scene)

        # Differentiate w.r.t. the per-edge projections by intercepting
        # project_edges output: rebuild loss manually.
        graph = scene.graph
        proj0 = project_edges(pred["Ps_norm"], pred["pts3D"], graph)

        def f(proj):
            from gasfm.losses import _equalize_grads_valid_only

            margin = loss_fn.infinity_pts_margin
            pos = proj[:, 2] >= margin
            count = jnp.sum((graph.edge_mask & pos).astype(jnp.float32))
            proj = _equalize_grads_valid_only(proj, pos.astype(jnp.float32), 1.0 / jnp.maximum(count, 1.0))
            depth = proj[:, 2]
            hinge = (margin - depth) * loss_fn.hinge_loss_weight
            denom = jnp.where(pos, depth, 1.0)
            pts2d = proj[:, :2] / denom[:, None]
            reproj = jnp.linalg.norm(pts2d - graph.uv, axis=1)
            per_edge = jnp.where(pos, reproj, hinge)
            mask = graph.edge_mask.astype(per_edge.dtype)
            return jnp.sum(per_edge * mask) / jnp.maximum(jnp.sum(mask), 1.0)

        g = np.asarray(jax.grad(f)(proj0))
        emask = np.asarray(graph.edge_mask)
        pos = np.asarray(proj0[:, 2] >= loss_fn.infinity_pts_margin) & emask
        mags = np.linalg.norm(g[pos], axis=1)
        count = pos.sum()
        nonzero = mags > 1e-12
        np.testing.assert_allclose(mags[nonzero], 1.0 / count, rtol=1e-4)


class TestOtherLosses:
    def test_ose_loss_oracle(self):
        conf = ConfigFactory.parse_string(LOSS_CONF)
        conf.put("loss.func", "ExpDepthRegularizedOSELoss")
        conf.put("loss.depth_regul_weight", 0.01)
        loss_fn = get_loss_func(conf)
        data, scene = make_scene(seed=6)
        loss_gt = float(loss_fn(gt_pred_dict(data, scene), scene))
        loss_rand = float(loss_fn(random_pred_dict(scene, seed=7), scene))
        assert loss_gt < loss_rand

    def test_gt_loss_zero_at_gt(self):
        conf = ConfigFactory.parse_string(LOSS_CONF)
        conf.put("loss.func", "GTLoss")
        loss_fn = get_loss_func(conf)
        data, scene = make_scene(seed=8)
        pred = gt_pred_dict(data, scene)
        loss_at_gt = float(loss_fn(pred, scene))
        loss_rand = float(loss_fn(random_pred_dict(scene, seed=9), scene))
        # NOTE: even at GT the loss is nonzero because the reference
        # normalizes GT camera centers but not predicted ones
        # (loss_functions.py:174-185) — the rotation term is what vanishes.
        assert np.isfinite(loss_at_gt)
        assert loss_at_gt < loss_rand

    def test_direct_depth_loss(self):
        conf = ConfigFactory.parse_string(LOSS_CONF)
        conf.put("loss.func", "DirectDepthLoss")
        conf.put("loss.cost_fcn", "L1")
        conf.put("model.depth_head.enabled", True)
        conf.put("model.view_head.enabled", False)
        conf.put("model.scenepoint_head.enabled", False)
        loss_fn = get_loss_func(conf)
        data = generate_synthetic_scene(n_views=7, n_points=50, seed=10, store_depth_targets=True)
        scene = data.to_scene_graph()
        # Perfect prediction: loss 0
        pred = {"depths": scene.gt_depths}
        assert float(loss_fn(pred, scene)) == pytest.approx(0.0, abs=1e-6)
        # Scale invariance: depths are normalized by their mean first
        pred2 = {"depths": scene.gt_depths * 3.7}
        assert float(loss_fn(pred2, scene)) == pytest.approx(0.0, abs=1e-5)
