"""Loss functions over the padded edge graph.

Parity: reference code/loss_functions.py (205 LoC). The primary ESFM loss is
computed in *edge form*: the reference projects all points into all cameras
as a dense (m, 3, n) tensor and masks by ``valid_pts``
(loss_functions.py:85-123); since the edge set of :class:`ViewGraph` is
exactly the set of valid (view, point) observations, gathering cameras and
points per edge yields the identical loss at O(E) instead of O(m*n) (gathers
plus elementwise math, no dense (m, 3, n) intermediate).

The reference's per-point gradient-direction equalization backward hook
(loss_functions.py:100-110) becomes a ``jax.custom_vjp`` on the pre-divide
projected coordinates.
"""

from __future__ import annotations

from typing import Any, Dict

import jax
import jax.numpy as jnp

from gasfm.graph.view_graph import SceneGraph, ViewGraph
from gasfm.ops.segment import all_sum, all_sum_final, gather_segments


def safe_norm(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """L2 norm whose gradient at 0 is 0 (torch's subgradient convention —
    jnp.linalg.norm yields NaN there, which would poison masked padding
    edges and exactly-zero residuals)."""
    sq = jnp.sum(x * x, axis=axis)
    nz = sq > 0
    return jnp.where(nz, jnp.sqrt(jnp.where(nz, sq, 1.0)), 0.0)


# ---------------------------------------------------------------------------
# Edge projection
# ---------------------------------------------------------------------------


def project_edges(Ps: jnp.ndarray, pts3D: jnp.ndarray, graph: ViewGraph) -> jnp.ndarray:
    """Per-edge homogeneous projections: (E, 3) = P[cam_e] @ X[:, pt_e].

    Gathers run on flat 2D tables; padded edges project garbage that every
    consumer masks by edge validity.
    """
    M = graph.num_cams
    P_flat = Ps.reshape(M, 12)
    P_e = gather_segments(P_flat, graph.cam_idx, M).reshape(-1, 3, 4)  # (E, 3, 4)
    X_e = gather_segments(pts3D.T, graph.pt_idx, graph.num_pts)  # (E, 4)
    return jnp.einsum("eij,ej->ei", P_e, X_e)


# ---------------------------------------------------------------------------
# Gradient-direction equalization (custom VJP — reference backward hook)
# ---------------------------------------------------------------------------


@jax.custom_vjp
def _equalize_grads_valid_only(proj, pos_maskf, inv_count):
    return proj


def _eq_valid_fwd(proj, pos_maskf, inv_count):
    return proj, (pos_maskf, inv_count)


def _eq_valid_bwd(res, g):
    pos_maskf, inv_count = res
    # F.normalize(grad, dim=1): x / max(||x||_2, 1e-12)
    norm = jnp.linalg.norm(g, axis=1, keepdims=True)
    normalized = g / jnp.maximum(norm, 1e-12) * inv_count
    g_new = jnp.where(pos_maskf[:, None] > 0, normalized, g)
    return g_new, jnp.zeros_like(pos_maskf), jnp.zeros_like(inv_count)


_equalize_grads_valid_only.defvjp(_eq_valid_fwd, _eq_valid_bwd)


@jax.custom_vjp
def _equalize_grads_all(proj, inv_count):
    return proj


def _eq_all_fwd(proj, inv_count):
    return proj, (inv_count,)


def _eq_all_bwd(res, g):
    (inv_count,) = res
    norm = jnp.linalg.norm(g, axis=1, keepdims=True)
    g_new = g / jnp.maximum(norm, 1e-12) * inv_count
    return g_new, jnp.zeros_like(inv_count)


_equalize_grads_all.defvjp(_eq_all_fwd, _eq_all_bwd)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


class ESFMLoss:
    """Unsupervised hinge-robustified reprojection loss.

    Parity: reference ``ESFMLoss`` (loss_functions.py:69-123), minus the
    CUDA-only assert (the CPU runs it too).
    """

    def __init__(self, conf):
        assert conf.get_bool("model.view_head.enabled", default=False)
        assert conf.get_bool("model.scenepoint_head.enabled", default=False)
        self.infinity_pts_margin = conf.get_float("loss.infinity_pts_margin")
        self.pts_grad_equalization = conf.get_bool(
            "loss.pts_grad_equalization_pre_perspective_divide"
        )
        self.normalize_grad_valid_only = (
            conf.get_bool("loss.normalize_grad_wrt_valid_projections_only")
            if self.pts_grad_equalization
            else False
        )
        self.hinge_loss = conf.get_bool("loss.hinge_loss")
        self.hinge_loss_weight = (
            conf.get_float("loss.hinge_loss_weight") if self.hinge_loss else 0.0
        )

    def __call__(self, pred: Dict[str, Any], scene: SceneGraph, epoch=None) -> jnp.ndarray:
        graph = scene.graph
        proj = project_edges(pred["Ps_norm"], pred["pts3D"], graph)  # (E, 3)
        depth = proj[:, 2]
        if self.hinge_loss:
            pos_mask = depth >= self.infinity_pts_margin
        else:
            pos_mask = jnp.abs(depth) >= self.infinity_pts_margin

        if self.pts_grad_equalization:
            if self.normalize_grad_valid_only:
                # Divide by #(valid & positive) projections, at least 1
                # (reference loss_functions.py:105).
                count = all_sum_final(
                    jnp.sum((graph.edge_mask & pos_mask).astype(jnp.float32))
                )
                inv_count = 1.0 / jnp.maximum(count, 1.0)
                proj = _equalize_grads_valid_only(
                    proj, pos_mask.astype(jnp.float32), inv_count
                )
            else:
                # Original behavior: normalize everywhere, divide by #valid
                # (reference loss_functions.py:110).
                inv_count = 1.0 / jnp.maximum(
                    all_sum_final(jnp.sum(graph.edge_mask.astype(jnp.float32))), 1.0
                )
                proj = _equalize_grads_all(proj, inv_count)
            depth = proj[:, 2]

        hinge = (self.infinity_pts_margin - depth) * self.hinge_loss_weight
        denom = jnp.where(pos_mask, depth, 1.0)
        pts2d = proj[:, :2] / denom[:, None]
        reproj = safe_norm(pts2d - graph.uv, axis=1)
        per_edge = jnp.where(pos_mask, reproj, hinge)
        mask = graph.edge_mask.astype(per_edge.dtype)
        # Final reductions: the loss cotangent is the replicated seed.
        return all_sum_final(jnp.sum(per_edge * mask)) / jnp.maximum(
            all_sum_final(jnp.sum(mask)), 1.0
        )


class ExpDepthRegularizedOSELoss:
    """Object-space error + exponential depth push.

    Parity: reference loss_functions.py:126-150.
    """

    def __init__(self, conf):
        assert conf.get_bool("model.view_head.enabled", default=False)
        assert conf.get_bool("model.scenepoint_head.enabled", default=False)
        self.depth_regul_weight = conf.get_float("loss.depth_regul_weight")

    def __call__(self, pred: Dict[str, Any], scene: SceneGraph, epoch=None) -> jnp.ndarray:
        graph = scene.graph
        proj = project_edges(pred["Ps_norm"], pred["pts3D"], graph)
        depth = proj[:, 2]
        depth_reg = self.depth_regul_weight * jnp.exp(-depth)
        ose = safe_norm(proj[:, :2] - depth[:, None] * graph.uv, axis=1)
        per_edge = ose + depth_reg
        mask = graph.edge_mask.astype(per_edge.dtype)
        return all_sum_final(jnp.sum(per_edge * mask)) / jnp.maximum(
            all_sum_final(jnp.sum(mask)), 1.0
        )


class GTLoss:
    """Supervised oracle pose loss (debugging).

    Parity: reference loss_functions.py:153-204. NOTE: the reference's
    calibrated branch calls a non-existent ``geo_utils.rot_to_quat`` and
    indexes a non-existent ``pred_dict['Ps']`` — i.e. it is broken dead code
    upstream. This implementation follows the evident intent: quaternion L2
    on rotations plus normalized-camera-center L2, with predictions taken
    from ``Ps_norm``.
    """

    def __init__(self, conf):
        assert conf.get_bool("model.view_head.enabled", default=False)
        assert conf.get_bool("model.scenepoint_head.enabled", default=False)
        self.calibrated = conf.get_bool("dataset.calibrated")

    def __call__(self, pred: Dict[str, Any], scene: SceneGraph, epoch=None) -> jnp.ndarray:
        from gasfm.geometry.rotations import matrix_to_quaternion

        graph = scene.graph
        mask = graph.cam_mask
        y = jnp.where(
            mask[:, None, None],
            scene.Ps_gt,
            jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)[None],
        )
        Ns_invT = jnp.transpose(scene.Ns_inv, (0, 2, 1))

        V_gt = jnp.transpose(jnp.linalg.inv(y[:, 0:3, 0:3]), (0, 2, 1))
        t_gt = -jnp.einsum("mij,mj->mi", jnp.linalg.inv(y[:, 0:3, 0:3]), y[:, 0:3, 3])

        fmask = mask.astype(jnp.float32)
        n_valid = jnp.maximum(jnp.sum(fmask), 1.0)
        trans = jnp.sum(t_gt * fmask[:, None], axis=0) / n_valid
        scale = jnp.sum(jnp.linalg.norm(t_gt - trans, axis=1) * fmask) / n_valid
        t_gt = (t_gt - trans) / jnp.maximum(scale, 1e-12)

        Ps_pred = pred["Ps_norm"]
        Vs_invT = Ps_pred[:, 0:3, 0:3]
        Vs = jnp.transpose(jnp.linalg.inv(Vs_invT), (0, 2, 1))
        ts = -jnp.einsum("mij,mj->mi", jnp.transpose(Vs, (0, 2, 1)), Ps_pred[:, 0:3, 3])

        translation_err = jnp.linalg.norm(t_gt - ts, axis=1)

        if self.calibrated:
            Rs_gt = matrix_to_quaternion(jnp.transpose(jnp.matmul(Ns_invT, V_gt), (0, 2, 1)))
            Rs = matrix_to_quaternion(jnp.transpose(jnp.matmul(Ns_invT, Vs), (0, 2, 1)))
            orient_err = jnp.linalg.norm(Rs - Rs_gt, axis=1)
        else:
            Vg = V_gt / jnp.maximum(
                jnp.linalg.norm(V_gt.reshape(V_gt.shape[0], -1), axis=1), 1e-12
            )[:, None, None]
            Vp = Vs / jnp.maximum(
                jnp.linalg.norm(Vs.reshape(Vs.shape[0], -1), axis=1), 1e-12
            )[:, None, None]
            d1 = jnp.linalg.norm((Vp - Vg).reshape(Vp.shape[0], -1), axis=1)
            d2 = jnp.linalg.norm((Vp + Vg).reshape(Vp.shape[0], -1), axis=1)
            orient_err = jnp.minimum(d1, d2)

        orient_loss = jnp.sum(orient_err * fmask) / n_valid
        tran_loss = jnp.sum(translation_err * fmask) / n_valid
        return orient_loss + tran_loss


class DirectDepthLoss:
    """L1/L2 on scale-normalized predicted vs GT per-edge depths.

    Parity: reference loss_functions.py:24-66.
    """

    def __init__(self, conf):
        assert conf.get_bool("model.depth_head.enabled")
        self.cost_fcn = conf.get_string("loss.cost_fcn")
        assert self.cost_fcn in ("L1", "L2")
        if not conf.get_bool("dataset.calibrated"):
            raise NotImplementedError("Uncalibrated direct depth loss not implemented (parity).")

    def __call__(self, pred: Dict[str, Any], scene: SceneGraph, epoch=None) -> jnp.ndarray:
        graph = scene.graph
        assert scene.gt_depths is not None, "SceneGraph.gt_depths required for DirectDepthLoss"
        mask = graph.edge_mask.astype(jnp.float32)
        n = jnp.maximum(all_sum_final(jnp.sum(mask)), 1.0)
        d_pred = pred["depths"]
        d_gt = scene.gt_depths
        # s_pred is INTERIOR: it is consumed back by every edge's divide, so
        # its (partial) cotangent must be psummed by the transpose.
        s_pred = all_sum(jnp.sum(d_pred * mask)) / n
        s_gt = all_sum_final(jnp.sum(d_gt * mask)) / n
        d_pred = d_pred / s_pred
        d_gt = d_gt / jnp.where(s_gt == 0, 1.0, s_gt)
        if self.cost_fcn == "L1":
            per_edge = jnp.abs(d_pred - d_gt)
        else:
            per_edge = (d_pred - d_gt) ** 2
        return all_sum_final(jnp.sum(per_edge * mask)) / n


_LOSS_REGISTRY = {
    "ESFMLoss": ESFMLoss,
    "ExpDepthRegularizedOSELoss": ExpDepthRegularizedOSELoss,
    "GTLoss": GTLoss,
    "DirectDepthLoss": DirectDepthLoss,
}


def get_loss_func(conf):
    """Parity: reference loss_functions.py:8-21 (including the head asserts)."""
    spec = conf.get_string("loss.func")
    if spec in ("ESFMLoss", "ExpDepthRegularizedOSELoss", "GTLoss"):
        assert conf.get_bool("model.view_head.enabled")
        assert conf.get_bool("model.scenepoint_head.enabled")
        assert not conf.get_bool("model.depth_head.enabled"), (
            "model.depth_head.enabled must be False when no loss is applied to that output."
        )
    elif spec == "DirectDepthLoss":
        assert conf.get_bool("model.depth_head.enabled")
        assert not conf.get_bool("model.view_head.enabled")
        assert not conf.get_bool("model.scenepoint_head.enabled")
    else:
        raise AssertionError(f"Unknown loss function: {spec}.")
    return _LOSS_REGISTRY[spec](conf)
