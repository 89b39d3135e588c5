"""Rotational homography data augmentation (host side).

Parity: reference SceneData.apply_rotational_homography_aug
(SceneData.py:358-453): random per-view in-plane + tilt rotations composed as
H = N^-1 R N applied to both GT cameras and image points (pixel ->
calibrated -> rotate -> pixel with pflat), zero-reset of invalid entries,
and depth rescale by the third-coordinate ratio.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

from gasfm.data.scene import SceneData
from gasfm.geometry.rotations import axis_angle_to_matrix_np


def apply_rotational_homography_aug(
    data: SceneData,
    inplane_rot_aug_max_angle: Optional[float] = None,
    tilt_rot_aug_max_angle: Optional[float] = None,
    rng: Optional[np.random.Generator] = None,
) -> SceneData:
    if inplane_rot_aug_max_angle is None and tilt_rot_aug_max_angle is None:
        return data
    if rng is None:
        rng = np.random.default_rng()

    num_views = data.y.shape[0]
    num_pts = data.M.shape[1]
    depths = data.depths

    R_aug = np.tile(np.eye(3), (num_views, 1, 1))

    inplane = inplane_rot_aug_max_angle or 0.0
    assert inplane >= 0
    if inplane > 0:
        angle = inplane * (2 * rng.random(num_views) - 1)
        vec = np.zeros((num_views, 3))
        vec[:, 2] = angle / 180.0 * math.pi
        R_aug = axis_angle_to_matrix_np(vec) @ R_aug

    tilt = tilt_rot_aug_max_angle or 0.0
    assert tilt >= 0
    if tilt > 0:
        angle = tilt * (2 * rng.random(num_views) - 1)
        alpha = rng.random(num_views) * 2 * math.pi
        axis = np.zeros((num_views, 3))
        axis[:, 0] = np.cos(alpha)
        axis[:, 1] = np.sin(alpha)
        R_aug = axis_angle_to_matrix_np(axis * angle[:, None] / 180.0 * math.pi) @ R_aug

    Ns = data.Ns.astype(np.float64)
    Ns_inv = np.linalg.inv(Ns)
    H_aug = Ns_inv @ R_aug @ Ns
    y = (H_aug @ data.y.astype(np.float64)).astype(np.float32)

    pts_old_unnorm = np.concatenate(
        [data.M.astype(np.float64).reshape(num_views, 2, num_pts), np.ones((num_views, 1, num_pts))],
        axis=1,
    )  # (m, 3, n)
    pts_old_norm = Ns @ pts_old_unnorm
    pts_new_norm = R_aug @ pts_old_norm
    pts_new_unnorm = Ns_inv @ pts_new_norm
    img_pts = (pts_new_unnorm / pts_new_unnorm[:, 2:3, :])[:, :2, :]  # (m, 2, n)
    img_pts = img_pts.transpose(0, 2, 1)  # (m, n, 2)
    img_pts[~data.valid_pts, :] = 0
    M = img_pts.transpose(0, 2, 1).reshape(2 * num_views, num_pts).astype(np.float32)

    if data.store_depth_targets:
        depths = (data.depths.astype(np.float64) / pts_old_norm[:, 2, :] * pts_new_norm[:, 2, :]).astype(
            np.float32
        )

    return SceneData(
        M,
        data.Ns,
        y,
        data.scene_name,
        calibrated=data.calibrated,
        store_depth_targets=data.store_depth_targets,
        depths=depths,
    )
