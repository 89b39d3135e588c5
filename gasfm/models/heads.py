"""Output heads decode: camera matrices, 3D points, depths.

Parity: reference ``BaseNet`` (code/models/baseNet.py:8-92) — rotation
representations quat/6d/svd for calibrated cameras, the three projective
normalization modes, and homogeneous point padding.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

from gasfm.geometry.rotations import (
    project_to_rot,
    quaternion_to_matrix,
    rotation_6d_to_matrix,
)


def view_head_out_channels(calibrated: bool, rot_representation: str) -> int:
    """Parity: reference baseNet.py:17-28."""
    if calibrated and rot_representation == "6d":
        return 9
    if calibrated and rot_representation == "quat":
        return 7
    if calibrated and rot_representation == "svd":
        return 12
    if not calibrated:
        return 12
    raise ValueError(f"Illegal output format: calibrated={calibrated}, rot={rot_representation}")


def decode_view_outputs(
    x: jnp.ndarray,  # (M, out_channels)
    calibrated: bool,
    rot_representation: str = "quat",
    normalize_output: Optional[str] = None,
    cam_mask: Optional[jnp.ndarray] = None,
) -> jnp.ndarray:
    """(M, C) head outputs -> (M, 3, 4) normalized camera matrices.

    Padded rows (cam_mask False) are replaced by identity cameras to keep the
    decode NaN-free; consumers mask them. Parity: baseNet.py:38-85.
    """
    if calibrated:
        if cam_mask is not None:
            # Guard against zero padding rows — the replacement must be
            # NaN-free through BOTH the forward and the backward of the
            # rotation decode, per representation:
            # - quat: unit quaternion e0 (identity rotation).
            # - 6d: (e0, e1) — a zero a2 would hit b2 = 0/||0|| = NaN in
            #   rotation_6d_to_matrix (no epsilon, pytorch3d parity).
            # - svd: diag(1,2,3) — identity-like forward, and DISTINCT
            #   singular values: repeated ones (rank-1 zeros, or identity's
            #   1,1,1) make the SVD gradient's 1/(s_i^2 - s_j^2) terms NaN,
            #   which survives the loss's 0-mask (0 * NaN = NaN).
            if rot_representation == "6d":
                safe_rows = [0, 4]
            elif rot_representation == "svd":
                safe_rows = [(0, 1.0), (4, 2.0), (8, 3.0)]
            else:
                safe_rows = [0]
            safe = jnp.zeros_like(x)
            for entry in safe_rows:
                col, val = entry if isinstance(entry, tuple) else (entry, 1.0)
                safe = safe.at[:, col].set(val)
            x = jnp.where(cam_mask[:, None], x, safe)
        if rot_representation == "6d":
            RTs = rotation_6d_to_matrix(x[:, :6])
        elif rot_representation == "svd":
            RTs = project_to_rot(x[:, :9].reshape(-1, 3, 3))
        elif rot_representation == "quat":
            RTs = quaternion_to_matrix(x[:, :4])
        else:
            raise ValueError(f"Illegal rot representation {rot_representation!r}")
        minRTts = x[:, -3:]
        Ps = jnp.concatenate([RTs, minRTts[:, :, None]], axis=-1)
    else:
        Ps = x.reshape(-1, 3, 4)
        if normalize_output == "Chirality":
            det = jnp.linalg.det(Ps[:, 0:3, 0:3])
            row3 = jnp.linalg.norm(Ps[:, 2, 0:3], axis=1)
            scale = jnp.sign(det) / jnp.maximum(row3, 1e-12)
            Ps = Ps * scale[:, None, None]
        elif normalize_output == "Differentiable Chirality":
            det = jnp.linalg.det(Ps[:, 0:3, 0:3])
            row3 = jnp.linalg.norm(Ps[:, 2, 0:3], axis=1)
            # NOTE: reference multiplies the determinant by 10e3 == 1e4
            # before the softsign (baseNet.py:78); kept verbatim.
            soft = (det * 10e3) / (1.0 + jnp.abs(det * 10e3))
            scale = soft / jnp.maximum(row3, 1e-12)
            Ps = Ps * scale[:, None, None]
        elif normalize_output == "Frobenius":
            fro = jnp.linalg.norm(Ps.reshape(Ps.shape[0], -1), axis=1)
            Ps = Ps / jnp.maximum(fro, 1e-12)[:, None, None]
        if cam_mask is not None:
            eye = jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)
            Ps = jnp.where(cam_mask[:, None, None], Ps, eye[None])
    return Ps


def decode_scenepoint_outputs(pts_3d: jnp.ndarray) -> jnp.ndarray:
    """(3, N) -> (4, N) homogeneous (ones padding). Parity: baseNet.py:87-92."""
    return jnp.concatenate([pts_3d, jnp.ones((1, pts_3d.shape[1]), pts_3d.dtype)], axis=0)
