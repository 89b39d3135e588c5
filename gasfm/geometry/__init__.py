"""Geometry library: rotations (JAX + NumPy), host projective geometry,
vectorized DLT triangulation, similarity alignment.

Parity surface: reference code/utils/geo_utils.py (833 LoC)."""

from gasfm.geometry import alignment, np_geo, rotations, triangulation
from gasfm.geometry.alignment import align_cameras, translation_rotation_errors
from gasfm.geometry.np_geo import (
    M_to_xs,
    batch_pflat,
    get_M_valid_points,
    get_positive_projected_pts_mask,
    get_projected_pts_mask,
    normalize_M,
    pflat,
    reprojection_error_with_points,
    xs_to_M,
    xs_valid_points,
)
from gasfm.geometry.triangulation import dlt_triangulation, n_view_triangulation

__all__ = [
    "M_to_xs",
    "align_cameras",
    "alignment",
    "batch_pflat",
    "dlt_triangulation",
    "get_M_valid_points",
    "get_positive_projected_pts_mask",
    "get_projected_pts_mask",
    "n_view_triangulation",
    "normalize_M",
    "np_geo",
    "pflat",
    "reprojection_error_with_points",
    "rotations",
    "translation_rotation_errors",
    "triangulation",
    "xs_to_M",
    "xs_valid_points",
]
