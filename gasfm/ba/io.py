"""Legacy `.mat` readers for external bundle-adjustment comparisons.

Parity surface: reference code/utils/ba_io.py:1-56 — readers for
MATLAB-exported scenes (`M` measurement matrices, GT rotations/translations/
intrinsics, predicted cameras/points) used when comparing against external BA
pipelines. Shapes follow the reference conventions:

- ``xs``: (m, n, 2) per-view 2D observations unpacked from the stacked
  ``M (2m, n)`` matrix.
- ``Xs``: (n, 3) 3D points.
"""

from __future__ import annotations

import os

import numpy as np


def _load_mat(path: str):
    import scipy.io as sio

    return sio.loadmat(path, squeeze_me=True)


def _m_to_xs(M: np.ndarray) -> np.ndarray:
    """(2m, n) stacked measurement matrix -> (m, n, 2) observations
    (delegates to the one implementation, geometry/np_geo.M_to_xs)."""
    from gasfm.geometry.np_geo import M_to_xs

    return M_to_xs(np.asarray(M, dtype=np.float64))


def read_mat_files(path: str):
    raw = _load_mat(path + ".mat")
    return {
        "Ps": np.stack(raw["Ps"]),
        "Xs": raw["Points3D"].T,
        "xs": _m_to_xs(raw["M"]),
    }


def read_euc_gt_mat_files(path: str):
    raw = _load_mat(path + ".mat")
    M = raw["M"]
    if not isinstance(M, (np.ndarray, np.generic)):
        M = np.asarray(M.todense())  # sparse MATLAB storage
    return {
        "Rs": np.stack(raw["R_gt"]),
        "ts": np.stack(raw["T_gt"]),
        "Ks": np.stack(raw["K_gt"]),
        "xs": _m_to_xs(M),
    }


def read_proj_gt_mat_files(path: str):
    raw = _load_mat(path + ".mat")
    return {"xs": _m_to_xs(np.asarray(raw["M"]))}


def read_euc_our_mat_files(path: str, name: str = "Final_Cameras"):
    raw = _load_mat(os.path.join(path, "cameras", name) + ".mat")
    return {
        "Xs": raw["pts3D"][:3].T.astype(np.double),
        "Rs": raw["Rs"],
        "ts": raw["ts"],
        "Ks": raw["Ks"],
    }


def read_proj_our_mat_files(path: str, name: str = "Final_Cameras"):
    raw = _load_mat(os.path.join(path, "cameras", name) + ".mat")
    return {
        "Xs": raw["pts3D"][:3].T.astype(np.double),
        "Ps": raw["Ps"],
    }
