"""Scene loading from ``.npz`` archives (Euclidean / Projective) and the
scene-construction entry points.

Parity: reference code/datasets/Euclidean.py:11-44, Projective.py:10-40,
SceneData.py:267-303 (create_scene_data incl. the PantheonParis
zero-visibility filter) and dataset_utils.correct_matches_global
(dataset_utils.py:58-68) for ``use_gt``.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from gasfm.data.scene import SceneData
from gasfm.geometry.np_geo import M_to_xs, batch_pflat, get_M_valid_points
from gasfm.geometry.triangulation import n_view_triangulation

_DEFAULT_DATASETS_PATH = os.environ.get(
    "GASFM_DATASETS_PATH", os.path.join(os.path.dirname(__file__), "..", "..", "datasets")
)

# Scenes needing zero-visibility point pruning (reference SceneData.py:286-292).
_SCENES_NEEDING_POINT_FILTER = {"PantheonParis"}


def path_to_datasets(conf=None) -> str:
    if conf is not None:
        p = conf.get_string("dataset.datasets_path", default=None)
        if p:
            return p
    return _DEFAULT_DATASETS_PATH


def correct_matches_global(M: np.ndarray, Ps: np.ndarray, Ns: np.ndarray) -> np.ndarray:
    """Replace measured matches with reprojections of triangulated structure.

    Parity: reference dataset_utils.py:58-68.
    """
    M_invalid = ~get_M_valid_points(M)
    Xs = n_view_triangulation(Ps, M, Ns)
    xs = batch_pflat(Ps @ Xs)[:, 0:2, :]
    xs = np.nan_to_num(xs, nan=0.0, posinf=0.0, neginf=0.0)
    xs[np.stack((M_invalid, M_invalid), axis=1)] = 0
    return xs.reshape(M.shape)


def get_raw_data_euclidean(scene: str, use_gt: bool, datasets_path: Optional[str] = None):
    """Parity: reference Euclidean.get_raw_data (Euclidean.py:11-44)."""
    path = os.path.join(datasets_path or _DEFAULT_DATASETS_PATH, "Euclidean", f"{scene}.npz")
    data = np.load(path)
    M = data["M"].astype(np.float64)
    Ps_gt = data["Ps_gt"].astype(np.float64)
    Ns = np.linalg.inv(data["K_gt"].astype(np.float64))
    Ns = Ns / Ns[:, 2, 2][:, None, None]
    Ps_gt = Ps_gt / np.linalg.det(Ns @ Ps_gt[:, :, :3])[:, None, None] ** (1.0 / 3.0)
    R_gt = Ns @ Ps_gt[:, :, :3]
    assert np.allclose(R_gt.swapaxes(1, 2) @ R_gt, np.eye(3)[None], atol=1e-5)
    if use_gt:
        M = correct_matches_global(M, Ps_gt, Ns)
    return M.astype(np.float32), Ns.astype(np.float32), Ps_gt.astype(np.float32)


def get_raw_data_projective(scene: str, use_gt: bool, datasets_path: Optional[str] = None):
    """Parity: reference Projective.get_raw_data (Projective.py:10-40)."""
    path = os.path.join(datasets_path or _DEFAULT_DATASETS_PATH, "Projective", f"{scene}.npz")
    data = np.load(path)
    M = data["M"].astype(np.float64)
    Ps_gt = data["Ps_gt"].astype(np.float64)
    Ns = data["Ns"].astype(np.float64)
    Ns = Ns / Ns[:, 2, 2][:, None, None]
    if use_gt:
        M = correct_matches_global(M, Ps_gt, Ns)
    return M.astype(np.float32), Ns.astype(np.float32), Ps_gt.astype(np.float32)


def create_scene_data(
    conf,
    scene: Optional[str] = None,
    calibrated: Optional[bool] = None,
    use_gt: Optional[bool] = None,
) -> SceneData:
    """Parity: reference SceneData.create_scene_data (SceneData.py:267-303).

    If ``dataset.synthetic.enabled`` is set, generates a synthetic scene
    instead of loading from disk (this environment ships no archives).
    """
    store_depth_targets = conf.get_bool("model.depth_head.enabled", default=False)
    scene = scene if scene is not None else conf.get_string("dataset.scene")
    calibrated = calibrated if calibrated is not None else conf.get_bool("dataset.calibrated")
    use_gt = use_gt if use_gt is not None else conf.get_bool("dataset.use_gt")

    if conf.get_bool("dataset.synthetic.enabled", default=False):
        from gasfm.data.synthetic import synthetic_scene_from_conf

        # Stable across processes/runs: Python's str hash is salted per
        # process (PYTHONHASHSEED), which would generate DIFFERENT geometry
        # for the same named scene on each host of a multi-process run —
        # silently inconsistent shards on one global mesh.
        import zlib

        seed_offset = zlib.crc32(scene.encode()) % 10_000 if scene else 0
        base_conf = conf.copy()
        base_conf.put(
            "dataset.synthetic.seed",
            conf.get_int("dataset.synthetic.seed", default=0) + seed_offset,
        )
        data = synthetic_scene_from_conf(base_conf, scene_name=scene)
        assert data.is_valid_sample()
        return data

    datasets_path = path_to_datasets(conf)
    if calibrated:
        M, Ns, Ps_gt = get_raw_data_euclidean(scene, use_gt, datasets_path)
    else:
        M, Ns, Ps_gt = get_raw_data_projective(scene, use_gt, datasets_path)

    if scene in _SCENES_NEEDING_POINT_FILTER:
        valid = get_M_valid_points(M)
        points_mask = valid.any(axis=0)
        M = M[:, points_mask]

    data = SceneData(
        M, Ns, Ps_gt, scene, calibrated=calibrated, store_depth_targets=store_depth_targets
    )
    assert data.is_valid_sample()
    return data


def create_scene_data_from_list(scene_names: List[str], conf) -> List[SceneData]:
    """Parity: reference SceneData.create_scene_data_from_list (SceneData.py:456-462)."""
    return [create_scene_data(conf, scene=name) for name in scene_names]
