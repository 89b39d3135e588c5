"""Host-side scene container and conversion to the device graph.

Parity: reference ``SceneData`` (code/datasets/SceneData.py:15-264) — holds
the (2m, n) measurement matrix, per-view normalization matrices Ns
(= inv(K) when calibrated), GT cameras, validity mask, normalized points and
optional GT depths derived by host DLT triangulation with the same invariant
asserts. Everything here is NumPy; :meth:`SceneData.to_scene_graph` produces
the padded, statically-shaped device pytree.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from gasfm.geometry.np_geo import M_to_xs, get_M_valid_points, normalize_M
from gasfm.geometry.triangulation import n_view_triangulation
from gasfm.graph.view_graph import SceneGraph, build_scene_graph
from gasfm.utils.constants import MIN_N_POINTS_PER_VIEW, MIN_N_VIEWS_PER_POINT


class SceneData:
    def __init__(
        self,
        M: np.ndarray,
        Ns: np.ndarray,
        Ps_gt: np.ndarray,
        scene_name: str,
        calibrated: bool = False,
        store_depth_targets: bool = False,
        depths: Optional[np.ndarray] = None,
    ):
        self.scene_name = scene_name
        self.calibrated = calibrated
        self.store_depth_targets = store_depth_targets
        self.M = np.asarray(M, dtype=np.float32)
        self.Ns = np.asarray(Ns, dtype=np.float32)
        self.y = np.asarray(Ps_gt, dtype=np.float32)  # GT cameras ("y" as in reference)

        n_images = self.y.shape[0]
        assert self.M.shape[0] == 2 * n_images

        self.valid_pts = get_M_valid_points(self.M)  # (m, n)
        self.norm_M = normalize_M(self.M, self.Ns, self.valid_pts)  # (m, n, 2)
        self.Ns_invT = np.transpose(
            np.linalg.inv(self.Ns.astype(np.float64)).astype(np.float32), (0, 2, 1)
        )

        if self.store_depth_targets:
            if depths is not None:
                self.depths = np.asarray(depths, dtype=np.float32)
            else:
                # GT depths from host DLT triangulation, with the reference's
                # invariant checks (SceneData.py:57-132).
                if not calibrated:
                    raise NotImplementedError(
                        "Depth targets for uncalibrated scenes not implemented (parity)."
                    )
                K_inv = self.Ns.astype(np.float64)
                X = n_view_triangulation(
                    self.y.astype(np.float64), self.M.astype(np.float64), Ns=K_inv
                )  # (4, n)
                valid_scenepoint = self.valid_pts.any(axis=0)
                assert np.all(np.isfinite(X[:, valid_scenepoint]))
                assert np.allclose(X[3, valid_scenepoint], 1.0)
                assert np.allclose(K_inv[:, 2, :], np.array([0.0, 0.0, 1.0])[None, None, :])
                R = K_inv @ self.y.astype(np.float64)[:, :, :3]
                assert np.allclose(np.linalg.norm(R, axis=2), 1.0, atol=1e-4)
                depths_dense = (K_inv @ self.y.astype(np.float64) @ X)[:, 2, :]
                vi, vj = np.nonzero(self.valid_pts)
                assert np.all(np.isfinite(depths_dense[vi, vj]))
                assert np.all(depths_dense[vi, vj] > 0), "negative GT depths at valid points"
                self.depths = depths_dense.astype(np.float32)
            assert self.depths.shape == (n_images, self.M.shape[1])
        else:
            self.depths = None

    # -- stats / validity --------------------------------------------------

    @property
    def num_views(self) -> int:
        return self.y.shape[0]

    @property
    def num_points(self) -> int:
        return self.M.shape[1]

    @property
    def pts_per_cam(self) -> np.ndarray:
        return self.valid_pts.sum(axis=1)

    @property
    def cam_per_pts(self) -> np.ndarray:
        return self.valid_pts.sum(axis=0)

    def is_valid_sample(self) -> bool:
        """Parity: reference dataset_utils.is_valid_sample (dataset_utils.py:12-14)."""
        return bool(
            self.pts_per_cam.min() >= MIN_N_POINTS_PER_VIEW
            and self.cam_per_pts.min() >= MIN_N_VIEWS_PER_POINT
        )

    def get_data_statistics(self) -> dict:
        """Parity: reference dataset_utils.get_data_statistics (dataset_utils.py:49-55)."""
        valid_stat = self.valid_pts.sum(axis=0).astype(np.float64)
        return {
            "Max_2d_pt": float(self.M.max()),
            "Num_2d_pts": int(self.valid_pts.sum()),
            "n_pts": int(self.M.shape[-1]),
            "Cameras_per_pts_mean": float(valid_stat.mean()),
            "Cameras_per_pts_std": float(valid_stat.std(ddof=1)),
            "Num of cameras": int(self.y.shape[0]),
        }

    # -- device conversion -------------------------------------------------

    def to_scene_graph(self, caps: Optional[Tuple[int, int, int]] = None, **bucket_kwargs) -> SceneGraph:
        return build_scene_graph(
            self.M,
            self.Ns,
            self.y,
            caps=caps,
            gt_depths_dense=self.depths if self.store_depth_targets else None,
            **bucket_kwargs,
        )

    def xs(self) -> np.ndarray:
        return M_to_xs(self.M)
