"""Artificial outlier injection for robustness training.

Parity: reference ``OutlierInjector`` / ``inject_outliers``
(code/utils/dataset_utils.py:159-461): stateful partition of observations
into fixed/free inlier/outlier sets, target-rate sampling with a weighted
harmonic-mean margin and blacklisting so the surviving inliers keep
>= MIN_N_POINTS_PER_VIEW points per view and >= MIN_N_VIEWS_PER_POINT views
per point (up to 5 retries), then replacement of the selected observations
with samples from per-view bivariate Gaussians.

Faithful quirk kept: the reference's ``sparse_moment_estimation``
(sparse_utils.py:151-165) uses the Bessel-corrected *second moment*
E[x x^T] * k/(k-1) — not the centered covariance — as the Gaussian scale
matrix; we reproduce that. The factorization here is an eigendecomposition
square root instead of the reference's LDL-with-pivot-fix-up (any A with
A A^T = Sigma is valid — the reference says so itself, dataset_utils.py:384).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from gasfm.data.scene import SceneData
from gasfm.utils.constants import MIN_N_POINTS_PER_VIEW, MIN_N_VIEWS_PER_POINT


class OutlierInjector:
    def __init__(self, rows, cols, values, n_views, n_points, outlier_injection_rate, rng=None):
        assert 0 < outlier_injection_rate < 1
        self.rng = rng if rng is not None else np.random.default_rng()
        self.rows = rows  # (nnz,) view index per observation
        self.cols = cols  # (nnz,) point index per observation
        self.values = values  # (nnz, 2) pixel coordinates
        self.n_views = n_views
        self.n_points = n_points
        self.rate = outlier_injection_rate
        self.nnz = rows.shape[0]

        self.fixed_in, self.fixed_out = self._init_fixed()
        self.free_in, self.free_out = self._init_free()
        self._verify_partitions()

    # -- bookkeeping -------------------------------------------------------

    def _counts(self, keep_mask):
        pts_per_view = np.bincount(self.rows[keep_mask], minlength=self.n_views)
        views_per_pt = np.bincount(self.cols[keep_mask], minlength=self.n_points)
        return pts_per_view, views_per_pt

    def _verify_partitions(self):
        total = (
            self.fixed_in.astype(int)
            + self.fixed_out.astype(int)
            + self.free_in.astype(int)
            + self.free_out.astype(int)
        )
        assert np.all(total == 1)

    @property
    def remaining_inliers_mask(self):
        return self.fixed_in | self.free_in

    @property
    def n_outliers(self):
        return int((self.fixed_out | self.free_out).sum())

    @property
    def n_free_inliers(self):
        return int(self.free_in.sum())

    @property
    def target_n_outliers(self):
        return round(self.rate * self.nnz)

    # -- initialization ----------------------------------------------------

    def _init_fixed(self):
        pts_per_view, views_per_pt = self._counts(np.ones(self.nnz, dtype=bool))
        assert np.all(pts_per_view >= MIN_N_POINTS_PER_VIEW)
        # Points visible in exactly 0 views have no observations, so only
        # existing observations matter for the check below.
        observed = views_per_pt > 0
        assert np.all(views_per_pt[observed] >= MIN_N_VIEWS_PER_POINT)

        disregarded_points = views_per_pt < MIN_N_VIEWS_PER_POINT + 1
        disregarded_views = pts_per_view < MIN_N_POINTS_PER_VIEW + 1
        fixed_in = disregarded_points[self.cols] | disregarded_views[self.rows]
        fixed_out = np.zeros(self.nnz, dtype=bool)
        return fixed_in, fixed_out

    def _init_free(self):
        free_in = ~(self.fixed_in | self.fixed_out)
        free_out = np.zeros(self.nnz, dtype=bool)
        return free_in, free_out

    # -- selection ---------------------------------------------------------

    @staticmethod
    def _add_margin_rate(rate, w_desired=0.5):
        """Weighted harmonic mean of the desired rate with 1
        (reference dataset_utils.py:278-285)."""
        rate_with_margin = 1.0 / (w_desired / rate + (1.0 - w_desired) / 1.0)
        assert 0 < rate < rate_with_margin < 1
        return rate_with_margin

    def _sample_more_outliers(self, n_new):
        candidates = np.nonzero(self.free_in)[0]
        chosen = self.rng.choice(candidates, size=n_new, replace=False)
        self.free_in[chosen] = False
        self.free_out = ~(self.fixed_in | self.fixed_out | self.free_in)
        self._verify_partitions()

    def _blacklist_problematic_outliers(self):
        pts_per_view, views_per_pt = self._counts(self.remaining_inliers_mask)
        bad_points = views_per_pt < MIN_N_VIEWS_PER_POINT
        bad_views = pts_per_view < MIN_N_POINTS_PER_VIEW
        problematic = bad_points[self.cols] | bad_views[self.rows]
        self.fixed_in |= self.free_out & problematic
        self.free_out &= ~self.fixed_in
        self._verify_partitions()

    def _remove_surplus(self):
        pts_per_view, views_per_pt = self._counts(self.remaining_inliers_mask)
        assert np.all(pts_per_view >= MIN_N_POINTS_PER_VIEW)
        observed = np.bincount(self.cols, minlength=self.n_points) > 0
        assert np.all(views_per_pt[observed] >= MIN_N_VIEWS_PER_POINT)

        surplus = self.n_outliers - self.target_n_outliers
        assert surplus >= 0
        assert int(self.free_out.sum()) >= surplus
        candidates = np.nonzero(self.free_out)[0]
        demote = self.rng.choice(candidates, size=surplus, replace=False)
        self.free_out[demote] = False
        self.free_in = ~(self.fixed_in | self.fixed_out | self.free_out)
        assert self.n_outliers == self.target_n_outliers
        self._verify_partitions()

    def select_outliers(self, n_tries: int = 5) -> Optional[np.ndarray]:
        if n_tries <= 0:
            return None
        while self.n_outliers < self.target_n_outliers:
            needed = self.target_n_outliers - self.n_outliers
            # >= not >: needed == n_free_inliers would reach _add_margin_rate
            # with rate == 1.0, whose `0 < rate < margin < 1` assert crashes
            # (inherited from the reference, dataset_utils.py:278-285) —
            # taking EVERY free inlier leaves no margin pool either way, so
            # the equality case is just as infeasible as the > case and must
            # take the retry/None path this module's contract promises.
            if needed >= self.n_free_inliers:
                # Not enough free observations; retry from scratch.
                self.fixed_in, self.fixed_out = self._init_fixed()
                self.free_in, self.free_out = self._init_free()
                print(f"Retry outlier sampling, {n_tries - 1} attempts remaining.")
                return self.select_outliers(n_tries=n_tries - 1)
            rate = self._add_margin_rate(needed / self.n_free_inliers)
            n_with_margin = round(rate * self.n_free_inliers)
            assert n_with_margin <= self.n_free_inliers
            self._sample_more_outliers(n_with_margin)
            self._blacklist_problematic_outliers()
        self._remove_surplus()
        return self.fixed_out | self.free_out

    # -- injection ---------------------------------------------------------

    def inject(self, outliers_mask: np.ndarray) -> np.ndarray:
        """Replace selected observations with per-view Gaussian samples.

        Returns the full (nnz, 2) value array with outliers substituted.
        """
        inlier_mask = ~outliers_mask
        pts_per_view_in = np.bincount(self.rows[inlier_mask], minlength=self.n_views)
        assert np.all(pts_per_view_in >= MIN_N_POINTS_PER_VIEW)

        # Per-view mean and Bessel-corrected second moment (parity quirk).
        mu = np.zeros((self.n_views, 2))
        sigma = np.zeros((self.n_views, 2, 2))
        vals_in = self.values[inlier_mask]
        rows_in = self.rows[inlier_mask]
        np.add.at(mu, rows_in, vals_in)
        mu /= np.maximum(pts_per_view_in, 1)[:, None]
        outer = vals_in[:, :, None] * vals_in[:, None, :]
        np.add.at(sigma, rows_in, outer)
        sigma /= np.maximum(pts_per_view_in - 1, 1)[:, None, None]

        # Symmetric PSD square root: A = V diag(sqrt(max(w, 0))) V^T.
        w, V = np.linalg.eigh(sigma)
        sqrt_w = np.sqrt(np.maximum(w, 0.0))
        A = V * sqrt_w[:, None, :] @ np.transpose(V, (0, 2, 1))
        assert np.allclose(sigma, A @ np.transpose(A, (0, 2, 1)), atol=1e-6 * max(1.0, np.abs(sigma).max()))

        out_rows = self.rows[outliers_mask]
        z = self.rng.standard_normal((out_rows.shape[0], 2, 1))
        samples = mu[out_rows] + (A[out_rows] @ z).squeeze(2)

        new_values = self.values.copy()
        new_values[outliers_mask] = samples
        return new_values


def inject_outliers(
    scene_data: SceneData, outlier_injection_rate: float, rng: Optional[np.random.Generator] = None
) -> Optional[SceneData]:
    """Parity: reference dataset_utils.inject_outliers (dataset_utils.py:430-461).

    Works in *pixel* coordinates on the raw M. Returns None if the target
    rate could not be achieved (caller skips the sample).
    """
    assert 0 < outlier_injection_rate < 1
    M = scene_data.M
    n_views = M.shape[0] // 2
    n_points = M.shape[1]
    xs = M.reshape(n_views, 2, n_points).transpose(0, 2, 1)  # (m, n, 2)
    rows, cols = np.nonzero(scene_data.valid_pts)
    values = xs[rows, cols, :].astype(np.float64)

    injector = OutlierInjector(rows, cols, values, n_views, n_points, outlier_injection_rate, rng=rng)
    outliers_mask = injector.select_outliers(n_tries=5)
    if outliers_mask is None:
        return None
    new_values = injector.inject(outliers_mask)

    new_xs = np.zeros_like(xs)
    new_xs[rows, cols, :] = new_values
    new_M = new_xs.transpose(0, 2, 1).reshape(2 * n_views, n_points).astype(np.float32)

    return SceneData(
        new_M,
        scene_data.Ns,
        scene_data.y,
        scene_data.scene_name,
        calibrated=scene_data.calibrated,
        store_depth_targets=scene_data.store_depth_targets,
        depths=scene_data.depths,
    )
