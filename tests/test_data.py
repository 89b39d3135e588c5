"""Data-layer tests: sampling, augmentation geometry, outlier injection
invariants, loaders, and use_gt consistency."""

import numpy as np
import pytest

from gasfm.config import ConfigFactory
from gasfm.data.augmentation import apply_rotational_homography_aug
from gasfm.data.dataset import SceneLoader, ScenesDataSet
from gasfm.data.loaders import correct_matches_global
from gasfm.data.outliers import inject_outliers
from gasfm.data.sampling import get_subset, sample_data, sample_indices
from gasfm.data.synthetic import generate_synthetic_scene
from gasfm.geometry.np_geo import M_to_xs, reprojection_error_with_points
from gasfm.utils.constants import MIN_N_POINTS_PER_VIEW, MIN_N_VIEWS_PER_POINT


class TestSampling:
    def test_sample_indices_adjacent(self):
        rng = np.random.default_rng(0)
        idx = sample_indices(20, 5, adjacent=True, rng=rng)
        assert len(idx) == 5
        assert (np.diff(idx) == 1).all()

    def test_sample_indices_edge_cases(self):
        rng = np.random.default_rng(0)
        assert (sample_indices(10, 1, True, rng) == np.arange(10)).all()  # 1 => all
        assert (sample_indices(10, 15, True, rng) == np.arange(10)).all()  # >= N => all
        assert len(sample_indices(10, 0.5, True, rng)) == 5  # fractional

    def test_sample_data_filters_points(self):
        data = generate_synthetic_scene(n_views=12, n_points=80, seed=0)
        sub = sample_data(data, 5, rng=np.random.default_rng(1))
        assert sub.num_views == 5
        # Every surviving point visible in >= MIN_N_VIEWS_PER_POINT views
        assert (sub.valid_pts.sum(axis=0)[sub.valid_pts.any(axis=0)] >= MIN_N_VIEWS_PER_POINT).all()
        assert sub.num_points <= data.num_points

    def test_get_subset_greedy(self):
        data = generate_synthetic_scene(n_views=10, n_points=60, seed=2)
        sub = get_subset(data, 4)
        assert sub.num_views == 4


class TestAugmentation:
    def test_rotational_homography_preserves_reprojection(self):
        """After the augmentation, the GT cameras must still reproject the
        augmented 2D points exactly (the defining property of H = N^-1 R N
        applied to both)."""
        data = generate_synthetic_scene(n_views=8, n_points=50, seed=3)
        aug = apply_rotational_homography_aug(
            data, inplane_rot_aug_max_angle=15, tilt_rot_aug_max_angle=20,
            rng=np.random.default_rng(0),
        )
        # Points changed
        assert not np.allclose(aug.M, data.M)
        # GT consistency: triangulate with augmented cameras, reproject
        from gasfm.geometry.triangulation import n_view_triangulation

        X = n_view_triangulation(aug.y.astype(np.float64), aug.M.astype(np.float64), aug.Ns.astype(np.float64))
        err = reprojection_error_with_points(aug.y.astype(np.float64), X.T, M_to_xs(aug.M).astype(np.float64))
        assert np.nanmean(err) < 0.05

    def test_noop_without_angles(self):
        data = generate_synthetic_scene(n_views=6, n_points=40, seed=4)
        aug = apply_rotational_homography_aug(data, None, None)
        assert aug is data

    def test_depth_targets_rescaled(self):
        data = generate_synthetic_scene(n_views=8, n_points=50, seed=5, store_depth_targets=True)
        aug = apply_rotational_homography_aug(
            data, inplane_rot_aug_max_angle=10, tilt_rot_aug_max_angle=10,
            rng=np.random.default_rng(1),
        )
        vi, vj = np.nonzero(aug.valid_pts)
        assert np.all(np.isfinite(aug.depths[vi, vj]))
        assert np.all(aug.depths[vi, vj] > 0)


class TestOutlierInjection:
    def test_rate_and_constraints(self):
        data = generate_synthetic_scene(n_views=10, n_points=120, visibility=0.85, seed=6)
        rate = 0.1
        injected = inject_outliers(data, rate, rng=np.random.default_rng(0))
        assert injected is not None
        # Same sparsity pattern
        np.testing.assert_array_equal(injected.valid_pts, data.valid_pts)
        # Outlier count == target rate over observations
        xs_old = M_to_xs(data.M)
        xs_new = M_to_xs(injected.M)
        i, j = np.nonzero(data.valid_pts)
        changed = ~np.isclose(xs_old[i, j], xs_new[i, j]).all(axis=1)
        n_total = len(i)
        assert changed.sum() == round(rate * n_total)
        # Surviving inliers keep the min-degree guarantees
        inlier_mask = np.zeros_like(data.valid_pts)
        inlier_mask[i[~changed], j[~changed]] = True
        assert (inlier_mask.sum(axis=1) >= MIN_N_POINTS_PER_VIEW).all()
        observed = inlier_mask.any(axis=0)
        assert (inlier_mask.sum(axis=0)[observed] >= MIN_N_VIEWS_PER_POINT).all()

    def test_equality_infeasible_takes_retry_path(self):
        """needed == n_free_inliers must take the retry/None path, not fall
        into _add_margin_rate(1.0) whose `0 < rate < margin < 1` assert
        used to kill the epoch (review round 5; the assert is inherited
        from the reference's add_margin_to_outlier_rate)."""
        from gasfm.data.outliers import OutlierInjector

        m, n = 10, 30
        rows = np.repeat(np.arange(m), n).astype(np.int64)
        cols = np.tile(np.arange(n), m).astype(np.int64)
        values = np.random.default_rng(0).normal(size=(m * n, 2)) * 50 + 500
        inj = OutlierInjector(rows, cols, values, m, n, 0.3,
                              rng=np.random.default_rng(0))
        needed = inj.target_n_outliers - inj.n_outliers
        free_idx = np.nonzero(inj.free_in)[0]
        to_fix = free_idx[: len(free_idx) - needed]
        inj.free_in[to_fix] = False
        inj.fixed_in[to_fix] = True
        inj._verify_partitions()
        assert inj.n_free_inliers == needed
        # n_tries=1: the equality case re-inits and recurses with 0 tries
        # left -> graceful None (pre-fix: AssertionError).
        assert inj.select_outliers(n_tries=1) is None

    def test_outliers_are_perturbed_values(self):
        data = generate_synthetic_scene(n_views=8, n_points=100, visibility=0.9, seed=7)
        injected = inject_outliers(data, 0.15, rng=np.random.default_rng(1))
        assert injected is not None
        # Injected values live in a plausible pixel range (drawn from
        # per-view Gaussians fit to the inliers).
        assert np.isfinite(injected.M).all()


class TestLoaders:
    def test_correct_matches_global_zero_error(self):
        data = generate_synthetic_scene(n_views=7, n_points=50, seed=8, noise_px=1.0)
        M_gt = correct_matches_global(
            data.M.astype(np.float64), data.y.astype(np.float64), data.Ns.astype(np.float64)
        )
        # Corrected matches reproject exactly from some 3D structure
        from gasfm.geometry.np_geo import calc_global_reprojection_error

        err = calc_global_reprojection_error(
            data.y.astype(np.float64), M_gt, data.Ns.astype(np.float64)
        )
        assert np.nanmean(err) < 1e-2
        # Pattern preserved
        np.testing.assert_array_equal(M_gt != 0, np.asarray(data.M) != 0)

    def test_scene_loader_batching_and_shuffle(self):
        scenes = [generate_synthetic_scene(n_views=6, n_points=40, seed=s) for s in range(5)]
        ds = ScenesDataSet(scenes, return_all=True)
        loader = SceneLoader(ds, batch_size=2, shuffle=True, rng=np.random.default_rng(0))
        batches = list(loader)
        assert len(loader) == 3
        assert [len(b) for b in batches] == [2, 2, 1]
        names = sorted(d.scene_name for b in batches for d in b)
        assert names == sorted(s.scene_name for s in scenes)

    def test_scene_loader_abandoned_iterator_releases_prefetch_thread(self):
        """Breaking out of a prefetching loader mid-epoch must not leave the
        prefetch thread blocked on a full queue (one leaked thread plus
        `prefetch` batches of host memory per abandoned epoch)."""
        import threading
        import time

        scenes = [generate_synthetic_scene(n_views=6, n_points=40, seed=s) for s in range(6)]
        ds = ScenesDataSet(scenes, return_all=True)
        loader = SceneLoader(ds, batch_size=1, prefetch=1, rng=np.random.default_rng(0))
        before = threading.active_count()
        for _ in range(3):
            for batch in loader:
                break  # abandon with the queue full
        deadline = time.monotonic() + 5.0
        while threading.active_count() > before and time.monotonic() < deadline:
            time.sleep(0.05)
        assert threading.active_count() <= before
        # The loader remains fully usable afterwards.
        assert sum(len(b) for b in loader) == len(scenes)

    def test_dataset_view_sampling_bounds(self):
        scenes = [generate_synthetic_scene(n_views=12, n_points=60, seed=9)]
        ds = ScenesDataSet(scenes, return_all=False, min_num_views_sampled=4,
                           max_num_views_sampled=8, rng=np.random.default_rng(2))
        for _ in range(5):
            s = ds[0]
            assert 4 <= s.num_views <= 8


class TestSyntheticFromConf:
    def test_synthetic_conf_path(self):
        conf = ConfigFactory.parse_string("""
dataset {
  calibrated = true
  use_gt = false
  scene = "synthX"
  synthetic { enabled = true, n_views = 7, n_points = 50, seed = 3 }
}
model { depth_head { enabled = false } }
""")
        from gasfm.data.loaders import create_scene_data

        data = create_scene_data(conf)
        assert data.num_views == 7
        assert data.is_valid_sample()


class TestWorkerPoolLoader:
    """The worker-process loader path (reference DataLoader num_workers
    analogue): deterministic per loader seed regardless of scheduling, and
    sample-equivalent across pool sizes (seeds are drawn per item)."""

    def _make(self, num_workers, seed=5):
        from gasfm.data.dataset import SceneLoader, ScenesDataSet
        from gasfm.data.synthetic import generate_synthetic_scene

        scenes = [
            generate_synthetic_scene(n_views=8, n_points=48, seed=s, scene_name=f"s{s}")
            for s in range(4)
        ]
        ds = ScenesDataSet(
            scenes, return_all=False, min_num_views_sampled=4, max_num_views_sampled=6,
            inplane_rot_aug_max_angle=10.0, tilt_rot_aug_max_angle=10.0,
        )
        return SceneLoader(ds, batch_size=2, shuffle=True,
                           rng=np.random.default_rng(seed), num_workers=num_workers)

    def test_pool_matches_itself_and_other_pool_sizes(self):
        def collect(loader):
            out = []
            for batch in loader:
                for s in batch:
                    out.append((s.scene_name, np.asarray(s.M).copy()))
            loader.close()
            return out

        a = collect(self._make(num_workers=2))
        b = collect(self._make(num_workers=2))
        c = collect(self._make(num_workers=1))
        assert [n for n, _ in a] == [n for n, _ in b] == [n for n, _ in c]
        for (_, ma), (_, mb), (_, mc) in zip(a, b, c):
            np.testing.assert_array_equal(ma, mb)
            np.testing.assert_array_equal(ma, mc)
        for name, m in a:
            assert np.isfinite(m).all() and m.shape[0] % 2 == 0
