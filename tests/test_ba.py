"""Bundle adjustment tests: the native LM+Schur solver must reduce
reprojection error on perturbed synthetic scenes and preserve exact
solutions (the correctness contract of the reference's Ceres setup)."""

import numpy as np
import pytest

from gasfm.ba import euc_ba, proj_ba
from gasfm.ba.packing import order_cam_param_for_c, reorder_from_c_to_py
from gasfm.data.synthetic import generate_synthetic_scene
from gasfm.geometry.np_geo import (
    M_to_xs,
    decompose_camera_matrix,
    reprojection_error_with_points,
    xs_valid_points,
)
from gasfm.geometry.triangulation import n_view_triangulation


def build_problem(seed=0, noise_px=0.0, n_views=8, n_points=60):
    data = generate_synthetic_scene(n_views=n_views, n_points=n_points, seed=seed, noise_px=noise_px)
    xs = M_to_xs(data.M.astype(np.float64))
    Ks = np.linalg.inv(data.Ns.astype(np.float64))
    Rs, ts = decompose_camera_matrix(data.y.astype(np.float64), Ks)
    X = n_view_triangulation(data.y.astype(np.float64), data.M.astype(np.float64), data.Ns.astype(np.float64))
    return data, xs, Ks, Rs, ts, X.T[:, :3]


class TestPacking:
    def test_pack_unpack_roundtrip(self):
        data, xs, Ks, Rs, ts, X = build_problem()
        packed = order_cam_param_for_c(Rs, ts, Ks)
        Rs2, ts2, Ps2 = reorder_from_c_to_py(packed, Ks)
        np.testing.assert_allclose(Rs2, Rs, atol=1e-6)
        np.testing.assert_allclose(ts2, ts, atol=1e-6)
        err = reprojection_error_with_points(Ps2, X, xs)
        assert np.nanmean(err) < 1e-2


class TestEuclideanBA:
    def test_ba_improves_perturbed_cameras(self):
        data, xs, Ks, Rs, ts, X = build_problem(seed=1)
        rng = np.random.default_rng(0)
        # Perturb camera centers and points
        ts_pert = ts + 0.02 * rng.normal(size=ts.shape)
        X_pert = X + 0.02 * rng.normal(size=X.shape)
        res = euc_ba(xs, Rs=Rs, ts=ts_pert, Ks=Ks, Xs_our=X_pert, Ns=data.Ns.astype(np.float64),
                     repeat=False, print_out=False)
        assert res["converged1"]
        assert res["repro_after"] < res["repro_before"] * 0.1
        assert res["repro_after"] < 0.05  # near-exact recovery on noise-free data

    def test_ba_repeat_with_retriangulation(self):
        data, xs, Ks, Rs, ts, X = build_problem(seed=2, noise_px=0.5)
        rng = np.random.default_rng(1)
        ts_pert = ts + 0.01 * rng.normal(size=ts.shape)
        res = euc_ba(xs, Rs=Rs, ts=ts_pert, Ks=Ks, Xs_our=X, Ns=data.Ns.astype(np.float64),
                     repeat=True, print_out=False)
        assert res["converged1"] and res["converged2"]
        for key in ("repro_before", "repro_middle", "repro_middle_triangulated", "repro_after"):
            assert np.isfinite(res[key])
        assert res["repro_after"] <= res["repro_before"] + 1e-6
        assert res["repro_after"] < 1.0  # sub-pixel under 0.5px noise

    def test_ba_repeat_with_default_ns(self):
        """euc_ba's plainest signature (Ns omitted, repeat=True — the
        defaults) used to crash: the repeat branch passed Ns=None straight
        into normalize_points_cams (review round 5; the reference shares
        the omission, ba_functions.py:50). The inv(K) fallback must apply
        in BOTH branches, as it already did in proj_ba."""
        data, xs, Ks, Rs, ts, X = build_problem(seed=2, noise_px=0.5)
        rng = np.random.default_rng(1)
        ts_pert = ts + 0.01 * rng.normal(size=ts.shape)
        res = euc_ba(xs, Rs=Rs, ts=ts_pert, Ks=Ks, Xs_our=X, print_out=False)
        assert res["converged1"] and res["converged2"]
        assert np.isfinite(res["repro_after"])
        assert res["repro_after"] <= res["repro_before"] + 1e-6

    def test_ba_no_change_on_exact_solution(self):
        data, xs, Ks, Rs, ts, X = build_problem(seed=3)
        res = euc_ba(xs, Rs=Rs, ts=ts, Ks=Ks, Xs_our=X, Ns=data.Ns.astype(np.float64),
                     repeat=False, print_out=False)
        # Already optimal: reprojection stays tiny
        assert res["repro_after"] < 5e-2


class TestProjectiveBA:
    def test_proj_ba_improves(self):
        data, xs, Ks, Rs, ts, X = build_problem(seed=4)
        Ps = data.y.astype(np.float64)
        rng = np.random.default_rng(2)
        Ps_pert = Ps * (1 + 0.005 * rng.normal(size=Ps.shape))
        res = proj_ba(Ps=Ps_pert, xs=xs, Xs_our=X, Ns=data.Ns.astype(np.float64),
                      repeat=False, print_out=False)
        assert res["converged1"]
        assert res["repro_after"] < res["repro_before"]
        assert res["repro_after"] < 0.5
