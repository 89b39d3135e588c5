"""Tests for the legacy .mat BA I/O readers (reference utils/ba_io.py) and
the Parameter3DPts bank (reference models/layers.py:47-57)."""

import numpy as np
import pytest

from gasfm.ba import io as ba_io


@pytest.fixture()
def mat_scene(tmp_path):
    sio = pytest.importorskip("scipy.io")
    m, n = 3, 5
    rng = np.random.default_rng(0)
    M = rng.standard_normal((2 * m, n))
    data = {
        "Ps": rng.standard_normal((m, 3, 4)),
        "Points3D": rng.standard_normal((3, n)),
        "M": M,
        "R_gt": rng.standard_normal((m, 3, 3)),
        "T_gt": rng.standard_normal((m, 3)),
        "K_gt": rng.standard_normal((m, 3, 3)),
    }
    path = str(tmp_path / "scene")
    sio.savemat(path + ".mat", data)
    return path, data


def test_read_mat_files(mat_scene):
    path, data = mat_scene
    out = ba_io.read_mat_files(path)
    assert out["Ps"].shape == (3, 3, 4)
    assert out["Xs"].shape == (5, 3)
    assert out["xs"].shape == (3, 5, 2)
    # xs unpacking: row 2i of M is x, row 2i+1 is y.
    np.testing.assert_allclose(out["xs"][1, :, 0], data["M"][2], rtol=1e-12)
    np.testing.assert_allclose(out["xs"][1, :, 1], data["M"][3], rtol=1e-12)


def test_read_euc_gt_mat_files(mat_scene):
    path, data = mat_scene
    out = ba_io.read_euc_gt_mat_files(path)
    assert out["Rs"].shape == (3, 3, 3)
    assert out["ts"].shape == (3, 3)
    assert out["Ks"].shape == (3, 3, 3)
    assert out["xs"].shape == (3, 5, 2)


def test_parameter_3d_pts():
    import jax

    from gasfm.models.layers import Parameter3DPts

    m = Parameter3DPts(n_pts=11)
    params = m.init(jax.random.PRNGKey(0))
    pts = m.apply(params)
    assert pts.shape == (3, 11)
    # sigma=0.1 init: values should be small but not all zero.
    assert 0 < float(np.abs(np.asarray(pts)).max()) < 1.0
