"""Graph container + segment ops tests: the padded edge arrays must
reproduce the reference's sparse-matrix semantics exactly (connectivity,
empty-aware means, degrees) — the property-test port of the reference's
commented-out connectivity harness (SceneData.py:189-230)."""

import numpy as np
import jax.numpy as jnp

from gasfm.data.synthetic import generate_synthetic_scene
from gasfm.geometry.np_geo import get_M_valid_points
from gasfm.graph import bucket_size, build_view_graph
from gasfm.ops import (
    gather_segments,
    masked_mean,
    segment_mean,
    segment_softmax,
    segment_sum,
)


def make_graph(seed=0, n_views=7, n_points=50):
    data = generate_synthetic_scene(n_views=n_views, n_points=n_points, seed=seed)
    graph = build_view_graph(data.M, data.Ns)
    return data, graph


class TestBuild:
    def test_edge_set_matches_validity(self):
        data, graph = make_graph()
        valid = get_M_valid_points(data.M)
        rows, cols = np.nonzero(valid)
        e = len(rows)
        assert int(graph.e_true) == e
        emask = np.asarray(graph.edge_mask)
        assert emask.sum() == e
        # Valid edges are exactly the valid (cam, pt) pairs (blocked layout
        # permutes them point-major; compare as sorted pair sets).
        got = np.stack([np.asarray(graph.cam_idx)[emask], np.asarray(graph.pt_idx)[emask]], 1)
        want = np.stack([rows, cols], 1)
        got = got[np.lexsort((got[:, 1], got[:, 0]))]
        want = want[np.lexsort((want[:, 1], want[:, 0]))]
        np.testing.assert_array_equal(got, want)
        # Padded edges carry out-of-range (trash) segment ids
        assert (np.asarray(graph.cam_idx)[~emask] == graph.num_cams).all()
        assert (np.asarray(graph.pt_idx)[~emask] == graph.num_pts).all()

    def test_blocked_layout_invariants(self):
        from gasfm.graph.view_graph import CHUNK, WINDOW
        _, graph = make_graph(seed=11, n_views=9, n_points=700)
        E = graph.num_edges
        assert E % CHUNK == 0
        emask = np.asarray(graph.edge_mask)
        pt = np.asarray(graph.pt_idx)
        wb = np.asarray(graph.pt_window)
        # pt_window constant within each aligned chunk and non-decreasing
        wb_chunks = wb.reshape(E // CHUNK, CHUNK)
        assert (wb_chunks == wb_chunks[:, :1]).all()
        assert (np.diff(wb_chunks[:, 0]) >= 0).all()
        # every valid edge's point id lies in its chunk's window
        lo = wb * WINDOW
        assert (pt[emask] >= lo[emask]).all() and (pt[emask] < lo[emask] + WINDOW).all()
        # visited blocks are exactly those owning a valid edge
        visited = np.asarray(graph.pt_block_visited)
        has_edge = np.zeros_like(visited)
        for b in np.unique(pt[emask] // WINDOW):
            has_edge[b] = True
        np.testing.assert_array_equal(visited, has_edge)

    def test_uv_values_are_normalized_points(self):
        data, graph = make_graph(seed=1)
        emask = np.asarray(graph.edge_mask)
        cam = np.asarray(graph.cam_idx)[emask]
        pt = np.asarray(graph.pt_idx)[emask]
        np.testing.assert_allclose(
            np.asarray(graph.uv)[emask], data.norm_M[cam, pt], atol=1e-6
        )

    def test_degrees(self):
        data, graph = make_graph(seed=2)
        valid = get_M_valid_points(data.M)
        m, n = valid.shape
        np.testing.assert_array_equal(np.asarray(graph.pts_per_cam)[:m], valid.sum(axis=1))
        np.testing.assert_array_equal(np.asarray(graph.cam_per_pts)[:n], valid.sum(axis=0))
        # Padded rows have zero degree
        assert (np.asarray(graph.pts_per_cam)[m:] == 0).all()
        assert (np.asarray(graph.cam_per_pts)[n:] == 0).all()

    def test_blocked_layout_point_major(self):
        # The blocked layout itself keeps valid edges point-major within
        # each window run (pt_order, its sortedness witness, was removed:
        # no runtime consumer, and per-shard slices of a global permutation
        # would be meaningless under edge sharding).
        _, graph = make_graph(seed=3)
        pt = np.asarray(graph.pt_idx)[np.asarray(graph.edge_mask)]
        assert (np.diff(pt) >= 0).all()

    def test_bucket_size(self):
        assert bucket_size(1, 8) == 8
        assert bucket_size(8, 8) == 8
        assert bucket_size(9, 8) >= 9
        assert bucket_size(1000, 128) >= 1000
        # geometric growth: padding waste bounded
        for x in [17, 100, 999, 5000]:
            cap = bucket_size(x, 128)
            assert cap >= x and cap <= max(128, int(x * 1.35) + 128)


class TestSegmentOps:
    def test_segment_mean_matches_dense(self):
        data, graph = make_graph(seed=4)
        valid = get_M_valid_points(data.M)
        m, n = valid.shape
        rng = np.random.default_rng(0)
        feats = rng.normal(size=(graph.num_edges, 5)).astype(np.float32)

        # Dense oracle: mean over valid entries per row / per column
        emask = np.asarray(graph.edge_mask)
        dense = np.zeros((m, n, 5), dtype=np.float32)
        dense[np.asarray(graph.cam_idx)[emask], np.asarray(graph.pt_idx)[emask]] = feats[emask]

        per_cam = segment_mean(
            jnp.asarray(feats), graph.cam_idx, graph.num_cams, edge_mask=graph.edge_mask,
        )
        expected_cam = np.where(
            valid.sum(1, keepdims=True) > 0,
            dense.sum(axis=1) / np.maximum(valid.sum(1, keepdims=True), 1),
            0.0,
        )
        np.testing.assert_allclose(np.asarray(per_cam)[:m], expected_cam, atol=1e-5)

        per_pt = segment_mean(
            jnp.asarray(feats), graph.pt_idx, graph.num_pts, edge_mask=graph.edge_mask
        )
        expected_pt = np.where(
            valid.sum(0)[:, None] > 0,
            dense.sum(axis=0) / np.maximum(valid.sum(0)[:, None], 1),
            0.0,
        )
        np.testing.assert_allclose(np.asarray(per_pt)[:n], expected_pt, atol=1e-5)

    def test_padded_edges_do_not_contribute(self):
        _, graph = make_graph(seed=5)
        feats = np.full((graph.num_edges, 3), 7.0, dtype=np.float32)
        feats[~np.asarray(graph.edge_mask)] = 1e9  # poison padding
        s = segment_sum(jnp.asarray(feats), graph.cam_idx, graph.num_cams, edge_mask=graph.edge_mask)
        assert np.isfinite(np.asarray(s)).all()
        assert (np.asarray(s) < 1e8).all()

    def test_segment_softmax_sums_to_one(self):
        _, graph = make_graph(seed=6)
        rng = np.random.default_rng(1)
        logits = jnp.asarray(rng.normal(size=(graph.num_edges, 4)).astype(np.float32))
        w = segment_softmax(logits, graph.cam_idx, graph.num_cams, edge_mask=graph.edge_mask)
        sums = segment_sum(w, graph.cam_idx, graph.num_cams, edge_mask=graph.edge_mask)
        m = int(graph.m_true)
        np.testing.assert_allclose(np.asarray(sums)[:m], 1.0, atol=1e-5)
        # padding edges get zero weight
        assert (np.asarray(w)[~np.asarray(graph.edge_mask)] == 0).all()

    def test_segment_softmax_matches_dense_softmax(self):
        _, graph = make_graph(seed=7)
        rng = np.random.default_rng(2)
        logits = rng.normal(size=(graph.num_edges,)).astype(np.float32)
        w = np.asarray(
            segment_softmax(jnp.asarray(logits), graph.cam_idx, graph.num_cams, edge_mask=graph.edge_mask)
        )
        emask = np.asarray(graph.edge_mask)
        cam = np.asarray(graph.cam_idx)
        for c in np.unique(cam[emask]):
            idx = np.nonzero((cam == c) & emask)[0]
            ref = np.exp(logits[idx] - logits[idx].max())
            ref = ref / ref.sum()
            np.testing.assert_allclose(w[idx], ref, atol=1e-5)

    def test_masked_mean(self):
        x = jnp.asarray(np.array([[1.0, 2.0], [3.0, 4.0], [100.0, 100.0]], dtype=np.float32))
        mask = jnp.asarray(np.array([True, True, False]))
        out = np.asarray(masked_mean(x, mask, axis=0))
        np.testing.assert_allclose(out, [2.0, 3.0])

    def test_gather_segments_clips_padding(self):
        _, graph = make_graph(seed=8)
        table = jnp.asarray(np.arange(graph.num_cams, dtype=np.float32)[:, None])
        g = gather_segments(table, graph.cam_idx, graph.num_cams)
        assert g.shape == (graph.num_edges, 1)
