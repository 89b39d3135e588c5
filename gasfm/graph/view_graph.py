"""Edge-centric, statically-shaped view-graph container.

This replaces the reference's per-sample rebuilt sparse structures — the
custom ``SparseMat`` (reference: code/utils/sparse_utils.py:392-449) and the
four ``AxialAggregationGraphWrapper`` PyG edge lists (reference:
code/utils/dataset_utils.py:464-597, code/datasets/SceneData.py:136-239) —
with a single immutable pytree of padded, bucket-capped arrays.

Why static shapes: XLA traces once per shape. The reference rebuilds the graph on
the host for every training sample because view subsampling changes the
sparsity pattern (reference: code/datasets/ScenesDataSet.py:30-48). Here the
(views, points, edges) counts are padded up to bucketed caps so the jitted
train/eval steps are compiled once per bucket and reused across scenes and
samples. Padded edges carry segment id == num_segments and are dropped by the
segment reductions; padded views/points are masked.

Conventions (the *blocked point-major* edge layout):
- Edges are sorted by (point id, camera id) and grouped into *point blocks*
  of ``WINDOW`` consecutive point ids (block k owns points
  [k*WINDOW, (k+1)*WINDOW)). Each block's edge run is padded with invalid
  edges up to a multiple of ``CHUNK``, so every aligned chunk of ``CHUNK``
  edges touches point ids from exactly one block window. Edge-sharded runs
  use this to give each shard a contiguous range of point windows
  (parallel.edge_sharding.compute_owned_points).
- ``pt_window`` stores each edge's point-block index (constant within every
  aligned chunk; trailing all-padding chunks repeat the last block id so the
  per-chunk block sequence stays non-decreasing). ``pt_block_visited`` marks
  blocks that own at least one valid edge.
- Per-camera segment ids are NOT sorted in this layout.
- ``uv`` holds the *normalized* (N-matrix-applied) 2D observations, i.e. the
  values of the reference's ``data.x`` SparseMat
  (reference: code/utils/dataset_utils.py:116-156 ``M2sparse(normalize=True)``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from gasfm.utils.constants import MIN_N_POINTS_PER_VIEW, MIN_N_VIEWS_PER_POINT


# Point-window width and DEFAULT edge-chunk length of the blocked layout.
# The chunk is a PER-GRAPH property (ViewGraph.chunk, static metadata), so
# scenes with different chunks coexist in one process — one compiled
# program per (caps, chunk) key, exactly like any other shape. Chunk sets
# the per-block padding granularity: sparse scenes want a smaller chunk
# (per-window runs round up to a chunk multiple); see choose_chunk().
# GASFM_CHUNK overrides the DEFAULT for experiments; the production
# bucketizer picks per scene (train/loop.GraphBucketizer).
import os as _os

WINDOW = 128
CHUNK = int(_os.environ.get("GASFM_CHUNK", "512"))
# The caps/reshape invariants of the layout need a positive multiple of 128,
# and of 1024 above 1024 (the chunk grid the bucket rule was built on).
# Multi-host runs must set it identically in every process (it shapes the
# compiled programs). Raise (not assert): the check must survive python -O.
if CHUNK <= 0 or CHUNK % 128 != 0 or (CHUNK > 1024 and CHUNK % 1024 != 0):
    raise ValueError(
        "GASFM_CHUNK must be a positive multiple of 128 (and of 1024 when "
        f"above 1024), got {CHUNK}"
    )


def choose_chunk(n_valid_edges: int, n_points: int) -> int:
    """Automatic chunk selection by the scene's mean window run.

    The mean number of edges per WINDOW-point block (~ mean_track_len *
    WINDOW) sets the padding trade: each block's edge run pads up to a chunk
    multiple, so short runs at a long chunk waste most slots, while long
    runs pad proportionally little at any chunk. Rule: run >= 1792 -> 2048,
    >= 1024 -> 1024, >= 256 -> 512, else 256.

    If GASFM_CHUNK is set it wins (the experiment escape hatch).
    """
    if "GASFM_CHUNK" in _os.environ:
        return CHUNK
    run = n_valid_edges * WINDOW / max(n_points, 1)
    if run >= 1792:
        return 2048
    if run >= 1024:
        return 1024
    if run >= 256:
        return 512
    return 256


def _round_up(x: int, m: int) -> int:
    return ((max(x, 1) + m - 1) // m) * m


def _round_up_arr(x: np.ndarray, m: int) -> np.ndarray:
    return ((x + m - 1) // m) * m


def blocked_edge_count(M: np.ndarray, chunk: Optional[int] = None) -> int:
    """Edge slots the blocked layout needs for measurement matrix ``M``
    (valid edges plus per-point-block padding). Use this instead of the raw
    nnz when pinning shared edge caps across scenes."""
    from gasfm.geometry.np_geo import get_M_valid_points

    chunk = CHUNK if chunk is None else chunk
    valid = get_M_valid_points(np.asarray(M, dtype=np.float32))
    _, cols = np.nonzero(valid)
    if cols.size == 0:
        return 0
    _, counts = np.unique(cols // WINDOW, return_counts=True)
    return int(_round_up_arr(counts, chunk).sum())


def bucket_size(x: int, multiple: int, growth: float = 1.3) -> int:
    """Smallest padded capacity >= x on a geometric grid, aligned to `multiple`.

    Geometric bucketing bounds both padding waste (< `growth`x) and the number
    of distinct compiled shapes (log-many).
    """
    x = max(int(x), 1)
    base = multiple
    while base < x:
        base = _round_up(int(math.ceil(base * growth)), multiple)
    return base


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ViewGraph:
    """Static-shape bipartite camera x point graph over valid observations."""

    # Per-edge arrays, length E (capacity):
    uv: jnp.ndarray  # (E, 2) float32 normalized 2D observations
    cam_idx: jnp.ndarray  # (E,) int32 in [0, M); padded edges hold M
    pt_idx: jnp.ndarray  # (E,) int32 in [0, N); padded edges hold N
    edge_mask: jnp.ndarray  # (E,) bool
    pt_window: jnp.ndarray  # (E,) int32 point-block index per edge
    pt_block_visited: jnp.ndarray  # (ceil(N/WINDOW),) bool

    # Per-view / per-point masks, lengths M / N (capacities):
    cam_mask: jnp.ndarray  # (M,) bool — view exists
    pt_mask: jnp.ndarray  # (N,) bool — point exists
    cam_valid: jnp.ndarray  # (M,) bool — >= MIN_N_POINTS_PER_VIEW observations
    pt_valid: jnp.ndarray  # (N,) bool — >= MIN_N_VIEWS_PER_POINT observations

    # True (unpadded) sizes as traced scalars:
    m_true: jnp.ndarray  # () int32
    n_true: jnp.ndarray  # () int32
    e_true: jnp.ndarray  # () int32

    # Edge-chunk length of THIS graph's blocked layout (static pytree
    # metadata: part of the treedef, so jitted callables specialize per
    # chunk exactly as they do per shape).
    chunk: int = dataclasses.field(default=CHUNK, metadata=dict(static=True))

    @property
    def num_cams(self) -> int:
        return self.cam_mask.shape[0]

    @property
    def num_pts(self) -> int:
        return self.pt_mask.shape[0]

    @property
    def num_edges(self) -> int:
        return self.edge_mask.shape[0]

    @property
    def pts_per_cam(self) -> jnp.ndarray:
        """(M,) observation count per view (reference SparseMat.pts_per_cam)."""
        ones = self.edge_mask.astype(jnp.int32)
        return jax.ops.segment_sum(ones, self.cam_idx, num_segments=self.num_cams)

    @property
    def cam_per_pts(self) -> jnp.ndarray:
        """(N,) observation count per point (reference SparseMat.cam_per_pts)."""
        ones = self.edge_mask.astype(jnp.int32)
        return jax.ops.segment_sum(ones, self.pt_idx, num_segments=self.num_pts)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SceneGraph:
    """A graph plus the per-scene camera-side arrays the model & loss need."""

    graph: ViewGraph
    Ns: jnp.ndarray  # (M, 3, 3) normalization matrices (inv(K) if calibrated)
    Ns_inv: jnp.ndarray  # (M, 3, 3)
    Ps_gt: jnp.ndarray  # (M, 3, 4) GT cameras (zero-padded)
    gt_depths: Optional[jnp.ndarray] = None  # (E,) per-edge GT depths or None


def build_view_graph(
    M: np.ndarray,
    Ns: np.ndarray,
    caps: Optional[Tuple[int, int, int]] = None,
    cam_multiple: int = 8,
    pt_multiple: int = 256,
    edge_multiple: Optional[int] = None,
    growth: float = 1.3,
    chunk: Optional[int] = None,
) -> ViewGraph:
    """Host-side construction from a (2m, n) measurement matrix.

    `caps` optionally pins (M_cap, N_cap, E_cap); otherwise bucketed caps are
    derived. `chunk` pins this graph's edge-chunk length (default: the
    process-wide CHUNK; the production bucketizer passes choose_chunk()).
    Mirrors the reference's M2sparse + validity semantics
    (reference: code/utils/dataset_utils.py:86-156).
    """
    from gasfm.geometry.np_geo import get_M_valid_points, normalize_M

    chunk = CHUNK if chunk is None else int(chunk)
    if chunk <= 0 or chunk % 128 != 0 or (chunk > 1024 and chunk % 1024 != 0):
        raise ValueError(
            "chunk must be a positive multiple of 128 (and of 1024 when above "
            f"1024), got {chunk}"
        )
    # The edge cap stays a chunk multiple (the per-chunk window metadata
    # reshapes by it); callers that need a coarser grid (edge sharding) pass
    # edge_multiple = chunk * n_edge_shards explicitly (train/loop.py).
    if edge_multiple is None:
        edge_multiple = chunk
    M = np.asarray(M, dtype=np.float32)
    m = M.shape[0] // 2
    n = M.shape[1]
    valid = get_M_valid_points(M)  # (m, n) bool
    norm_M = normalize_M(M, np.asarray(Ns, dtype=np.float32), valid)  # (m, n, 2)

    rows, cols = np.nonzero(valid)  # row-major order
    e = rows.shape[0]

    # Blocked point-major layout: sort edges by (point, camera), group into
    # point blocks of WINDOW ids, pad each block's run to a CHUNK multiple.
    order = np.lexsort((rows, cols))
    rows, cols = rows[order], cols[order]
    blk_of_edge = cols // WINDOW
    blk_ids, blk_counts = np.unique(blk_of_edge, return_counts=True)
    blk_padded = _round_up_arr(blk_counts, chunk)
    e_blocked = int(blk_padded.sum()) if e > 0 else 0

    if caps is None:
        # Camera caps are at most the next 128-multiple of m (the growth
        # grid alone lands e.g. 156 for m=128).
        m_cap = min(bucket_size(m, cam_multiple, growth), _round_up(m, 128))
        n_cap = bucket_size(n, pt_multiple, growth)
        e_cap = bucket_size(e_blocked, edge_multiple, growth)
    else:
        m_cap, n_cap, e_cap = caps
        assert m_cap >= m and n_cap >= n and e_cap >= e_blocked, (
            f"caps {caps} too small for scene with (m={m}, n={n}, e={e}, "
            f"e_blocked={e_blocked}); use blocked_edge_count() to size edge caps"
        )

    n_blocks_cap = max(1, -(-n_cap // WINDOW))
    last_blk = int(blk_ids[-1]) if e > 0 else 0

    uv = np.zeros((e_cap, 2), dtype=np.float32)
    cam_idx = np.full((e_cap,), m_cap, dtype=np.int32)
    pt_idx = np.full((e_cap,), n_cap, dtype=np.int32)
    edge_mask = np.zeros((e_cap,), dtype=bool)
    pt_window = np.full((e_cap,), last_blk, dtype=np.int32)
    pt_block_visited = np.zeros((n_blocks_cap,), dtype=bool)

    uv_vals = norm_M[rows, cols]
    src, dst = 0, 0
    for b, cnt, pad_cnt in zip(blk_ids, blk_counts, blk_padded):
        cnt, pad_cnt = int(cnt), int(pad_cnt)
        uv[dst : dst + cnt] = uv_vals[src : src + cnt]
        cam_idx[dst : dst + cnt] = rows[src : src + cnt]
        pt_idx[dst : dst + cnt] = cols[src : src + cnt]
        edge_mask[dst : dst + cnt] = True
        pt_window[dst : dst + pad_cnt] = b
        pt_block_visited[b] = True
        src += cnt
        dst += pad_cnt

    cam_mask = np.zeros((m_cap,), dtype=bool)
    cam_mask[:m] = True
    pt_mask = np.zeros((n_cap,), dtype=bool)
    pt_mask[:n] = valid.any(axis=0)

    pts_per_cam = valid.sum(axis=1)
    cam_per_pts = valid.sum(axis=0)
    cam_valid = np.zeros((m_cap,), dtype=bool)
    cam_valid[:m] = pts_per_cam >= MIN_N_POINTS_PER_VIEW
    pt_valid = np.zeros((n_cap,), dtype=bool)
    pt_valid[:n] = cam_per_pts >= MIN_N_VIEWS_PER_POINT

    return ViewGraph(
        uv=jnp.asarray(uv),
        cam_idx=jnp.asarray(cam_idx),
        pt_idx=jnp.asarray(pt_idx),
        edge_mask=jnp.asarray(edge_mask),
        pt_window=jnp.asarray(pt_window),
        pt_block_visited=jnp.asarray(pt_block_visited),
        cam_mask=jnp.asarray(cam_mask),
        pt_mask=jnp.asarray(pt_mask),
        cam_valid=jnp.asarray(cam_valid),
        pt_valid=jnp.asarray(pt_valid),
        m_true=jnp.asarray(m, dtype=jnp.int32),
        n_true=jnp.asarray(n, dtype=jnp.int32),
        e_true=jnp.asarray(e, dtype=jnp.int32),
        chunk=chunk,
    )


def build_scene_graph(
    M: np.ndarray,
    Ns: np.ndarray,
    Ps_gt: np.ndarray,
    caps: Optional[Tuple[int, int, int]] = None,
    gt_depths_dense: Optional[np.ndarray] = None,
    **bucket_kwargs,
) -> SceneGraph:
    graph = build_view_graph(M, Ns, caps=caps, **bucket_kwargs)
    m_cap = graph.num_cams
    m = Ps_gt.shape[0]
    Ns = np.asarray(Ns, dtype=np.float32)
    Ps_gt = np.asarray(Ps_gt, dtype=np.float32)

    Ns_pad = np.tile(np.eye(3, dtype=np.float32), (m_cap, 1, 1))
    Ns_pad[:m] = Ns
    Ns_inv_pad = np.tile(np.eye(3, dtype=np.float32), (m_cap, 1, 1))
    Ns_inv_pad[:m] = np.linalg.inv(Ns.astype(np.float64)).astype(np.float32)
    Ps_pad = np.zeros((m_cap, 3, 4), dtype=np.float32)
    Ps_pad[:m] = Ps_gt

    gt_depths = None
    if gt_depths_dense is not None:
        cam_np = np.asarray(graph.cam_idx)
        pt_np = np.asarray(graph.pt_idx)
        mask_np = np.asarray(graph.edge_mask)
        vals = np.zeros((graph.num_edges,), dtype=np.float32)
        vals[mask_np] = np.asarray(gt_depths_dense, dtype=np.float32)[
            cam_np[mask_np], pt_np[mask_np]
        ]
        gt_depths = jnp.asarray(vals)

    return SceneGraph(
        graph=graph,
        Ns=jnp.asarray(Ns_pad),
        Ns_inv=jnp.asarray(Ns_inv_pad),
        Ps_gt=jnp.asarray(Ps_pad),
        gt_depths=gt_depths,
    )
