"""The 4-way gather-broadcast edge update.

Parity surface: reference ``GraphAttnSfMProjectionFeatureUpdate``
(code/models/layers.py:873-956) / ``SetOfSetProjectionFeatureUpdate``
(layers.py:129-147): ``out_e = (pe_e + ps[pt_e] + pv[cam_e] + pg) / 4``.
Under edge partitioning the forward only gathers replicated tables and the
backward leaves shard-local partial table gradients, which the sharded
train step's trailing psum makes exact (gasfm/parallel/edge_sharding.py).
"""

from __future__ import annotations

import jax.numpy as jnp

from gasfm.graph.view_graph import ViewGraph
from gasfm.ops.segment import gather_segments


def edge_combine(
    pe: jnp.ndarray,  # (E, D) per-edge linear output
    ps: jnp.ndarray,  # (N, D) point-table linear output
    pv: jnp.ndarray,  # (M, D) camera-table linear output
    pg: jnp.ndarray,  # (1, D) global linear output
    graph: ViewGraph,
) -> jnp.ndarray:
    return (
        pe
        + gather_segments(ps, graph.pt_idx, graph.num_pts)
        + gather_segments(pv, graph.cam_idx, graph.num_cams)
        + pg
    ) / 4.0
