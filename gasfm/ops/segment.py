"""Masked segment reductions over padded edge arrays.

Every aggregation in both model families decomposes into the ops here (see reference L5,
code/utils/sparse_utils.py — ``sparse_mean`` etc. — and the PyG
scatter/segment-softmax kernels behind GATv2Conv).

Conventions (shared with :mod:`gasfm.graph`):
- Padded edges carry segment id == num_segments (one past the last valid
  segment) and are dropped by XLA's scatter-add out-of-bounds semantics; an
  explicit ``edge_mask`` can additionally be supplied for safety with
  non-finite padding data.
- Empty segments produce 0 for sum/mean/weighted ops (matching the
  ``to_dense()`` of the reference's sparse results) and ``-inf`` masked to 0
  for max unless requested otherwise.

They lower to XLA's scatter (atomic adds/max on a GPU) and gather, the
same design as the torch-scatter kernels behind the reference.
"""

from __future__ import annotations

import contextlib
import contextvars
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp


# ---------------------------------------------------------------------------
# Edge-partitioned execution context
#
# When tracing inside a shard_map over an "edge" mesh axis, each device holds
# a contiguous shard of the edge arrays while the per-view/per-point/global
# tables are replicated. Setting the context makes every cross-edge reduction
# in this module finish with the matching XLA collective (psum / pmax over
# the edge axis), which is exactly the distributed-segment-softmax recipe of
# SURVEY section 5 (partial max / exp-sum / weighted-sum triples combined
# across devices).
# ---------------------------------------------------------------------------

_EDGE_AXIS: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "gasfm_edge_axis", default=None
)


@contextlib.contextmanager
def edge_partitioned(axis_name: str):
    """Enable edge-axis collectives for reductions traced in this scope."""
    token = _EDGE_AXIS.set(axis_name)
    try:
        yield
    finally:
        _EDGE_AXIS.reset(token)


def current_edge_axis() -> Optional[str]:
    return _EDGE_AXIS.get()


#: Table-sharding context: when set, the point->global pool reduces the
#: rows each shard owns and combines its softmax triple across shards, and
#: outputs gathering the full point table pay ONE masked psum per step.
#: Holds the (N,) bool OWNED-rows mask computed per shard by
#: parallel.edge_sharding.compute_owned_points.
_TABLE_SHARD_OWNED: contextvars.ContextVar[Optional[jnp.ndarray]] = (
    contextvars.ContextVar("gasfm_table_shard_owned", default=None)
)


@contextlib.contextmanager
def table_sharded(owned_pts: jnp.ndarray):
    token = _TABLE_SHARD_OWNED.set(owned_pts)
    try:
        yield
    finally:
        _TABLE_SHARD_OWNED.reset(token)


def table_shard_owned() -> Optional[jnp.ndarray]:
    """The owned point-row mask, or None when table sharding is off."""
    return _TABLE_SHARD_OWNED.get()


def is_table_sharded() -> bool:
    return _TABLE_SHARD_OWNED.get() is not None


@contextlib.contextmanager
def edge_replicated():
    """Temporarily disable edge-axis collectives: for reductions over
    *replicated* per-view/per-point tables (e.g. the view->global and
    point->global attention pools), where a psum would double-count by the
    number of edge shards."""
    token = _EDGE_AXIS.set(None)
    try:
        yield
    finally:
        _EDGE_AXIS.reset(token)


# ---------------------------------------------------------------------------
# Gradient transposes of the edge-shard collectives
#
# Two reduction flavors with DIFFERENT exact transposes, distinguished by how
# the reduction's *output cotangent* arrives during the per-shard backward
# (this is exactly shard_map's varying/invariant bookkeeping, done manually
# because the train steps run with check_vma=False):
#
# - ``all_sum`` (INTERIOR: view/point/global tables consumed downstream by
#   per-edge gathers/broadcasts). The output cotangent on shard i is a
#   shard-local PARTIAL (assembled from shard i's edges via the gather
#   transposes). The exact transpose must deliver the FULL cotangent
#   ``psum_j(partial_j)`` to the shard-local summand: an edge's features
#   influence the table row once, and the row influences EVERY shard's
#   downstream edges. Dropping the psum here (an identity transpose, the
#   round-3 rule) keeps only the "diagonal" gradient paths — loss edges on
#   shard i backing onto upstream edges of shard i — and silently loses all
#   cross-shard coupling: measured 93/162 corrupted leaves (up to 58%
#   relative) the moment a scene's valid edges span more than one shard
#   (tests/test_parallel.py::TestCrossShardGradients).
#
# - ``all_sum_final`` (FINAL: the loss/metric scalars, consumed invariantly
#   or returned). The output cotangent is the REPLICATED seed — identical on
#   every shard, not a partial — so the exact transpose delivers it
#   UNCHANGED. Re-psumming it (jax's native psum transpose, the round-1
#   rule) scales every upstream gradient by the edge-shard count.
#
# With interior=psum-of-partials and final=identity, every parameter
# gradient leaves the per-shard backward as a shard-local partial, and the
# train steps' single trailing ``psum(grads, edge_axis)`` is exact for ANY
# edge sharding — chunk-aligned or not.
# ---------------------------------------------------------------------------


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def _psum_interior(x, axis):
    return jax.lax.psum(x, axis)


def _psum_interior_fwd(x, axis):
    return jax.lax.psum(x, axis), None


def _psum_interior_bwd(axis, _, g):
    # Partial cotangents in -> full cotangent delivered to the local summand.
    return (jax.lax.psum(g, axis),)


_psum_interior.defvjp(_psum_interior_fwd, _psum_interior_bwd)


@partial(jax.custom_vjp, nondiff_argnums=(1,))
def _psum_replicated(x, axis):
    return jax.lax.psum(x, axis)


def _psum_replicated_fwd(x, axis):
    return jax.lax.psum(x, axis), None


def _psum_replicated_bwd(axis, _, g):
    # Replicated (seed) cotangent in -> delivered unchanged.
    return (g,)


_psum_replicated.defvjp(_psum_replicated_fwd, _psum_replicated_bwd)


def all_sum(x: jnp.ndarray) -> jnp.ndarray:
    """Interior cross-shard sum (identity outside edge-partitioned scope):
    for reductions whose output feeds back into per-edge computation. See
    the transpose discussion above."""
    axis = _EDGE_AXIS.get()
    return x if axis is None else _psum_interior(x, axis)


def all_sum_final(x: jnp.ndarray) -> jnp.ndarray:
    """Final cross-shard sum: for loss/metric scalars whose cotangent is the
    replicated seed (or that are not differentiated at all). See above."""
    axis = _EDGE_AXIS.get()
    return x if axis is None else _psum_replicated(x, axis)


def _all_max(x: jnp.ndarray) -> jnp.ndarray:
    axis = _EDGE_AXIS.get()
    return x if axis is None else jax.lax.pmax(x, axis)


def _mask_data(data: jnp.ndarray, edge_mask: Optional[jnp.ndarray]) -> jnp.ndarray:
    if edge_mask is None:
        return data
    shape = edge_mask.shape + (1,) * (data.ndim - 1)
    return jnp.where(edge_mask.reshape(shape), data, jnp.zeros_like(data))


def segment_sum(
    data: jnp.ndarray,
    seg_ids: jnp.ndarray,
    num_segments: int,
    edge_mask: Optional[jnp.ndarray] = None,
    indices_are_sorted: bool = False,
) -> jnp.ndarray:
    """Sum of `data` rows per segment. Out-of-range ids are dropped."""
    data = _mask_data(data, edge_mask)
    return all_sum(jax.ops.segment_sum(
        data, seg_ids, num_segments=num_segments, indices_are_sorted=indices_are_sorted
    ))


def segment_count(
    seg_ids: jnp.ndarray,
    num_segments: int,
    edge_mask: Optional[jnp.ndarray] = None,
    indices_are_sorted: bool = False,
    dtype=jnp.float32,
) -> jnp.ndarray:
    ones = jnp.ones(seg_ids.shape, dtype=dtype)
    return segment_sum(ones, seg_ids, num_segments, edge_mask, indices_are_sorted)


def segment_mean(
    data: jnp.ndarray,
    seg_ids: jnp.ndarray,
    num_segments: int,
    edge_mask: Optional[jnp.ndarray] = None,
    indices_are_sorted: bool = False,
) -> jnp.ndarray:
    """Empty-aware mean: empty segments yield 0.

    Parity: reference ``sparse_mean`` (code/utils/sparse_utils.py:91-131)
    whose sparse result densifies to 0 at empty rows/columns.
    """
    s = segment_sum(data, seg_ids, num_segments, edge_mask, indices_are_sorted)
    cnt = segment_count(seg_ids, num_segments, edge_mask, indices_are_sorted, dtype=s.dtype)
    cnt = cnt.reshape(cnt.shape + (1,) * (s.ndim - 1))
    return jnp.where(cnt > 0, s / jnp.maximum(cnt, 1.0), jnp.zeros_like(s))


def segment_max(
    data: jnp.ndarray,
    seg_ids: jnp.ndarray,
    num_segments: int,
    edge_mask: Optional[jnp.ndarray] = None,
    indices_are_sorted: bool = False,
    neutral: float = -jnp.inf,
) -> jnp.ndarray:
    """Max per segment; empty segments (and values <= -1e30) yield `neutral`."""
    if edge_mask is not None:
        shape = edge_mask.shape + (1,) * (data.ndim - 1)
        data = jnp.where(edge_mask.reshape(shape), data, jnp.full_like(data, neutral))
    out = jax.ops.segment_max(
        data, seg_ids, num_segments=num_segments, indices_are_sorted=indices_are_sorted
    )
    if jnp.issubdtype(out.dtype, jnp.floating):
        out = jnp.where(out <= -1e30, jnp.asarray(neutral, out.dtype), out)
    return _all_max(out)


def segment_softmax(
    logits: jnp.ndarray,
    seg_ids: jnp.ndarray,
    num_segments: int,
    edge_mask: Optional[jnp.ndarray] = None,
    indices_are_sorted: bool = False,
) -> jnp.ndarray:
    """Numerically-stable softmax over each segment of per-edge logits.

    logits: (E,) or (E, H). Returns weights of the same shape; padded edges
    (ids outside [0, num_segments) or masked out) get weight 0.
    """
    in_range = (seg_ids >= 0) & (seg_ids < num_segments)
    edge_mask = in_range if edge_mask is None else in_range & edge_mask
    # The max-shift cancels analytically in softmax, so stopping its gradient
    # is exact (and pmax has no differentiation rule anyway).
    m = segment_max(
        jax.lax.stop_gradient(logits), seg_ids, num_segments, edge_mask, indices_are_sorted,
    )
    m = jnp.where(jnp.isfinite(m), m, jnp.zeros_like(m))  # empty segments
    shifted = logits - jax.lax.stop_gradient(gather_segments(m, seg_ids, num_segments))
    # Valid edges have shifted <= 0 (m is their segment max); the
    # stop-gradient cap only affects masked/padded edges, whose exp would
    # otherwise overflow to inf and poison the backward with 0 * inf = NaN.
    # (A plain minimum would zero the gradient of every segment's argmax
    # edge at the 0 tie.)
    p = jnp.exp(shifted - jax.lax.stop_gradient(jnp.maximum(shifted, 0.0)))
    if edge_mask is not None:
        shape = edge_mask.shape + (1,) * (p.ndim - 1)
        p = jnp.where(edge_mask.reshape(shape), p, jnp.zeros_like(p))
    denom = segment_sum(p, seg_ids, num_segments, None, indices_are_sorted)
    denom_g = gather_segments(denom, seg_ids, num_segments)
    w = jnp.where(denom_g > 0, p / jnp.maximum(denom_g, 1e-38), jnp.zeros_like(p))
    if edge_mask is not None:
        shape = edge_mask.shape + (1,) * (w.ndim - 1)
        w = jnp.where(edge_mask.reshape(shape), w, jnp.zeros_like(w))
    return w


def gather_segments(
    table: jnp.ndarray,
    seg_ids: jnp.ndarray,
    num_segments: int,
) -> jnp.ndarray:
    """Broadcast per-segment rows back to edges. Padded ids clip to the last
    row; consumers mask them."""
    return table[seg_ids.clip(0, num_segments - 1)]


def masked_mean(data: jnp.ndarray, mask: jnp.ndarray, axis=0) -> jnp.ndarray:
    """Mean over `axis` counting only mask-true rows; 0 if none."""
    shape = mask.shape + (1,) * (data.ndim - mask.ndim)
    m = mask.reshape(shape).astype(data.dtype)
    s = all_sum(jnp.sum(data * m, axis=axis))
    cnt = all_sum(jnp.sum(m, axis=axis))
    return jnp.where(cnt > 0, s / jnp.maximum(cnt, 1.0), jnp.zeros_like(s))
