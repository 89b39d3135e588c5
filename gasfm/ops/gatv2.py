"""Functional GATv2-style segment attention core.

Semantics match PyG ``GATv2Conv(add_self_loops=False, share_weights=False,
concat=True)`` as used by the reference (code/models/layers.py:304-309,
401-406, 506-526) restricted to the star graphs the reference builds: all
source nodes of a segment attend into one aggregation node.

Given per-edge source features already transformed by the source linear map
(``xl``) and per-segment query features transformed by the target linear map
(``xr``), one attention head computes

    score_e = att_h . LeakyReLU(xl_e + xr_seg(e), 0.2)
    alpha   = segment_softmax(score)
    out_s   = sum_e alpha_e * xl_e

All segment scatters/gathers run on flat 2D ``(rows, H*C)`` arrays, and the
softmax numerator and denominator share ONE wide segment-sum over
``(E, H*C + H)``, so the hot path holds a single scatter-add (plus the
stop-gradient segment-max for stability).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from gasfm.ops.segment import all_sum, gather_segments, segment_max, segment_sum


def gatv2_attend_pool(
    xl: jnp.ndarray,  # (E, H, C) transformed source features
    xr0: jnp.ndarray,  # (1, H, C) transformed query features of THE segment
    att: jnp.ndarray,  # (H, C) attention vectors
    row_mask: jnp.ndarray,  # (E,) valid-source mask
    negative_slope: float = 0.2,
) -> jnp.ndarray:
    """Single-segment specialization of :func:`gatv2_attend`: every valid row
    attends into one aggregation node (the reference's view->global and
    point->global star graphs, code/models/layers.py:538-603).

    With one segment the softmax is an ordinary masked softmax over rows and
    the weighted aggregation is one matmul, so both forward AND backward are
    dense ops with no scatter."""
    E, H, C = xl.shape
    g = xl + xr0.reshape(1, H, C)
    g = jnp.where(g >= 0, g, negative_slope * g)  # LeakyReLU(0.2)
    logits = jnp.sum(g * att[None, :, :], axis=-1)  # (E, H)
    logits = jnp.where(row_mask[:, None], logits, -jnp.inf)
    m = jax.lax.stop_gradient(jnp.max(logits, axis=0))  # (H,)
    m = jnp.where(jnp.isfinite(m), m, jnp.zeros_like(m))
    p = jnp.exp(logits - m[None, :])
    p = jnp.where(row_mask[:, None], p, jnp.zeros_like(p))
    den = jnp.sum(p, axis=0)  # (H,)
    num = jnp.einsum("eh,ehc->hc", p, xl)  # (H, C), one matmul per head
    den = jnp.where(den > 0, den, jnp.ones_like(den))
    return (num / den[:, None])[None]  # (1, H, C)


def gatv2_attend_pool_sharded(
    xl: jnp.ndarray,  # (E, H, C) local table rows' transformed features
    xr0: jnp.ndarray,  # (1, H, C)
    att: jnp.ndarray,  # (H, C)
    row_mask: jnp.ndarray,  # (E,) valid AND owned-by-this-shard rows
    axis: str,
    negative_slope: float = 0.2,
) -> jnp.ndarray:
    """Table-sharded variant of :func:`gatv2_attend_pool`: each shard pools
    its OWNED table rows and the per-head softmax triples (max, exp-sum,
    weighted sum) combine across the edge axis — O(H*C) collective volume
    instead of pooling a replicated full table. Gradients follow the
    interior transpose rule (all_sum psums the partial cotangents)."""
    E, H, C = xl.shape
    g = xl + xr0.reshape(1, H, C)
    g = jnp.where(g >= 0, g, negative_slope * g)
    logits = jnp.sum(g * att[None, :, :], axis=-1)  # (E, H)
    logits = jnp.where(row_mask[:, None], logits, -jnp.inf)
    m = jax.lax.stop_gradient(jnp.max(logits, axis=0))
    m = jnp.where(jnp.isfinite(m), m, jnp.zeros_like(m))
    m = jax.lax.stop_gradient(jax.lax.pmax(m, axis))  # global shift
    p = jnp.exp(logits - m[None, :])
    p = jnp.where(row_mask[:, None], p, jnp.zeros_like(p))
    den = all_sum(jnp.sum(p, axis=0))  # (H,) global
    num = all_sum(jnp.einsum("eh,ehc->hc", p, xl))  # (H, C) global
    den = jnp.where(den > 0, den, jnp.ones_like(den))
    return (num / den[:, None])[None]


def gatv2_attend(
    xl: jnp.ndarray,  # (E, H, C) transformed source features
    xr: jnp.ndarray,  # (S, H, C) transformed per-segment query features
    att: jnp.ndarray,  # (H, C) attention vectors
    seg_ids: jnp.ndarray,  # (E,) target segment per edge (num_segments = trash)
    num_segments: int,
    edge_mask: Optional[jnp.ndarray] = None,
    indices_are_sorted: bool = False,
    negative_slope: float = 0.2,
) -> jnp.ndarray:
    """Returns (S, H, C) attention-aggregated source features per segment."""
    E, H, C = xl.shape
    xl2 = xl.reshape(E, H * C)
    xr2 = xr.reshape(num_segments, H * C)
    g2 = xl2 + gather_segments(xr2, seg_ids, num_segments)  # (E, H*C)
    g2 = jnp.where(g2 >= 0, g2, negative_slope * g2)  # LeakyReLU(0.2)
    logits = jnp.sum(g2.reshape(E, H, C) * att[None, :, :], axis=-1)  # (E, H)

    # Stable softmax: per-segment max (exactly zero-gradient; see
    # segment_softmax) computed on the narrow (E, H) array.
    m = segment_max(
        jax.lax.stop_gradient(logits), seg_ids, num_segments, edge_mask, indices_are_sorted,
    )
    m = jnp.where(jnp.isfinite(m), m, jnp.zeros_like(m))
    m_e = jax.lax.stop_gradient(gather_segments(m, seg_ids, num_segments))
    # Valid edges have logits <= their segment max; the stop-gradient cap
    # only affects masked/padded edges, whose exp would otherwise overflow to
    # inf and poison the backward with 0 * inf = NaN. (A plain minimum would
    # zero the gradient of every segment's argmax edge at the 0 tie.)
    shifted = logits - m_e
    p = jnp.exp(shifted - jax.lax.stop_gradient(jnp.maximum(shifted, 0.0)))  # (E, H)
    if edge_mask is not None:
        p = jnp.where(edge_mask[:, None], p, jnp.zeros_like(p))

    # One fused wide segment-sum: [weighted features | softmax denominators].
    weighted = (p[:, :, None] * xl.reshape(E, H, C)).reshape(E, H * C)
    packed = jnp.concatenate([weighted, p], axis=1)  # (E, H*C + H)
    sums = segment_sum(packed, seg_ids, num_segments, edge_mask, indices_are_sorted)
    num = sums[:, : H * C].reshape(num_segments, H, C)
    den = sums[:, H * C :]  # (S, H)
    den = jnp.where(den > 0, den, jnp.ones_like(den))
    return num / den[:, :, None]
