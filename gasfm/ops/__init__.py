"""Compute ops: masked segment reductions, segment-softmax attention."""

from gasfm.ops.gatv2 import gatv2_attend
from gasfm.ops.segment import (
    gather_segments,
    masked_mean,
    segment_count,
    segment_max,
    segment_mean,
    segment_softmax,
    segment_sum,
)

__all__ = [
    "gatv2_attend",
    "gather_segments",
    "masked_mean",
    "segment_count",
    "segment_max",
    "segment_mean",
    "segment_softmax",
    "segment_sum",
]
