"""Edge-centric static-shape graph containers (the sparse substrate).

Replaces reference L5 (SparseMat + AxialAggregationGraphWrapper; reference
code/utils/sparse_utils.py, code/utils/dataset_utils.py:464-597)."""

from gasfm.graph.view_graph import (
    SceneGraph,
    ViewGraph,
    bucket_size,
    build_scene_graph,
    build_view_graph,
)

__all__ = ["SceneGraph", "ViewGraph", "bucket_size", "build_scene_graph", "build_view_graph"]
