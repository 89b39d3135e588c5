"""Parallel layer: device meshes, edge-partitioned sharded train/eval steps.

The reference has no distributed execution (SURVEY section 2.7)."""

from gasfm.parallel.edge_sharding import (
    DATA_AXIS,
    EDGE_AXIS,
    initialize_distributed,
    make_mesh,
    compute_owned_points,
    make_sharded_forward,
    make_sharded_fused_step,
    make_sharded_grad_step,
    make_sharded_train_step,
    mesh_from_conf,
    pad_scene_group,
    scene_graph_specs,
    stack_scene_graphs,
)

__all__ = [
    "DATA_AXIS",
    "EDGE_AXIS",
    "initialize_distributed",
    "make_mesh",
    "compute_owned_points",
    "make_sharded_forward",
    "make_sharded_fused_step",
    "make_sharded_grad_step",
    "make_sharded_train_step",
    "mesh_from_conf",
    "pad_scene_group",
    "scene_graph_specs",
    "stack_scene_graphs",
]
