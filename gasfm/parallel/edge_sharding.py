"""Multi-device execution: edge-partitioned view graphs over a device mesh.

The reference is single-GPU (SURVEY section 2.7); this module adds the
scaling design:

- mesh axes ``(data, edge)``: scene-level data parallelism x edge-set
  partitioning (the sequence-parallel analogue for view graphs).
- Edge arrays (observations, segment ids, masks, per-edge activations) are
  sharded along ``edge``; per-view/per-point/global feature tables are
  replicated. Segment reductions compute local partials and combine across
  shards with ``psum``/``pmax`` (see
  :mod:`gasfm.ops.segment.edge_partitioned`), which is exactly the
  numerically-stable distributed segment-softmax decomposition
  (max-exchange before exp).
- Gradients: the interior/final transpose rules of
  :mod:`gasfm.ops.segment` (interior table reductions psum their
  cotangents — capturing cross-shard gradient coupling — while the final
  loss reduction delivers the replicated seed unchanged) make each shard's
  backward pass an exact shard-local partial; a final ``psum`` over both
  axes yields the exact global gradient for ANY edge sharding; the
  optimizer update then runs replicated.

The sharded train step is numerically identical to the single-device step —
asserted by tests/test_parallel.py on a virtual 8-device CPU mesh.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax.sharding import Mesh, PartitionSpec as P

from gasfm.graph.view_graph import SceneGraph, ViewGraph
from gasfm.losses import get_loss_func
from gasfm.ops.segment import edge_partitioned, table_sharded
from gasfm.train.state import build_optimizer
from gasfm.train.state import apply_param_updates

DATA_AXIS = "data"
EDGE_AXIS = "edge"

# ViewGraph fields whose leading dimension is the edge capacity.
_EDGE_FIELDS = {"uv", "cam_idx", "pt_idx", "edge_mask", "pt_window"}
_SCALAR_FIELDS = {"m_true", "n_true", "e_true"}


def check_edge_shard_contract(num_edges: int, mesh: Mesh,
                              chunk: Optional[int] = None) -> None:
    """Enforce the bucketizer's shard-alignment contract at runtime.

    Every edge shard must be a whole number of CHUNKs: the edge cap must be
    divisible by n_edge_shards * CHUNK, so each shard's slice keeps whole
    point-window chunks (compute_owned_points reads one window id per
    chunk). Gradients are exact for any sharding (the interior psum
    transpose in gasfm/ops/segment.py —
    tests/test_parallel.py::TestSubChunkShardGradients).
    """
    from gasfm.graph.view_graph import CHUNK as _DEFAULT_CHUNK

    CHUNK = _DEFAULT_CHUNK if chunk is None else chunk
    n_edge = mesh.shape[EDGE_AXIS]
    if n_edge <= 1:
        return
    if num_edges % (n_edge * CHUNK) != 0:
        raise ValueError(
            f"edge capacity {num_edges} is not divisible by n_edge_shards * "
            f"CHUNK = {n_edge} * {CHUNK}: each edge shard must be a whole "
            f"number of CHUNKs (pin caps via GraphBucketizer / "
            f"blocked_edge_count, edge_multiple={n_edge * CHUNK})"
        )


def compute_owned_points(graph: ViewGraph, axis: str) -> jnp.ndarray:
    """Per-shard OWNED point-row mask for table sharding (inside shard_map).

    Each edge shard's chunks touch a contiguous window range
    [wb[0], wb[-1]]; a boundary window shared with the LEFT neighbor is
    owned by that neighbor (lower shard index owns shared windows), so
    every valid point row is owned by exactly one shard. Costs one scalar
    ppermute. Used by the point->global pool (each shard pools its owned
    rows, triples combine across shards) and by the masked psum that
    assembles full-table outputs (pts3D) once per step. Each touched window
    has exactly one owner however many shards its edges span.
    """
    from gasfm.graph.view_graph import WINDOW

    wb = graph.pt_window.reshape(-1, graph.chunk)[:, 0]
    first_w, last_w = wb[0], wb[-1]
    idx = jax.lax.axis_index(axis)
    n = jax.lax.axis_size(axis)
    right_perm = [(i, (i + 1) % n) for i in range(n)]
    left_last = jax.lax.ppermute(last_w, axis, right_perm)
    shared_left = jnp.logical_and(idx > 0, left_last == first_w)
    n_blocks = graph.pt_block_visited.shape[0]
    win = jnp.arange(n_blocks, dtype=jnp.int32)
    touched = jnp.logical_and(win >= first_w, win <= last_w)
    owned_w = jnp.logical_and(
        touched, jnp.logical_not(jnp.logical_and(win == first_w, shared_left))
    )
    return jnp.repeat(owned_w, WINDOW)[: graph.num_pts]


def make_mesh(n_edge: int, n_data: int = 1, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    assert len(devices) >= n_edge * n_data, (
        f"need {n_edge * n_data} devices, have {len(devices)}"
    )
    dev_array = np.asarray(devices[: n_edge * n_data]).reshape(n_data, n_edge)
    return Mesh(dev_array, axis_names=(DATA_AXIS, EDGE_AXIS))


def _graph_specs(batched: bool, chunk: Optional[int] = None) -> ViewGraph:
    lead = (DATA_AXIS,) if batched else ()

    def spec(field: str):
        if field in _SCALAR_FIELDS:
            return P(*lead)
        if field in _EDGE_FIELDS:
            return P(*lead, EDGE_AXIS)
        return P(*lead)  # per-view / per-point tables: replicated over edge

    kwargs = {
        f.name: spec(f.name)
        for f in dataclasses.fields(ViewGraph) if f.name != "chunk"
    }
    # The spec pytree's STATIC metadata (ViewGraph.chunk) must match the
    # argument graph's, or shard_map's treedef comparison fails.
    from gasfm.graph.view_graph import CHUNK as _DEFAULT_CHUNK

    return ViewGraph(**kwargs, chunk=_DEFAULT_CHUNK if chunk is None else chunk)


def scene_graph_specs(batched: bool = True, has_depths: bool = False,
                      chunk: Optional[int] = None) -> SceneGraph:
    """PartitionSpec pytree matching a (stacked) SceneGraph."""
    lead = (DATA_AXIS,) if batched else ()
    return SceneGraph(
        graph=_graph_specs(batched, chunk=chunk),
        Ns=P(*lead),
        Ns_inv=P(*lead),
        Ps_gt=P(*lead),
        gt_depths=P(*lead, EDGE_AXIS) if has_depths else None,
    )


def stack_scene_graphs(scenes: List[SceneGraph]) -> SceneGraph:
    """Stack same-capacity SceneGraphs along a new leading batch axis."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs, axis=0), *scenes)


def initialize_distributed(conf) -> bool:
    """Multi-host runtime startup: ``jax.distributed.initialize`` driven by
    conf keys (single-process no-op unless enabled).

    The reference has no communication backend at all (single process,
    single GPU — SURVEY section 2.7); here one process per host joins all
    hosts into one XLA runtime so a global ``Mesh`` can span every device.

    conf keys (``parallel.distributed``):
      enabled             bool (default false)
      coordinator_address "host:port" (default: JAX auto-detection)
      num_processes       int (default: auto)
      process_id          int (default: auto)

    Returns True iff ``jax.distributed.initialize`` was called.
    """
    import jax

    if not conf.get_bool("parallel.distributed.enabled", default=False):
        return False
    kwargs = {}
    addr = conf.get_string("parallel.distributed.coordinator_address", default=None)
    if addr is not None:
        kwargs["coordinator_address"] = addr
    n_proc = conf.get_int("parallel.distributed.num_processes", default=None)
    if n_proc is not None:
        kwargs["num_processes"] = n_proc
    pid = conf.get_int("parallel.distributed.process_id", default=None)
    if pid is not None:
        kwargs["process_id"] = pid
    jax.distributed.initialize(**kwargs)
    print(
        f"[distributed] initialized: process {jax.process_index()}/{jax.process_count()}, "
        f"{len(jax.local_devices())} local / {len(jax.devices())} global devices"
    )
    return True


def mesh_from_conf(conf) -> Optional[Mesh]:
    """Build the (data, edge) mesh from ``parallel.mesh_shape = [d, e]``.

    Returns None when no mesh is configured or it is the trivial [1, 1].
    Asserts there are enough devices (global — spans all hosts after
    :func:`initialize_distributed`).
    """
    shape = conf.get_list("parallel.mesh_shape", default=None)
    if shape is None:
        return None
    assert len(shape) == 2, f"parallel.mesh_shape must be [data, edge], got {shape}"
    n_data, n_edge = int(shape[0]), int(shape[1])
    if n_data * n_edge <= 1:
        return None
    return make_mesh(n_edge=n_edge, n_data=n_data)


def pad_scene_group(
    scenes: List[SceneGraph], n_data: int
) -> Tuple[SceneGraph, np.ndarray]:
    """Stack <= n_data same-capacity scenes into an n_data-slot batch.

    Short groups are padded by repeating the last scene with WEIGHT 0: the
    sharded step multiplies each slot's loss by its weight before the psum,
    so padded slots contribute exactly zero to loss and gradients — any
    valid-sample count runs through one compiled program per capacity
    bucket, with numerics identical to the unpadded batch.
    """
    assert 1 <= len(scenes) <= n_data
    weights = np.zeros((n_data,), dtype=np.float32)
    weights[: len(scenes)] = 1.0
    padded = list(scenes) + [scenes[-1]] * (n_data - len(scenes))
    return stack_scene_graphs(padded), weights


def _table_shard_ctx(conf, graph):
    """Enter the table-sharding context (owned-point mask) when
    ``parallel.table_sharding`` is on; no-op context otherwise.

    Default: ON whenever the edge axis is really sharded;
    ``parallel.table_sharding = false`` pools the replicated point table
    on every shard instead."""
    enabled = conf.get_bool("parallel.table_sharding", default=None)
    if enabled is None:
        enabled = jax.lax.axis_size(EDGE_AXIS) > 1
    if enabled:
        return table_sharded(compute_owned_points(graph, EDGE_AXIS))
    return contextlib.nullcontext()


def _combine_table_outputs(conf, pred):
    """Under table sharding, ONE masked psum over the owned rows assembles
    the point-table output (pts3D) for consumers outside the step (host
    metrics, eval). Camera tables (Ps_norm) and per-edge outputs are
    already consistent."""
    from gasfm.ops.segment import table_shard_owned

    own = table_shard_owned()
    if own is None or "pts3D" not in pred:
        return pred
    pred = dict(pred)
    pred["pts3D"] = jax.lax.psum(
        jnp.where(own[None, :], pred["pts3D"], 0.0), EDGE_AXIS
    )
    return pred


def make_sharded_fused_step(conf, model, mesh: Mesh, tx=None):
    """The production multi-chip train step (drop-in for the single-chip
    ``TrainingSession`` fused step).

    step(params, opt_state, batched_scene, weights) ->
        (params, opt_state, loss_sum, repro_sum, n_valid, grad_norm)

    ``batched_scene`` leading dim == data-axis size; ``weights`` (n_data,)
    are per-slot loss weights (see :func:`pad_scene_group`). Losses/metrics
    are weight-summed over slots (the reference's ``batch_loss``
    accumulation, train.py:61-88); gradients are exact global gradients of
    the weighted sum; the Adam update runs replicated.

    ``tx`` overrides the optimizer (the trainer passes its milestone-shifted
    one); defaults to ``build_optimizer(conf)``.
    """
    import optax as _optax

    from gasfm.eval.metrics import core_errors_device

    loss_func = get_loss_func(conf)
    if tx is None:
        tx, _ = build_optimizer(conf)
    # our_repro needs the explicit heads' outputs (Ps_norm, pts3D); a
    # depth-head-only config would KeyError at trace time — mirror the
    # single-chip `device_metrics = explicit and ...` gate (train/loop.py)
    # by reporting 0 instead.
    explicit = (conf.get_bool("model.view_head.enabled", default=False)
                and conf.get_bool("model.scenepoint_head.enabled", default=False))

    def per_device(params, opt_state, scene, weight):
        scene = jax.tree_util.tree_map(lambda x: x[0], scene)
        w = weight[0]
        with edge_partitioned(EDGE_AXIS), _table_shard_ctx(conf, scene.graph):
            def loss_fn(p):
                pred = model.apply(p, scene.graph)
                return loss_func(pred, scene) * w, pred

            (loss, pred), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            repro = (core_errors_device(pred, scene)["our_repro"] * w
                     if explicit else jnp.zeros_like(loss))
        loss = jax.lax.psum(loss, DATA_AXIS)
        repro = jax.lax.psum(repro, DATA_AXIS)
        n_valid = jax.lax.psum(w, DATA_AXIS)
        grads = jax.lax.psum(grads, (EDGE_AXIS, DATA_AXIS))
        grad_norm = _optax.global_norm(grads)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = apply_param_updates(params, updates, opt_state)
        return params, opt_state, loss, repro, n_valid, grad_norm

    has_depths = conf.get_bool("model.depth_head.enabled", default=False)

    @functools.lru_cache(maxsize=None)
    def _jitted(chunk):
        sharded = jax.shard_map(
            per_device,
            mesh=mesh,
            in_specs=(
                P(), P(),
                scene_graph_specs(batched=True, has_depths=has_depths,
                                  chunk=chunk),
                P(DATA_AXIS),
            ),
            out_specs=(P(), P(), P(), P(), P(), P()),
            check_vma=False,
        )
        return jax.jit(sharded, donate_argnums=(0, 1))

    def step(params, opt_state, batched_scene, weights):
        check_edge_shard_contract(batched_scene.graph.edge_mask.shape[-1], mesh,
                                  chunk=batched_scene.graph.chunk)
        return _jitted(batched_scene.graph.chunk)(
            params, opt_state, batched_scene, weights)

    def lower(params, opt_state, batched_scene, weights):
        """The step's ``jax.stages.Lowered`` for these arguments; its
        ``compile()`` reports the input and output shardings the step runs with."""
        check_edge_shard_contract(batched_scene.graph.edge_mask.shape[-1], mesh,
                                  chunk=batched_scene.graph.chunk)
        return _jitted(batched_scene.graph.chunk).lower(
            params, opt_state, batched_scene, weights)

    step.lower = lower
    return step


def make_sharded_grad_step(conf, model, mesh: Mesh):
    """Gradient-only multi-chip step for batch accumulation (batches with
    more valid samples than data-axis slots, reference train.py:61-88).

    step(params, batched_scene, weights) ->
        (loss_sum, grads, pred_batched)

    ``pred_batched`` holds every slot's padded predictions stacked on a
    leading data axis (for the host-side metric paths: outlier-injected
    scoring against clean observations, backproj metrics). No on-device
    metrics here: this step serves exactly the host-metric branches of
    epoch_train (its one caller, TrainingSession.loss_and_grads), which
    recompute metrics from ``pred``, so on-device metrics here would be
    wasted device compute and collective traffic.
    """
    loss_func = get_loss_func(conf)

    def per_device(params, scene, weight):
        scene = jax.tree_util.tree_map(lambda x: x[0], scene)
        w = weight[0]
        with edge_partitioned(EDGE_AXIS), _table_shard_ctx(conf, scene.graph):
            def loss_fn(p):
                pred = model.apply(p, scene.graph)
                return loss_func(pred, scene) * w, pred

            (loss, pred), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            pred = _combine_table_outputs(conf, pred)
        loss = jax.lax.psum(loss, DATA_AXIS)
        grads = jax.lax.psum(grads, (EDGE_AXIS, DATA_AXIS))
        # Expose each slot's padded predictions: lift a leading singleton
        # axis so the P(DATA_AXIS) out-spec stacks slots into a leading
        # (n_data, ...) batch dim. Table outputs (Ps_norm, pts3D) are
        # replicated over the edge axis; the depth head's per-edge output
        # stays edge-sharded and reassembles to the full (n_data, E).
        pred = jax.tree_util.tree_map(lambda x: x[None], pred)
        return loss, grads, pred

    has_depths = conf.get_bool("model.depth_head.enabled", default=False)
    pred_specs = {}
    if conf.get_bool("model.view_head.enabled", default=False):
        pred_specs["Ps_norm"] = P(DATA_AXIS)
    if conf.get_bool("model.scenepoint_head.enabled", default=False):
        pred_specs["pts3D"] = P(DATA_AXIS)
    if has_depths:
        pred_specs["depths"] = P(DATA_AXIS, EDGE_AXIS)

    @functools.lru_cache(maxsize=None)
    def _jitted(chunk):
        sharded = jax.shard_map(
            per_device,
            mesh=mesh,
            in_specs=(
                P(),
                scene_graph_specs(batched=True, has_depths=has_depths,
                                  chunk=chunk),
                P(DATA_AXIS),
            ),
            out_specs=(P(), P(), pred_specs),
            check_vma=False,
        )
        return jax.jit(sharded)

    def step(params, batched_scene, weights):
        check_edge_shard_contract(batched_scene.graph.edge_mask.shape[-1], mesh,
                                  chunk=batched_scene.graph.chunk)
        return _jitted(batched_scene.graph.chunk)(params, batched_scene, weights)

    return step


def make_sharded_train_step(conf, model, mesh: Mesh):
    """Build the jitted multi-chip train step.

    step(params, opt_state, batched_scene) -> (params, opt_state, loss)
    where batched_scene has a leading batch dim equal to the data-axis size.
    Losses are summed over the batch (the reference's batch accumulation,
    train.py:61-88) and gradients are exact global gradients.
    """
    loss_func = get_loss_func(conf)
    tx, _ = build_optimizer(conf)

    def per_device(params, opt_state, scene):
        # Local batch is 1 (one scene per data-group); drop the batch dim.
        scene = jax.tree_util.tree_map(lambda x: x[0], scene)
        with edge_partitioned(EDGE_AXIS), _table_shard_ctx(conf, scene.graph):
            def loss_fn(p):
                pred = model.apply(p, scene.graph)
                return loss_func(pred, scene)

            loss, grads = jax.value_and_grad(loss_fn)(params)
        # Sum losses over scenes (data axis); combine partial grads over both.
        loss = jax.lax.psum(loss, DATA_AXIS)
        grads = jax.lax.psum(grads, (EDGE_AXIS, DATA_AXIS))
        updates, opt_state = tx.update(grads, opt_state, params)
        params = apply_param_updates(params, updates, opt_state)
        return params, opt_state, loss

    has_depths = conf.get_bool("model.depth_head.enabled", default=False)

    @functools.lru_cache(maxsize=None)
    def _jitted(chunk):
        sharded = jax.shard_map(
            per_device,
            mesh=mesh,
            in_specs=(P(), P(),
                      scene_graph_specs(batched=True, has_depths=has_depths,
                                        chunk=chunk)),
            out_specs=(P(), P(), P()),
            check_vma=False,
        )
        return jax.jit(sharded, donate_argnums=(0, 1))

    def step(params, opt_state, batched_scene):
        check_edge_shard_contract(batched_scene.graph.edge_mask.shape[-1], mesh,
                                  chunk=batched_scene.graph.chunk)
        return _jitted(batched_scene.graph.chunk)(params, opt_state, batched_scene)

    return step


def make_sharded_forward(conf, model, mesh: Mesh, grouped: bool = False):
    """Sharded inference.

    grouped=False: every data group evaluates the SAME scene; the padded
    pred dict returns replicated.
    grouped=True: each data group evaluates ITS slot's scene and the preds
    stack on a leading (n_data, ...) axis — eval sweeps then shard their
    scene list across the data axis instead of wasting (n_data-1)/n_data of
    the mesh on replicated compute.
    """

    def per_device(params, scene):
        scene = jax.tree_util.tree_map(lambda x: x[0], scene)
        with edge_partitioned(EDGE_AXIS), _table_shard_ctx(conf, scene.graph):
            pred = model.apply(params, scene.graph)
            pred = _combine_table_outputs(conf, pred)
        # Per-edge outputs (depth head) stay sharded; table outputs replicated
        # over the edge axis.
        if grouped:
            pred = jax.tree_util.tree_map(lambda x: x[None], pred)
        return pred

    has_depths = conf.get_bool("model.depth_head.enabled", default=False)
    lead = (DATA_AXIS,) if grouped else ()
    out_specs = {"Ps_norm": P(*lead), "pts3D": P(*lead)}
    if has_depths:
        out_specs["depths"] = P(*lead, EDGE_AXIS)
    if conf.get_bool("model.view_head.enabled", default=False) is False:
        out_specs.pop("Ps_norm", None)
    if conf.get_bool("model.scenepoint_head.enabled", default=False) is False:
        out_specs.pop("pts3D", None)

    @functools.lru_cache(maxsize=None)
    def _jitted(chunk):
        sharded = jax.shard_map(
            per_device,
            mesh=mesh,
            in_specs=(P(), scene_graph_specs(batched=True, has_depths=has_depths,
                                             chunk=chunk)),
            out_specs=out_specs,
            check_vma=False,
        )
        return jax.jit(sharded)

    def forward(params, batched_scene):
        check_edge_shard_contract(batched_scene.graph.edge_mask.shape[-1], mesh,
                                  chunk=batched_scene.graph.chunk)
        return _jitted(batched_scene.graph.chunk)(params, batched_scene)

    return forward
