"""Smoke test of the main path on an NVIDIA GPU.

    python chip_smoke.py            # one GPU: device, optim, learning, reference
    python chip_smoke.py --multi    # four GPUs: the edge-sharded step only

Phases, all in this one process (a JAX process holds most of a card's memory,
so no second one is started):

- device: refuse anything but a GPU; print the device, versions, the card's
  name and power limit, and the compile-cache directory.
- optim: ``gasfm.main`` single-scene-optim at the published widths
  (9 layers, 4 heads, 32/64/1024/2048) on a 128-view x 8192-point synthetic
  scene (~116k edges), ending in the evaluation with host BA; then the
  trainer's own fused step timed alone.
- learning: ``gasfm.main`` multi-scene-learning at the 12-layer published
  widths on 40-view x 4000-point synthetic scenes, 10-20 sampled views,
  rotation augmentation, 10% outliers, two loader worker processes.
- reference: the flagship forward pass, ESFM loss and parameter gradients
  against the same computation at highest matmul precision, and against the
  CPU backend.
- multi (``--multi`` only): one fused TrainingSession step on meshes [1, 4]
  and [2, 2] against the same step on one card.

Any failed check raises, and the exit code is then non-zero. The last line
of a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import csv
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

# The published single-scene optimization widths and learning rate
# (gasfm/confs/gasfm/optim_euc_gasfm.conf:9-25,44) and the bench scene.
FLAGSHIP = {
    "model.n_heads": 4, "model.n_feat_proj": 32, "model.n_feat_scenepoint": 64,
    "model.n_feat_view": 1024, "model.n_feat_global": 2048, "model.num_layers": 9,
    "model.view_head.n_hidden_layers": 2, "model.scenepoint_head.n_hidden_layers": 2,
    "train.lr": 1e-4,
}
BENCH_SCENE = {"n_views": 128, "n_points": 8192, "visibility": 0.2}
OPTIM_EPOCHS = 30

# Reference tolerances. Errors are norm-wise: ||a - b|| / ||b|| per array.
# - Default vs highest matmul precision on the GPU: f32 products may run in
#   TF32 (10-bit mantissa, unit roundoff 2^-11 ~ 4.9e-4), compounded over 9
#   layers of 1024/2048-wide products and LayerNorms. Outputs and loss carry
#   a few such roundings; gradients more (the backward doubles the chain).
TOL_TF32 = {"loss": 1e-2, "outputs": 5e-2, "grads": 1e-1}
# - GPU vs CPU, both float32 at highest precision: only the summation order
#   differs (atomic scatter-adds on the GPU), ~1e-6 per sum, amplified by the
#   depth and by the softmaxes.
TOL_CPU = {"loss": 1e-4, "outputs": 1e-3, "grads": 1e-2}
# - Mesh vs one card, same precision: psum partial sums reorder the
#   segment reductions; the step is otherwise the same program. Adam's
#   second moment after one step is 0.001 * gradient^2, so its relative
#   error is twice the gradient's. Adam's first step moves each parameter by
#   lr * g / (|g| + 1e-8), about lr * sign(g), so two updates differ only
#   where a gradient's sign differs. The update is compared where the
#   gradient stands clear of the reordering noise, which scales with each
#   leaf: |g| above 1e-6 and above a tenth of its leaf's RMS. "update"
#   (norm-wise over those entries) lets 0.25% of them flip, where a wrong
#   gradient flips about half, an error of about 1.4.
TOL_MESH = {"loss": 1e-3, "grads": 1e-2, "nu": 2e-2, "update": 1e-1}
SURE_GRAD = 1e-6
# - The four cards' peak memory in a mesh step, as 1 - min/max: every card
#   runs the same program on an equal slice of the edges.
TOL_SPREAD = 0.2


def _p(*args):
    print(*args, flush=True)


def overrides(d):
    return [f"{k}={json.dumps(v)}" for k, v in d.items()]


def rel_err(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def worst_leaf_err(ga, gb, floor: float = 1e-3):
    """Worst per-leaf norm-wise gradient error. A leaf's norm is floored at
    ``floor`` times the largest leaf norm, so leaves whose gradient is
    ~0 in both runs do not divide by ~0."""
    import jax

    la = jax.tree_util.tree_leaves_with_path(ga)
    lb = jax.tree_util.tree_leaves(gb)
    top = max(float(np.linalg.norm(np.asarray(x, np.float64))) for x in lb)
    worst, where = 0.0, ""
    for (path, a), b in zip(la, lb):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        e = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), floor * top, 1e-30))
        if e > worst:
            worst, where = e, jax.tree_util.keystr(path)
    return worst, where


def check(name: str, value: float, limit: float) -> None:
    status = "ok" if value <= limit else "FAIL"
    _p(f"  {name}: {value:.3e} (limit {limit:.0e}) {status}")
    if not value <= limit:
        raise AssertionError(f"{name} = {value} exceeds {limit}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}})


def read_event_scalars(exp_dir: str, keep):
    """{tag: [(step, value), ...]} of the scalars whose tag passes ``keep``,
    from the run's event files."""
    from gasfm.utils.events import read_scalars

    out = {}
    for path in sorted(glob.glob(os.path.join(exp_dir, "**", "events.out.tfevents.*"),
                                 recursive=True)):
        for tag, step, v in read_scalars(path):
            if keep(tag):
                out.setdefault(tag, []).append((step, v))
    return {tag: sorted(v) for tag, v in out.items()}


def read_batch_scalars(exp_dir: str, name: str):
    """(step, value) of the per-batch scalar ``name`` (e.g. loss, our_repro)."""
    found = read_event_scalars(exp_dir, lambda tag: tag.endswith(f"/batch/{name}"))
    return sorted(x for v in found.values() for x in v)


def read_table(path: str):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


@contextlib.contextmanager
def results_dir():
    with tempfile.TemporaryDirectory(prefix="gasfm_smoke_") as d:
        old = os.environ.get("GASFM_RESULTS_PATH")
        os.environ["GASFM_RESULTS_PATH"] = d
        try:
            yield d
        finally:
            if old is None:
                os.environ.pop("GASFM_RESULTS_PATH")
            else:
                os.environ["GASFM_RESULTS_PATH"] = old


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------


def phase_device(multi: bool):
    import jax
    import jaxlib

    from gasfm.utils.compile_cache import configure_compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke needs a GPU; JAX found {devices[0].platform!r}")
    want = 4 if multi else 1
    if len(devices) < want:
        raise SystemExit(f"needs {want} GPUs, JAX found {len(devices)}")
    _p(f"device: {devices[0].device_kind} x{len(devices)} ({devices[0].platform})")
    _p(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    _p("nvidia-smi --query-gpu=name,power.limit:")
    _p(nvidia_smi_line())
    _p(f"compile cache: {configure_compile_cache()}")
    return devices


def phase_optim(exp_root: str, epochs: int = OPTIM_EPOCHS, flagship=FLAGSHIP,
                scene=BENCH_SCENE):
    import jax

    from gasfm.config import load_config
    from gasfm.main import main
    from gasfm.utils.observability import reset_tb_writer

    conf_name = os.path.join("synth", "optim_synth_gasfm.conf")
    params = {
        **flagship,
        "dataset.synthetic.n_views": scene["n_views"],
        "dataset.synthetic.n_points": scene["n_points"],
        "dataset.synthetic.visibility": scene["visibility"],
        "train.n_epochs": epochs, "eval.eval_interval": epochs,
        "eval.eval_init": False, "train.print_interval": None,
    }
    t0 = time.perf_counter()
    rc = main(["single-scene-optim", "--conf", conf_name, "--exp-dir", "optim",
               "--external-params", *overrides(params)])
    reset_tb_writer()  # the writer is per process; the next run logs elsewhere
    _p(f"optim: main() returned {rc} after {time.perf_counter() - t0:.1f} s")
    assert rc == 0
    exp = os.path.join(exp_root, "optim")
    losses = [v for _, v in read_batch_scalars(exp, "loss")]
    repro = [v for _, v in read_batch_scalars(exp, "our_repro")]
    assert len(losses) == epochs, f"{len(losses)} logged losses for {epochs} epochs"
    first, last = losses[0], losses[-1]
    _p(f"optim: loss at init {first:.6f}, after the first update {losses[1]:.6f}, "
       f"last {last:.6f} over {epochs} steps")
    _p(f"optim: our_repro {repro[0]:.2f} px at init -> {repro[-1]:.2f} px")
    assert np.isfinite(losses).all(), "non-finite loss"
    assert last < first and repro[-1] < repro[0], "loss did not fall"
    # BA runs twice, with the points re-triangulated (DLT) from the first
    # round's cameras in between. The first round must lower the mean
    # reprojection error it starts from and the second must not raise it
    # (after a first round that reaches 0 px there is nothing left to lower).
    # The re-triangulation is not BA: from the cameras of a 30-step
    # prediction it can land far from either round.
    row = read_table(os.path.join(exp, "final_train_errors_OPTIMIZATION.csv"))[-1]
    before, after = float(row["repro_ba_before"]), float(row["repro_ba_middle"])
    before2, after2 = float(row["repro_ba_middle_triangulated"]), float(row["repro_ba_after"])
    _p(f"optim: BA cost (mean reprojection error, px): round 1 {before:.4f} -> {after:.4f}; "
       f"re-triangulated {before2:.4f} -> round 2 {after2:.4f} "
       f"(our_repro {float(row['our_repro']):.4f} px)")
    assert after < before and after2 <= before2, "BA raised the reprojection error"

    # The trainer's fused step alone: compile time and steady step time.
    from gasfm.data.loaders import create_scene_data
    from gasfm.main import init_model
    from gasfm.train.loop import TrainingSession

    conf = load_config(conf_name, external_params=overrides(params))
    model, p, _ = init_model(conf)
    session = TrainingSession(conf, model)
    sg = session.bucketize(create_scene_data(conf))
    opt = session.tx.init(p)
    margin = conf.get_float("loss.infinity_pts_margin")
    behind = [behind_share(session.forward(p, sg), sg.graph, margin)]
    t0 = time.perf_counter()
    p, opt, loss, _, _ = session.fused_step(p, opt, sg)
    jax.block_until_ready(loss)
    compile_s = time.perf_counter() - t0
    behind.append(behind_share(session.forward(p, sg), sg.graph, margin))
    _p(f"optim: share of projections in the hinge branch (depth < {margin}): "
       f"{behind[0]:.4f} at init, {behind[1]:.4f} after the first update")
    n = 20
    t0 = time.perf_counter()
    for _ in range(n):
        p, opt, loss, _, _ = session.fused_step(p, opt, sg)
    jax.block_until_ready((p, loss))
    step_s = (time.perf_counter() - t0) / n
    dev = jax.devices()[0]
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
    edges = int(sg.graph.e_true)
    _p(f"optim: {edges} edges (capacity {sg.graph.num_edges}, chunk {sg.graph.chunk}); "
       f"first fused step {compile_s:.2f} s (compile), steady {step_s * 1e3:.2f} ms/step "
       f"= {edges / step_s:.4g} edges/s; peak_bytes_in_use {peak / 2**30:.3f} GiB")


def behind_share(pred, graph, margin: float) -> float:
    """Share of the valid projections whose depth is below the loss's
    margin, where the ESFM loss is the hinge term instead of the
    reprojection error."""
    Ps = np.asarray(pred["Ps_norm"], np.float64)
    X = np.asarray(pred["pts3D"], np.float64)
    cam, pt = np.asarray(graph.cam_idx), np.asarray(graph.pt_idx)
    mask = np.asarray(graph.edge_mask)
    depth = np.einsum("ej,je->e", Ps[cam[mask], 2, :], X[:, pt[mask]])
    return float(np.mean(depth < margin))


def phase_learning(exp_root: str, layers: int = 12, scene=(40, 4000), workers: int = 2,
                   flagship=FLAGSHIP):
    from gasfm.main import main
    from gasfm.utils.observability import reset_tb_writer

    # Published learning widths, depth and learning rates
    # (confs/gasfm/learning_euc_rhaug-15-20_outliers0.1_gasfm.conf:46-53,78,97),
    # on two training scenes, one validation and one test scene. The bucket
    # grid is coarsened (one capacity for all 10-20-view samples, one for the
    # whole scenes) so the 12-layer step compiles twice, not once per
    # bucket: each cold compile takes about a minute on the H100.
    params = {
        "dataset.train_set": ["synth_train0", "synth_train1"],
        "dataset.test_set": ["synth_test0"],
        **flagship, "model.num_layers": layers, "train.finetune_lr": 1e-4,
        "dataset.synthetic.n_views": scene[0], "dataset.synthetic.n_points": scene[1],
        "dataset.min_num_views_sampled": 10, "dataset.max_num_views_sampled": 20,
        "dataset.inplane_rot_aug_max_angle": 15, "dataset.tilt_rot_aug_max_angle": 20,
        "train.outlier_injection_rate": 0.1, "dataset.dataloader_num_workers": workers,
        "train.n_epochs": 2, "train.finetune_n_epochs": 1,
        "compile.chunk": 1024, "compile.edge_bucket_growth": 2.0,
        "compile.point_bucket_multiple": 1024, "compile.view_bucket_multiple": 24,
    }
    t0 = time.perf_counter()
    rc = main(["multi-scene-learning", "--conf", os.path.join("synth", "learning_synth_gasfm.conf"),
               "--exp-dir", "learning", "--skip-fine-tuning-from-best",
               "--external-params", *overrides(params)])
    reset_tb_writer()
    _p(f"learning: main() returned {rc} after {time.perf_counter() - t0:.1f} s")
    assert rc == 0
    exp = os.path.join(exp_root, "learning")
    losses = [v for _, v in read_batch_scalars(exp, "loss")]
    _p(f"learning: {len(losses)} logged batch losses, first {losses[0]:.6f}, "
       f"last {losses[-1]:.6f}")
    assert losses and np.isfinite(losses).all()
    # Validation after each epoch, with and without injected outliers.
    val = read_event_scalars(exp, lambda tag: tag.startswith("VALIDATION-scene-avg/")
                             and tag.endswith("/epoch/our_repro"))
    assert val, "no validation our_repro logged"
    for tag, points in sorted(val.items()):
        values = [v for _, v in points]
        _p(f"learning: {tag} per epoch: {values}")
        assert len(values) >= 2 and values[-1] < values[0], "validation error did not fall"
    for name in ("final_test_errors", "final_train_errors_FINE_TUNE_from_final",
                 "final_train_errors_SHORT_OPTIMIZATION"):
        rows = read_table(os.path.join(exp, f"{name}_outlier_rate0.10.csv"))
        repro = [float(r["our_repro"]) for r in rows]
        _p(f"learning: {name}: our_repro {repro}")
        assert np.isfinite(repro).all()


def _forward_loss_grads(conf, model):
    import jax

    from gasfm.losses import get_loss_func

    loss_func = get_loss_func(conf)

    def f(params, scene):
        def loss_fn(p):
            pred = model.apply(p, scene.graph)
            return loss_func(pred, scene), pred

        (loss, pred), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        return loss, pred["Ps_norm"], pred["pts3D"], grads

    return f


def _compare(label, a, b, tol):
    loss_a, ps_a, x_a, g_a = a
    loss_b, ps_b, x_b, g_b = b
    _p(f"reference: {label}")
    check("loss rel err", rel_err(loss_a, loss_b), tol["loss"])
    check("Ps_norm rel err", rel_err(ps_a, ps_b), tol["outputs"])
    check("pts3D rel err", rel_err(x_a, x_b), tol["outputs"])
    worst, where = worst_leaf_err(g_a, g_b)
    _p(f"  worst gradient leaf: {where}")
    check("worst per-leaf grad rel err", worst, tol["grads"])


def _flagship():
    from __graft_entry__ import _flagship_conf
    from gasfm.models import get_model

    conf = _flagship_conf(small=False)
    model = get_model(conf)
    return conf, model, _forward_loss_grads(conf, model)


def _fetch(out):
    import jax

    return jax.tree_util.tree_map(np.asarray, out)


def reference_precision(bench_scene=BENCH_SCENE):
    """Default vs highest matmul precision, on the device, bench scene."""
    import jax

    from gasfm.data.synthetic import generate_synthetic_scene
    from gasfm.train.loop import GraphBucketizer

    conf, model, f = _flagship()
    scene = GraphBucketizer(conf)(generate_synthetic_scene(seed=0, **bench_scene))
    params = model.init(jax.random.PRNGKey(0), scene.graph)
    default = _fetch(jax.jit(f)(params, scene))
    with jax.default_matmul_precision("highest"):
        highest = _fetch(jax.jit(f)(params, scene))
    _compare(f"{int(scene.graph.e_true)}-edge scene, default vs highest precision",
             default, highest, TOL_TF32)


def reference_cpu(small_scene=(24, 512)):
    """The device against the CPU backend, both at highest precision."""
    import jax

    from gasfm.data.synthetic import generate_synthetic_scene

    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError as e:
        raise RuntimeError("the CPU backend is absent; the device-vs-CPU check cannot run") from e
    _, model, f = _flagship()
    data = generate_synthetic_scene(n_views=small_scene[0], n_points=small_scene[1], seed=0)
    scene = data.to_scene_graph()
    params = model.init(jax.random.PRNGKey(0), scene.graph)
    with jax.default_matmul_precision("highest"):
        dev = _fetch(jax.jit(f)(params, scene))
        host = _fetch(jax.jit(f)(jax.device_put(params, cpu), jax.device_put(scene, cpu)))
    _compare(f"{small_scene[0]}x{small_scene[1]} scene, {jax.devices()[0].platform} vs CPU "
             "at highest precision", dev, host, TOL_CPU)


def _adam_state(opt_state):
    import jax
    import optax

    found = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    assert len(found) == 1
    return found[0]


def _flat(tree):
    import jax

    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def _on_all(arr, devices, replicated: bool) -> None:
    assert arr.sharding.device_set == devices, (
        f"array on devices {sorted(d.id for d in arr.sharding.device_set)}")
    assert arr.sharding.is_fully_replicated == replicated, arr.sharding


def phase_multi(flagship=FLAGSHIP, scene=BENCH_SCENE, meshes=((1, 4), (2, 2)), layers=3):
    """One fused TrainingSession step per mesh against the same step on one
    card, at the flagship widths on the bench scene, with the depth cut to
    ``layers``: every layer is the same sharded program, and a cold compile
    of the 9-layer step takes about two minutes per mesh.

    Each mesh step is the session's own sharded step, compiled ahead of
    time. Its inputs stay on the host until they are placed with the
    shardings the compiled step reports, and the step then runs on them.
    Checked: the edge arrays split evenly over the four devices; parameters
    and optimizer state go in and come out replicated on all four; the
    devices' peak memory agrees once any single-device arrays are taken out;
    loss, gradient (Adam's first moment after one step is 0.1 * gradient)
    and parameter update agree with the one-card step."""
    import jax

    from gasfm.config import load_config
    from gasfm.data.loaders import create_scene_data
    from gasfm.main import init_model
    from gasfm.parallel import pad_scene_group
    from gasfm.train.loop import TrainingSession

    base = {**flagship, "model.num_layers": layers,
            "dataset.synthetic.n_views": scene["n_views"],
            "dataset.synthetic.n_points": scene["n_points"],
            "dataset.synthetic.visibility": scene["visibility"]}

    def setup(mesh):
        extra = {} if mesh is None else {"parallel.mesh_shape": list(mesh)}
        conf = load_config(os.path.join("synth", "optim_synth_gasfm.conf"),
                           external_params=overrides({**base, **extra}))
        model, params, _ = init_model(conf)
        session = TrainingSession(conf, model)
        params = _fetch(params)
        return session, params, _fetch(session.tx.init(params)), \
            _fetch(session.bucketize(create_scene_data(conf)))

    def mesh_step(mesh):
        session, p0, opt, sg = setup(mesh)
        devices = set(session.mesh.devices.flat)
        batched, weights = _fetch(pad_scene_group([sg], session.n_data))
        t0 = time.perf_counter()
        compiled = session._sharded_fused_fn.lower(p0, opt, batched, weights).compile()
        compile_s = time.perf_counter() - t0
        args = jax.device_put((p0, opt, batched, weights), compiled.input_shardings[0])

        mask = args[2].graph.edge_mask
        slots = {s.device.id: s.data.size for s in mask.addressable_shards}
        _p(f"multi: mesh {mesh}: compiled in {compile_s:.2f} s; edge slots per device "
           f"{slots} of {mask.size}")
        _on_all(mask, devices, replicated=False)
        assert len(slots) == 4 and set(slots.values()) == {mask.size // 4}
        for leaf in jax.tree_util.tree_leaves(args[:2]):
            _on_all(leaf, devices, replicated=True)
        single = {d: 0 for d in devices}
        for a in jax.live_arrays():
            if len(a.sharding.device_set) == 1 and next(iter(a.sharding.device_set)) in single:
                single[next(iter(a.sharding.device_set))] += a.nbytes

        t0 = time.perf_counter()
        p, opt_out, loss, _, _, gnorm = jax.block_until_ready(compiled(*args))
        _p(f"multi: mesh {mesh}: loss {float(loss):.6f}, grad norm {float(gnorm):.6e}, "
           f"step {time.perf_counter() - t0:.3f} s")
        for leaf in jax.tree_util.tree_leaves((p, opt_out, loss)):
            _on_all(leaf, devices, replicated=True)

        spread = None
        if jax.devices()[0].platform == "gpu":
            ordered = sorted(devices, key=lambda d: d.id)
            peaks = [d.memory_stats()["peak_bytes_in_use"] - single[d] for d in ordered]
            spread = 1 - min(peaks) / max(peaks)
            _p(f"multi: peak_bytes_in_use less single-device arrays per device (GiB): "
               f"{[round(x / 2**30, 3) for x in peaks]}")
        adam = _adam_state(opt_out)
        return p0, _fetch((p, adam.mu, adam.nu, loss, gnorm)), spread

    results = [(mesh, mesh_step(mesh)) for mesh in meshes]

    session, p0, opt, sg = setup(None)
    t0 = time.perf_counter()
    p1, opt1, l1, _, g1 = session.fused_step(jax.device_put(p0), jax.device_put(opt), sg)
    adam = _adam_state(opt1)
    p1, mu1, nu1, l1, g1 = _fetch((p1, adam.mu, adam.nu, l1, g1))
    _p(f"multi: one card: loss {float(l1):.6f}, grad norm {float(g1):.6e}, "
       f"first step {time.perf_counter() - t0:.2f} s")
    upd1 = _flat(p1) - _flat(p0)
    sure = np.concatenate([  # mu = 0.1 * gradient
        (np.abs(m) > 0.1 * max(SURE_GRAD, 0.1 * float(np.sqrt(np.mean(np.square(m)))))).ravel()
        for m in (np.asarray(x, np.float64) for x in jax.tree_util.tree_leaves(mu1))])
    for mesh, (p0m, (pm, mum, num, lm, gm), spread) in results:
        _p(f"multi: mesh {mesh} vs one card")
        if spread is not None:
            check("peak memory spread over devices (1 - min/max)", spread, TOL_SPREAD)
        assert all(np.array_equal(a, b) for a, b in zip(
            jax.tree_util.tree_leaves(p0m), jax.tree_util.tree_leaves(p0))), "inits differ"
        check("loss rel err", rel_err(lm, l1), TOL_MESH["loss"])
        check("grad norm rel err", rel_err(gm, g1), TOL_MESH["grads"])
        worst, where = worst_leaf_err(mum, mu1)
        _p(f"  worst gradient leaf: {where}")
        check("worst per-leaf grad rel err", worst, TOL_MESH["grads"])
        worst, where = worst_leaf_err(num, nu1)
        _p(f"  worst second-moment leaf: {where}")
        check("worst per-leaf Adam second-moment rel err", worst, TOL_MESH["nu"])
        updm = _flat(pm) - _flat(p0m)
        _p(f"  parameter update rel err over all entries: {rel_err(updm, upd1):.3e}; "
           f"{int(sure.sum())} of {sure.size} entries clear of the noise, "
           f"{int((updm * upd1 < 0)[sure].sum())} of them moved the other way")
        check("parameter update rel err where the gradient is clear of the noise",
              rel_err(updm[sure], upd1[sure]), TOL_MESH["update"])


def phases_for(multi: bool):
    if multi:
        return ["multi"]
    return ["optim", "learning", "reference"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU edge-sharded step and its one-card comparison")
    args = ap.parse_args(argv)
    if args.multi:
        # Compile-time autotuning allocates its scratch on the first device,
        # so the per-device peak memory would measure the compiler there.
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_gpu_autotune_level=0").strip()

    devices = phase_device(args.multi)
    with results_dir() as exp_root:
        for name in phases_for(args.multi):
            t0 = time.perf_counter()
            _p(f"== phase {name}")
            if name == "optim":
                phase_optim(exp_root)
            elif name == "learning":
                phase_learning(exp_root)
            elif name == "reference":
                reference_precision()
                reference_cpu()
            else:
                phase_multi()
            _p(f"== phase {name} passed in {time.perf_counter() - t0:.1f} s")
    print(result_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
