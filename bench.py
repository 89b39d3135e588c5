"""Benchmark: GASFM training-step throughput on one GPU.

Times the steady-state jitted train step (forward + backward + Adam) of the
flagship GASFM architecture (9 layers, widths 32/64/1024/2048, 4 heads —
reference confs/gasfm/optim_euc_gasfm.conf) on two synthetic scenes through
the production GraphBucketizer, and reports edge throughput:

    edges/s = valid_edges / step_time

- dense: uniform visibility, m=128, n=8192, v=0.2 (~116k edges);
- powerlaw: truncated-Pareto track lengths, m=133, n=24576 (~70k edges).

Steps are batched inside one jitted lax.scan and timed to the fetch of the
last loss. Prints ONE JSON line naming the device. Fails when JAX finds no
GPU: no number here is a CPU number.

    python bench.py
"""

from __future__ import annotations

import json
import time


def _measure_scene(conf, model, loss_func, tx, scene, steps_per_call=128, reps=3):
    """Best-of-``reps`` per-step time of the full train step on ``scene``."""
    import jax

    from gasfm.train.state import cast_params_for_training
    from gasfm.utils.benchstep import make_run_steps

    params = model.init(jax.random.PRNGKey(0), scene.graph)
    params = cast_params_for_training(conf, params)
    opt_state = tx.init(params)

    run_steps = make_run_steps(model, loss_func, tx)
    float(run_steps(params, opt_state, scene, steps_per_call)[2])  # compile

    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        float(run_steps(params, opt_state, scene, steps_per_call)[2])
        times.append(time.perf_counter() - t0)
    return min(times) / steps_per_call


def main():
    import jax

    from gasfm.utils.compile_cache import configure_compile_cache

    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found {dev.platform!r}")

    from __graft_entry__ import _flagship_conf
    from gasfm.data.synthetic import generate_synthetic_scene
    from gasfm.losses import get_loss_func
    from gasfm.models import get_model
    from gasfm.train.loop import GraphBucketizer
    from gasfm.train.state import build_optimizer

    conf = _flagship_conf(small=False)
    model = get_model(conf)
    loss_func = get_loss_func(conf)
    tx, _ = build_optimizer(conf)
    bucketize = GraphBucketizer(conf)

    scenes = {
        "dense": generate_synthetic_scene(n_views=128, n_points=8192, visibility=0.2, seed=0),
        "powerlaw": generate_synthetic_scene(
            n_views=133, n_points=24576, track_length_dist="powerlaw", seed=0
        ),
    }
    result = {"device": {"platform": dev.platform, "kind": dev.device_kind,
                         "count": len(jax.devices())}}
    for name, data in scenes.items():
        scene = bucketize(data)
        n_edges = int(scene.graph.e_true)
        step_s = _measure_scene(conf, model, loss_func, tx, scene)
        result[name] = {"edges": n_edges, "chunk": scene.graph.chunk,
                        "step_ms": step_s * 1e3, "edges_per_s": n_edges / step_s}
    print(json.dumps(result))


if __name__ == "__main__":
    main()
