"""Trace the flagship train step on the GPU and split its device time.

    python scripts/trace_step.py [--out DIR] [--steps N]

Runs the trainer's own fused step (TrainingSession: forward, backward, Adam)
of the 9-layer flagship on the bench scene (128 views x 8192 points,
visibility 0.2, ~116k edges), traces ``--steps`` steady steps with
jax.profiler into ``--out``, and prints the device's busy share of the
window and its kernel time by kind, from the kernel names: scatter, gather,
matmul and other. A gather that XLA fused into another kernel counts as
that kernel, so the gather share is a lower bound.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import sys
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KINDS = (
    ("scatter", ("scatter",)),
    ("gather", ("gather",)),
    ("matmul", ("gemm", "cublas", "cutlass", "matmul", "dot")),
)


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def device_events(trace_path: str):
    """(name, start_us, dur_us) of the kernel events on GPU tracks."""
    with gzip.open(trace_path, "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    gpu_pids = {e["pid"] for e in events
                if e.get("ph") == "M" and e.get("name") == "process_name"
                and "gpu" in str(e.get("args", {}).get("name", "")).lower()}
    return [(e.get("name", ""), float(e["ts"]), float(e["dur"])) for e in events
            if e.get("ph") == "X" and e.get("pid") in gpu_pids and "dur" in e]


def summarize(events, window_us: float) -> dict:
    spans = sorted((s, s + d) for _, s, d in events)
    busy, end = 0.0, None
    for s, e in spans:
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    by_kind = defaultdict(float)
    for name, _, d in events:
        by_kind[kind_of(name)] += d
    total = sum(by_kind.values())
    return {"window_ms": window_us / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1 - busy / window_us if window_us else float("nan"),
            "kernel_ms": total / 1e3,
            "share": {k: v / total for k, v in sorted(by_kind.items())} if total else {}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="trace_out")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)

    import jax

    from gasfm.config import load_config
    from gasfm.data.loaders import create_scene_data
    from gasfm.main import init_model
    from gasfm.train.loop import TrainingSession
    from gasfm.utils.compile_cache import configure_compile_cache

    import chip_smoke

    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"trace_step.py traces a GPU; JAX found {dev.platform!r}")
    params = {**chip_smoke.FLAGSHIP,
              **{f"dataset.synthetic.{k}": v for k, v in chip_smoke.BENCH_SCENE.items()}}
    conf = load_config(os.path.join("synth", "optim_synth_gasfm.conf"),
                       external_params=chip_smoke.overrides(params))
    model, p, _ = init_model(conf)
    session = TrainingSession(conf, model)
    sg = session.bucketize(create_scene_data(conf))
    opt = session.tx.init(p)
    for _ in range(3):  # compile and warm up
        p, opt, loss, _, _ = session.fused_step(p, opt, sg)
    jax.block_until_ready(loss)

    os.makedirs(args.out, exist_ok=True)
    with jax.profiler.trace(args.out, create_perfetto_trace=True):
        t0 = time.perf_counter()
        for _ in range(args.steps):
            p, opt, loss, _, _ = session.fused_step(p, opt, sg)
        jax.block_until_ready((p, loss))
        window_us = (time.perf_counter() - t0) * 1e6
    path = sorted(glob.glob(os.path.join(args.out, "**", "*.trace.json.gz"), recursive=True))[-1]
    out = summarize(device_events(path), window_us)
    out.update(device=dev.device_kind, steps=args.steps, edges=int(sg.graph.e_true),
               step_ms=out["window_ms"] / args.steps, trace=path)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
