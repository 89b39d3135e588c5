"""Real multi-process ``jax.distributed`` startup: two OS processes join one
CPU-backend runtime through ``initialize_distributed`` (no monkeypatching)
and each verifies the global device view; both then run one sharded psum
over a 4-device mesh spanning the two processes.

This proves the communication-backend startup path end to end
(gasfm/parallel/edge_sharding.py, initialize_distributed) — the
analogue of a multi-host launch. The reference has no distributed backend at all
(single process / single GPU, SURVEY section 2.7).
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

_REPO = Path(__file__).resolve().parents[1]

_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["GASFM_REPO"])

# Each process owns 2 disjoint CPU devices; the config knob is set before
# any backend is created.
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax

jax.config.update("jax_platforms", "cpu")

from gasfm.config.hocon import ConfigFactory
from gasfm.parallel.edge_sharding import initialize_distributed

conf = ConfigFactory.from_dict({
    "parallel": {"distributed": {
        "enabled": True,
        "coordinator_address": os.environ["COORD"],
        "num_processes": 2,
        "process_id": int(os.environ["PROC_ID"]),
    }},
})
assert initialize_distributed(conf)

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

assert jax.process_count() == 2, jax.process_count()
assert len(jax.local_devices()) == 2
assert len(jax.devices()) == 4

# One collective over a mesh spanning BOTH processes: the psum must see
# every process's shard (multi-controller SPMD: each process materializes
# only its addressable shards of the global array).
mesh = Mesh(np.asarray(jax.devices()).reshape(4), axis_names=("edge",))
sharding = NamedSharding(mesh, P("edge"))
x = jax.make_array_from_callback(
    (8,), sharding, lambda idx: np.arange(8.0, dtype=np.float32)[idx]
)

def f(v):
    return jax.lax.psum(jnp.sum(v), "edge")

total = jax.jit(
    jax.shard_map(f, mesh=mesh, in_specs=P("edge"), out_specs=P(),
                  check_vma=False)
)(x)
np.testing.assert_allclose(np.asarray(total), 28.0)
print(f"proc {jax.process_index()} OK", flush=True)
"""


def test_two_process_distributed_initialize(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)

    env_base = {
        k: v for k, v in os.environ.items()
        if not k.startswith(("JAX_", "XLA_"))
    }
    env_base["GASFM_REPO"] = str(_REPO)
    env_base["COORD"] = coord

    procs = []
    for pid in range(2):
        env = dict(env_base, PROC_ID=str(pid))
        procs.append(subprocess.Popen(
            [sys.executable, str(worker)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for q in procs:
            if q.poll() is None:
                q.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert f"proc {pid} OK" in out, out
