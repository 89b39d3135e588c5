"""Shared scan-batched train-step builder for bench.py and the perf scripts.

One definition so the bench and the scaling probes measure the SAME program.
"""

from __future__ import annotations

from functools import partial

import jax
import optax
from gasfm.train.state import apply_param_updates


def make_run_steps(model, loss_func, tx):
    """Returns run_steps(params, opt_state, scene, n) -> (params, opt_state,
    last_loss): `n` full train steps (fwd + bwd + optimizer) batched inside
    one jitted lax.scan.

    The scene is closed over from the jit argument (a traced value, so not
    an embedded HLO constant) rather than threaded through the scan carry:
    XLA double-buffers loop carries, and carrying the invariant E-sized
    scene arrays copies them every iteration."""

    @partial(jax.jit, static_argnames="n")
    def run_steps(params, opt_state, scene, n):
        def one_step(carry, _):
            params, opt_state = carry

            def loss_fn(p):
                return loss_func(model.apply(p, scene.graph), scene)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            params = apply_param_updates(params, updates, opt_state)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            one_step, (params, opt_state), None, length=n
        )
        # Returning the last loss and fetching it forces completion.
        return params, opt_state, losses[-1]

    return run_steps
