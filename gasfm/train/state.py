"""Train state: optimizer construction and full-state checkpointing.

Optimizer parity: reference torch.optim.Adam with default betas/(eps)
(train.py:437) plus optional gradient clipping by global norm or value
(train.py:141-149). Checkpointing goes beyond the reference (which saves
model weights only, no resume — SURVEY section 5): full (params, opt_state,
step) train-state checkpoints as npz files, with mid-run resume.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from gasfm.train.schedules import schedule_from_conf


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: Any  # () int32


def _scale_by_adam_cast(b1, b2, eps, mu_dtype=None, nu_dtype=None):
    """optax.scale_by_adam with an additional ``nu_dtype`` (second-moment
    storage dtype). Bit-matches optax's update math (debiased moments,
    eps outside the sqrt, torch.optim.Adam parity — reference train.py:437)
    when both dtypes are None; the casts happen at state-store time only,
    accumulation runs in the gradient dtype."""

    def _cast(tree, dtype):
        if dtype is None:
            return tree
        return jax.tree_util.tree_map(lambda x: x.astype(dtype), tree)

    def init(params):
        mu = jax.tree_util.tree_map(
            lambda p: jnp.zeros_like(p, dtype=mu_dtype or p.dtype), params
        )
        nu = jax.tree_util.tree_map(
            lambda p: jnp.zeros_like(p, dtype=nu_dtype or p.dtype), params
        )
        return optax.ScaleByAdamState(count=jnp.zeros([], jnp.int32), mu=mu, nu=nu)

    def update(updates, state, params=None):
        del params
        # Accumulate in >= f32 regardless of gradient dtype: a future caller
        # feeding bf16 gradients directly must not silently compound bf16
        # rounding into the moments each step (ADVICE r4) — the casts below
        # happen at state-store time only, as the docstring promises.
        acc = jax.tree_util.tree_map(
            lambda g: g.astype(jnp.promote_types(g.dtype, jnp.float32)), updates
        )
        mu = jax.tree_util.tree_map(
            lambda m, g: b1 * m.astype(g.dtype) + (1.0 - b1) * g, state.mu, acc
        )
        nu = jax.tree_util.tree_map(
            lambda v, g: b2 * v.astype(g.dtype) + (1.0 - b2) * (g * g), state.nu, acc
        )
        count = optax.safe_increment(state.count)
        bc1 = 1.0 - b1 ** count.astype(jnp.float32)
        bc2 = 1.0 - b2 ** count.astype(jnp.float32)
        out = jax.tree_util.tree_map(
            lambda m, v: (m / bc1) / (jnp.sqrt(v / bc2) + eps), mu, nu
        )
        return out, optax.ScaleByAdamState(
            count=count, mu=_cast(mu, mu_dtype), nu=_cast(nu, nu_dtype)
        )

    return optax.GradientTransformation(init, update)


class MasterWeightState(NamedTuple):
    master: Any  # f32 master copy of the params
    inner: Any  # wrapped transformation's state


def _with_f32_master(inner: "optax.GradientTransformation"):
    """Mixed-precision wrapper: the MODEL params are carried in bf16 (halving
    the forward/backward/gradient weight streaming), while the optimizer
    steps an f32 master copy kept inside the optimizer state.

    NOT the optax ``updates`` convention: ``update`` returns the NEW bf16
    params directly (casting the stepped master), and the step builders land
    them via :func:`apply_param_updates`. Returning a delta for
    ``optax.apply_updates`` would cost an extra read-modify-write round trip
    over the whole tree (~0.9 GB/step on the 109M-param flagship).
    Gradients arrive bf16 (cotangent dtype follows the primal) and are
    upcast before the inner transformation."""

    def init(params):
        master = jax.tree_util.tree_map(lambda p: p.astype(jnp.float32), params)
        return MasterWeightState(master=master, inner=inner.init(master))

    def update(updates, state, params=None):
        del params
        g32 = jax.tree_util.tree_map(lambda g: g.astype(jnp.float32), updates)
        upd32, inner_state = inner.update(g32, state.inner, state.master)
        master = optax.apply_updates(state.master, upd32)
        new_params = jax.tree_util.tree_map(
            lambda m: m.astype(jnp.bfloat16), master
        )
        return new_params, MasterWeightState(master=master, inner=inner_state)

    return optax.GradientTransformation(init, update)


def advance_schedule_count(opt_state):
    """Advance ONLY the LR-schedule step of an optimizer state.

    The reference steps its scheduler on EVERY batch — including batches
    with no valid samples, where ``optimizer.step()`` is skipped
    (train.py:152 vs :133-151) — while optax ties the schedule to the
    update count. Without this, every skipped batch shifts all later
    applied LRs one step late relative to the reference AND to the logged
    ``schedule(n_updates)`` values. Adam's own count (bias correction)
    intentionally stays at the number of real updates, matching
    torch.optim.Adam's ``step`` counter.
    """
    import optax

    def bump(leaf):
        return optax.ScaleByScheduleState(count=optax.safe_increment(leaf.count))

    return jax.tree_util.tree_map(
        lambda x: bump(x) if isinstance(x, optax.ScaleByScheduleState) else x,
        opt_state,
        is_leaf=lambda x: isinstance(x, optax.ScaleByScheduleState),
    )


def apply_param_updates(params, updates, opt_state):
    """``optax.apply_updates`` that understands the f32-master wrapper: with
    a :class:`MasterWeightState` the ``updates`` ARE the new bf16 params
    (see :func:`_with_f32_master`); otherwise the usual additive update."""
    if isinstance(opt_state, MasterWeightState):
        return updates
    return optax.apply_updates(params, updates)


def cast_params_for_training(conf, params):
    """Apply ``train.param_dtype`` to a freshly initialized param tree
    (bf16 -> carry the model weights in bfloat16; see _with_f32_master)."""
    if conf.get_string("train.param_dtype", default=None) == "bf16":
        return jax.tree_util.tree_map(lambda p: p.astype(jnp.bfloat16), params)
    return params


def build_optimizer(conf, milestone_shift: int = 0) -> Tuple[optax.GradientTransformation, Callable]:
    """Adam + per-batch LR schedule + optional grad clipping.

    Returns (tx, schedule_fn). The clip order matches the reference: clip is
    applied to raw gradients before the Adam update (train.py:141-151).
    """
    schedule = schedule_from_conf(conf, milestone_shift=milestone_shift)
    chain = []
    grad_clip_mode = conf.get_string("loss.grad_clip_mode", default=None)
    if grad_clip_mode is not None:
        grad_clip_th = conf.get_float("loss.grad_clip_th")
        if grad_clip_mode == "norm":
            chain.append(optax.clip_by_global_norm(grad_clip_th))
        elif grad_clip_mode == "value":
            chain.append(optax.clip(grad_clip_th))
        else:
            raise AssertionError(f'Could not interpret gradient clipping mode "{grad_clip_mode}".')
    # Optional bf16 first-moment storage (``train.adam_mu_dtype = "bf16"``):
    # Adam on the flagship 110M-param tree is memory-bound, and a bf16 mu
    # trims its read+write traffic. OFF by default — it perturbs optimizer
    # numerics (the reference uses f32 torch Adam).
    mu_dtype = conf.get_string("train.adam_mu_dtype", default=None)
    nu_dtype = conf.get_string("train.adam_nu_dtype", default=None)
    if nu_dtype == "bf16":
        # optax has no nu_dtype; use the faithful clone below (second-moment
        # storage halves at ~0.4% relative sqrt(nu) rounding); the default
        # stays f32.
        chain.append(
            _scale_by_adam_cast(
                b1=0.9, b2=0.999, eps=1e-8,
                mu_dtype=jnp.bfloat16 if mu_dtype == "bf16" else None,
                nu_dtype=jnp.bfloat16,
            )
        )
        chain.append(optax.scale_by_learning_rate(schedule))
    else:
        chain.append(
            optax.adam(
                learning_rate=schedule, b1=0.9, b2=0.999, eps=1e-8,
                mu_dtype=jnp.bfloat16 if mu_dtype == "bf16" else None,
            )
        )
    tx = optax.chain(*chain)
    if conf.get_string("train.param_dtype", default=None) == "bf16":
        tx = _with_f32_master(tx)
    return tx, schedule


def create_train_state(conf, params, milestone_shift: int = 0) -> Tuple[TrainState, optax.GradientTransformation, Callable]:
    tx, schedule = build_optimizer(conf, milestone_shift=milestone_shift)
    params = cast_params_for_training(conf, params)
    opt_state = tx.init(params)
    return TrainState(params=params, opt_state=opt_state, step=jnp.zeros((), jnp.int32)), tx, schedule


# ---------------------------------------------------------------------------
# Checkpointing: one npz of the whole TrainState per step directory
# ---------------------------------------------------------------------------


def _flat_arrays(tree) -> dict:
    """{'/'-joined key path: host array}; bfloat16 leaves as their uint16
    bits (npz has no bfloat16)."""
    import numpy as np

    out = {}
    for keypath, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.asarray(leaf)
        if arr.dtype == jnp.bfloat16:
            arr = arr.view(np.uint16)
        out[jax.tree_util.keystr(keypath)] = arr
    return out


def save_checkpoint(ckpt_dir: str, state: TrainState, step: Optional[int] = None, keep: int = 3):
    """Write ``<ckpt_dir>/<step>/state.npz`` and keep the newest ``keep``
    step directories. The npz is written under a temporary name and renamed,
    so a crash mid-write never leaves a readable partial checkpoint."""
    import shutil

    import numpy as np

    ckpt_dir = os.path.abspath(ckpt_dir)
    step = int(state.step) if step is None else int(step)
    step_dir = os.path.join(ckpt_dir, str(step))
    os.makedirs(step_dir, exist_ok=True)
    tmp = os.path.join(step_dir, "state.tmp.npz")
    np.savez(tmp, **_flat_arrays(dataclasses.asdict(state)))
    os.replace(tmp, os.path.join(step_dir, "state.npz"))
    for old in _checkpoint_steps(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)))


def _checkpoint_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(d) for d in os.listdir(ckpt_dir)
        if d.isdigit() and os.path.exists(os.path.join(ckpt_dir, d, "state.npz"))
    )


def restore_checkpoint(ckpt_dir: str, template: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
    """Load the newest (or the given) step into ``template``'s structure;
    None when there is no checkpoint. Every leaf must be present with the
    template's shape."""
    import numpy as np

    ckpt_dir = os.path.abspath(ckpt_dir)
    steps = _checkpoint_steps(ckpt_dir)
    if not steps:
        return None
    step = max(steps) if step is None else step
    tree = dataclasses.asdict(template)
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    with np.load(os.path.join(ckpt_dir, str(step), "state.npz")) as data:
        leaves = []
        for keypath, leaf in flat:
            key = jax.tree_util.keystr(keypath)
            if key not in data.files:
                raise ValueError(f"checkpoint step {step} has no leaf {key}")
            arr = data[key]
            if np.shape(arr) != np.shape(leaf):
                raise ValueError(
                    f"checkpoint leaf {key} has shape {np.shape(arr)}, expected {np.shape(leaf)}"
                )
            dtype = np.asarray(leaf).dtype
            leaves.append(jnp.asarray(arr.view(dtype) if dtype == jnp.bfloat16 else arr, dtype))
    return TrainState(**jax.tree_util.tree_unflatten(treedef, leaves))


def save_params(path: str, params) -> None:
    """Flat npz weight dump (the analogue of the reference's .pt state_dict
    saves, main.py/train.py best_model.pt / final_model.pt)."""
    import numpy as np

    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    arrays = {}
    for keypath, leaf in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keypath)
        arrays[key] = np.asarray(leaf)
    np.savez(path, **arrays)


def load_params(path: str, template) -> Any:
    """Restore params saved by :func:`save_params` into the template's
    structure, tolerating missing/unexpected head keys like the reference's
    pretrained-weight loading (main.py:168-190)."""
    import numpy as np

    data = np.load(path)
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    leaves = []
    missing = []
    for keypath, leaf in flat:
        key = "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in keypath)
        if key in data.files:
            arr = data[key]
            assert arr.shape == leaf.shape, f"shape mismatch for {key}: {arr.shape} vs {leaf.shape}"
            leaves.append(arr)
        else:
            missing.append(key)
            leaves.append(leaf)
    if missing:
        print(f"[load_params] keeping init values for {len(missing)} missing keys (e.g. {missing[:3]})")
    return jax.tree_util.tree_unflatten(treedef, leaves)
