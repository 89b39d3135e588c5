"""A small module layer for the models: named parameter trees over plain JAX.

It covers the subset of ``flax.linen`` the GASFM/DPESFM networks use, with
the same parameter layout, so the ``{"params": ...}`` trees written by
:mod:`gasfm.models.convert` and the npz checkpoints load unchanged:

- a :class:`Module` is a dataclass whose fields are its hyper-parameters;
  ``init(rng, *args)`` runs the forward once and returns the created
  parameters, ``apply(variables, *args)`` runs it on given parameters;
- submodules built inside a method are named ``name=`` or
  ``<ClassName>_<k>`` (k counts per class and per call, as in flax), and
  submodules assigned in ``setup()`` take the attribute's name;
- ``self.param(name, init_fn, *shape_args)`` creates (init) or reads (apply)
  one leaf at the module's path;
- :func:`remat` recomputes a module's forward in the backward pass.

``init`` traces the forward abstractly (``jax.eval_shape``: nothing is
compiled or run on the device) and draws each leaf on the host with NumPy,
from a generator seeded by the key and the crc32 of the leaf's path:
deterministic per seed and independent of the graph shape, though not the
values flax would draw. A jitted init would compile one random-number kernel
per leaf, which takes minutes on a GPU for the ~1,000 leaves of the flagship
models.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import zlib
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

relu = jax.nn.relu


class initializers:
    """Host-side initializers: ``init(rng: np.random.Generator, shape,
    dtype=np.float32) -> np.ndarray``, with the formulas of
    ``jax.nn.initializers``."""

    @staticmethod
    def zeros(rng, shape, dtype=np.float32):
        return np.zeros(shape, dtype)

    @staticmethod
    def ones(rng, shape, dtype=np.float32):
        return np.ones(shape, dtype)

    @staticmethod
    def uniform(bound: float):
        """U(-bound, bound)."""
        def init(rng, shape, dtype=np.float32):
            return rng.uniform(-bound, bound, shape).astype(dtype)

        return init

    @staticmethod
    def normal(stddev: float = 1e-2):
        def init(rng, shape, dtype=np.float32):
            return (rng.standard_normal(shape) * stddev).astype(dtype)

        return init

    @staticmethod
    def glorot_uniform():
        """U(-l, l) with l = sqrt(6 / (fan_in + fan_out)), fans from the last
        two axes (jax.nn.initializers.glorot_uniform)."""
        def init(rng, shape, dtype=np.float32):
            receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
            fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
            return initializers.uniform(np.sqrt(6.0 / (fan_in + fan_out)))(rng, shape, dtype)

        return init


_STACK: list = []  # modules whose methods are running, innermost last


class _Scope:
    """Where a bound module reads or creates its parameters."""

    def __init__(self, root: Dict[str, Any], path: Tuple[str, ...], rng, capture: bool):
        self.root = root  # {"params": tree[, "intermediates": tree]}
        self.path = path
        self.rng = rng  # seed words (init mode) or None (apply mode)
        self.capture = capture

    def child(self, name: str) -> "_Scope":
        return _Scope(self.root, self.path + (name,), self.rng, self.capture)

    def _node(self, tree: Dict[str, Any], create: bool) -> Dict[str, Any]:
        for p in self.path:
            tree = tree.setdefault(p, {}) if create else tree[p]
        return tree

    def param(self, name: str, init_fn, *args):
        if self.rng is None:
            try:
                return self._node(self.root["params"], create=False)[name]
            except KeyError:
                raise KeyError(
                    f"no parameter {'/'.join(self.path + (name,))} in the given variables"
                ) from None
        node = self._node(self.root["params"], create=True)
        if name not in node:
            seed = list(self.rng) + [zlib.crc32("/".join(self.path + (name,)).encode())]
            node[name] = np.asarray(init_fn(np.random.default_rng(seed), *args))
        value = node[name]
        return jnp.zeros(value.shape, value.dtype)  # abstract under eval_shape

    def subtree(self):
        """The parameters under this scope (apply mode), or None."""
        try:
            return self._node(self.root["params"], create=False)
        except KeyError:
            return None

    def with_subtree(self, sub) -> "_Scope":
        """This scope over a fresh root whose subtree at ``path`` is ``sub``."""
        tree = sub
        for p in reversed(self.path):
            tree = {p: tree}
        return _Scope({"params": tree}, self.path, self.rng, False)

    def record(self, out) -> None:
        node = self._node(self.root.setdefault("intermediates", {}), create=True)
        node["__call__"] = node.get("__call__", ()) + (out,)


def _wrap_method(fn):
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._scope is None:
            raise RuntimeError(
                f"{type(self).__name__}.{fn.__name__} called on an unbound module; "
                "use init() or apply(), or construct it inside another module's method"
            )
        self._ensure_setup()
        if self._depth == 0:
            object.__setattr__(self, "_counters", {})
        _STACK.append(self)
        object.__setattr__(self, "_depth", self._depth + 1)
        try:
            out = fn(self, *args, **kwargs)
        finally:
            object.__setattr__(self, "_depth", self._depth - 1)
            _STACK.pop()
        if fn.__name__ == "__call__" and self._scope.capture:
            self._scope.record(out)
        return out

    return wrapped


@dataclasses.dataclass(eq=False)
class Module:
    """Base class: subclasses are dataclasses; see the module docstring."""

    name: Optional[str] = dataclasses.field(default=None, kw_only=True)

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        for attr, val in list(vars(cls).items()):
            if (
                callable(val)
                and not isinstance(val, (staticmethod, classmethod, type))
                and (attr == "__call__" or not attr.startswith("_"))
                and attr != "setup"
            ):
                setattr(cls, attr, _wrap_method(val))
        dataclasses.dataclass(cls, eq=False)

    def __post_init__(self):
        for attr, val in (("_scope", None), ("_parent", None), ("_in_setup", False),
                          ("_setup_done", False), ("_depth", 0), ("_counters", {})):
            object.__setattr__(self, attr, val)
        parent = _STACK[-1] if _STACK else None
        object.__setattr__(self, "_parent", parent)
        if parent is None or parent._in_setup:
            return  # top level, or named when setup() assigns it
        name = self.name
        if name is None:
            cls_name = type(self).__name__
            k = parent._counters.get(cls_name, 0)
            parent._counters[cls_name] = k + 1
            name = f"{cls_name}_{k}"
        self._bind(parent._scope.child(name), name)

    def _bind(self, scope: _Scope, name: str) -> None:
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "_scope", scope)

    def __setattr__(self, attr, val):
        if (
            isinstance(val, Module)
            and getattr(self, "_in_setup", False)
            and val._parent is self
            and val._scope is None
        ):
            val._bind(self._scope.child(attr), attr)
        object.__setattr__(self, attr, val)

    def _ensure_setup(self) -> None:
        if self._setup_done:
            return
        object.__setattr__(self, "_setup_done", True)
        if hasattr(type(self), "setup"):
            object.__setattr__(self, "_in_setup", True)
            _STACK.append(self)
            try:
                self.setup()
            finally:
                _STACK.pop()
                object.__setattr__(self, "_in_setup", False)

    def param(self, name: str, init_fn, *args):
        return self._scope.param(name, init_fn, *args)

    def _run(self, scope: _Scope, method, args, kwargs):
        bound = copy.copy(self)
        Module.__post_init__(bound)  # fresh internal state, no parent
        bound._bind(scope, self.name)
        return getattr(bound, method or "__call__")(*args, **kwargs)

    def init(self, rng, *args, method: Optional[str] = None, **kwargs) -> Dict[str, Any]:
        """Parameters for ``rng`` (a PRNG key); runs on the host, so call it
        outside ``jax.jit``."""
        if isinstance(rng, jax.core.Tracer):
            raise TypeError("Module.init draws parameters on the host; call it outside jit")
        if jnp.issubdtype(jnp.asarray(rng).dtype, jax.dtypes.prng_key):
            rng = jax.random.key_data(rng)
        words = [int(w) for w in np.asarray(rng, np.uint32).ravel()]
        root = {"params": {}}
        jax.eval_shape(lambda: self._run(_Scope(root, (), words, False), method, args, kwargs))
        return {"params": jax.tree_util.tree_map(jnp.asarray, root["params"])}

    def apply(self, variables, *args, method: Optional[str] = None,
              capture_intermediates: bool = False, **kwargs):
        root = {"params": variables["params"]}
        out = self._run(_Scope(root, (), None, capture_intermediates), method, args, kwargs)
        if capture_intermediates:
            return out, {"intermediates": root.get("intermediates", {})}
        return out


def remat(cls):
    """``cls`` with its ``__call__`` recomputed in the backward pass
    (``jax.checkpoint``); the parameter tree is unchanged."""

    class Remat(cls):
        def __call__(self, *args, **kwargs):
            call = cls.__call__
            sub = self._scope.subtree() if self._scope.rng is None else None
            if sub is None:  # init: create the parameters directly
                return call(self, *args, **kwargs)
            outer = self._scope

            def run(sub, args, kwargs):
                object.__setattr__(self, "_scope", outer.with_subtree(sub))
                try:
                    return call(self, *args, **kwargs)
                finally:
                    object.__setattr__(self, "_scope", outer)

            return jax.checkpoint(run)(sub, args, kwargs)

    Remat.__name__ = Remat.__qualname__ = f"Remat{cls.__name__}"
    return Remat


class LayerNorm(Module):
    """flax.linen.LayerNorm semantics: params ``scale``/``bias``, statistics
    via E[x^2] - E[x]^2 clamped at 0."""

    epsilon: float = 1e-6

    def __call__(self, x):
        feat = x.shape[-1]
        scale = self.param("scale", initializers.ones, (feat,))
        bias = self.param("bias", initializers.zeros, (feat,))
        return normalize(x, scale, bias, self.epsilon)


def normalize(x, scale, bias, epsilon: float):
    """Layer normalization over the last axis with the given affine params."""
    mean = jnp.mean(x, axis=-1, keepdims=True)
    mean2 = jnp.mean(x * x, axis=-1, keepdims=True)
    var = jnp.maximum(0.0, mean2 - mean * mean)
    return (x - mean) * (jax.lax.rsqrt(var + epsilon) * scale) + bias
