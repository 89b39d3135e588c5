"""Where JAX keeps its persistent compilation cache."""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def configure_compile_cache() -> str:
    """Returns the cache directory in use. ``JAX_COMPILATION_CACHE_DIR``, when
    set, is read by JAX itself and nothing is changed; otherwise the cache
    goes to ``<checkout>/.jax_cache``. The path is part of the cache key, so
    it is fixed rather than temporary."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    path = os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
