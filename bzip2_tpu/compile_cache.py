"""The one home of JAX's persistent compilation cache for this package."""
from __future__ import annotations

import os

#: used when JAX_COMPILATION_CACHE_DIR is not set: a fixed path inside the
#: checkout (the path is part of the cache key, so it must not move)
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing here changes; otherwise the cache goes to ``DEFAULT_DIR``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
