"""Persistent XLA compilation cache for the entry scripts.

The engine compiles dozens of programs per camera configuration, so a
second run of a script reuses the first one's executables from disk.
Tests do not call this: they run without a persistent cache.
"""

from __future__ import annotations

import os

import jax

CHECKOUT_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    no other directory is set.  Otherwise the cache is ``.jax_cache`` at
    the root of this checkout.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
