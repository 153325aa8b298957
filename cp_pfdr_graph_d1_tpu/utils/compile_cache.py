"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set; otherwise the cache is
the fixed directory ``<checkout>/.jax_cache``.  The path is part of the
cache key, so it is never derived from a temporary name, a process id or
the time.
"""
from __future__ import annotations

import os
import pathlib

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)


def enable_compile_cache() -> str:
    """Points JAX's persistent compilation cache at
    :func:`compile_cache_dir` and returns that directory."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
