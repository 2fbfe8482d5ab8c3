"""Placement of JAX's persistent compilation cache.

A full Gibbs sweep takes tens of seconds to compile, so every entry point
(tests, benchmarks, the smoke check) turns the persistent cache on through
``enable_compile_cache``.  The directory is part of what makes a cache hit
possible, so it never depends on a temp name, a PID or the time.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# Fixed directory inside the checkout (listed in .gitignore).
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn the persistent compilation cache on; return its directory.

    ``$JAX_COMPILATION_CACHE_DIR`` wins when set; otherwise the cache lives
    in ``DEFAULT_DIR``."""
    path = os.environ.get(ENV_VAR) or DEFAULT_DIR
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path
