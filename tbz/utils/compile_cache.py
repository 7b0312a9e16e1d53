"""Persistent XLA compilation cache placement.

`JAX_COMPILATION_CACHE_DIR`, when set, names the cache directory and
nothing else is chosen in code. Otherwise the cache lives at the fixed
path `<repo>/.jax_cache` (gitignored): the directory is part of the
cache key, so a path that moved between runs would never hit.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def cache_dir() -> str:
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable() -> str:
    """Point JAX's persistent cache at `cache_dir()` and cache every
    compilation, however small or quick. Returns the directory."""
    import jax
    d = cache_dir()
    jax.config.update("jax_compilation_cache_dir", d)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return d
