"""Persistent XLA compilation cache.

Deep scan/while programs over hundreds of spheres take long to compile; the
persistent cache (keyed on HLO) makes every repeat invocation across
processes a cache hit. Call once, early.
"""

from __future__ import annotations

import os

_DEFAULT_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), ".jax_cache")


def cache_dir() -> str:
    """`JAX_COMPILATION_CACHE_DIR` when it is set, else `<repo>/.jax_cache`
    (a fixed path: the directory is part of the cache key)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_DIR


def enable_compilation_cache() -> None:
    import jax

    jax.config.update("jax_compilation_cache_dir", cache_dir())
    # cache everything, however small/fast to compile
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
