"""Persistent XLA compilation cache: repeat runs of the apps, the benchmark
and the tests skip the 30-90 s cycle compiles.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
module sets no directory of its own.  Otherwise the cache lives at one fixed
path inside the checkout (``<repo>/.jax_cache``, git-ignored): the path is
part of what makes an entry found again, so it must not move between runs.
"""

from __future__ import annotations

import os

import jax

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), ".jax_cache"
)


def enable() -> str:
    """Turn the persistent cache on (programs compiled in >= 1 s are kept)
    and return its directory."""
    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
