"""Persistent XLA compilation cache at a fixed place.

The cache key includes the directory, so a cache that moves never hits:
``JAX_COMPILATION_CACHE_DIR`` wins when it is set (JAX reads it itself),
otherwise the cache lives in ``<repo>/.jax_cache`` next to the package.
"""

from __future__ import annotations

import os

import jax

__all__ = ["DEFAULT_CACHE_DIR", "enable_compile_cache"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its fixed directory.

    Returns the directory in use.  Leaves ``JAX_COMPILATION_CACHE_DIR``
    alone when it is set; call before the first compilation.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
