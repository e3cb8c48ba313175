"""JAX's persistent compilation cache for the repository's scripts.

Importing the library sets no cache; a script that wants one calls
:func:`enable_compile_cache` once, before its first compilation.
"""

from __future__ import annotations

import os

import jax

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"


def enable_compile_cache(root: str) -> str:
    """Turn on the persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and this
    sets no other directory.  Otherwise the cache is ``<root>/.jax_cache``:
    a fixed path (never a temporary name, a pid or a time), because the path
    is what lets two runs from the same checkout find each other's entries.
    """
    env = os.environ.get(CACHE_ENV)
    if env:
        return env
    path = os.path.join(os.path.abspath(root), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
