"""Where JAX keeps its persistent compilation cache.

If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing here
overrides it.  Otherwise the cache lives at a fixed `<checkout>/.jax_cache`
(listed in .gitignore): the directory is part of the cache's key, so it is
never built from a temporary name, a pid or the time.
"""

from __future__ import annotations

import os

import jax

CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def configure() -> str:
    """Points the compile cache at its directory; returns that path."""
    path = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if not path:
        path = os.path.join(CHECKOUT_DIR, '.jax_cache')
        jax.config.update('jax_compilation_cache_dir', path)
    return path
