"""Test harness: persistent compile cache and the `gpu` fixture.

The platform (CPU with 8 virtual devices unless JAX_PLATFORMS says
otherwise) is set by the repo-root conftest.py before JAX is imported.
"""

import os

import jax
import pytest

# Persistent compilation cache: the suite is compile-dominated (dozens of
# jitted epoch functions); caching makes re-runs much faster.
if not os.environ.get('JAX_COMPILATION_CACHE_DIR'):
    jax.config.update('jax_compilation_cache_dir',
                      os.path.join(os.path.dirname(__file__), '.jax_cache'))
jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.5)


@pytest.fixture
def gpu():
    """Skips the test unless JAX runs on an NVIDIA GPU (tests marked
    `gpu`: compiled kernels and full-width parity checks)."""
    if jax.default_backend() != 'gpu':
        pytest.skip('needs an NVIDIA GPU: run with JAX_PLATFORMS=cuda '
                    'python -m pytest tests/ -m gpu')
