"""Root conftest: the platform a test run uses.

Tests run on the CPU backend with 8 virtual devices (the multi-device
paths are checked on a virtual mesh) unless JAX_PLATFORMS names another
platform, as `JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu` does on
a machine with an NVIDIA GPU.  Set here, before any test module imports
JAX.
"""

import os

os.environ.setdefault('JAX_PLATFORMS', 'cpu')
_flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in _flags:
    os.environ['XLA_FLAGS'] = (
        _flags + ' --xla_force_host_platform_device_count=8').strip()
