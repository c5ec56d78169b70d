"""``dryrun_multichip`` must work whatever the caller's JAX platform.

The entry re-launches itself in a virtual-CPU child with its own device
count; these tests call it from environments that name another platform
or expose a single device.
"""

import os
import subprocess
import sys

import pytest

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_in_env(extra_env, n_devices=8):
    env = dict(os.environ)
    env.update(extra_env)
    script = (
        'import __graft_entry__ as g; '
        f'g.dryrun_multichip({n_devices})'
    )
    return subprocess.run(
        [sys.executable, '-c', script],
        env=env, cwd=REPO_ROOT, capture_output=True, text=True, timeout=600)


@pytest.mark.slow
def test_dryrun_multichip_dirty_platform_env():
    # A bogus platform name: jax backend init would fail outright unless
    # the entry re-launches itself on the CPU.
    result = _run_in_env({
        'JAX_PLATFORMS': 'nonexistent_platform',
        'PYTHONPATH': f'{REPO_ROOT}:/nonexistent/site_dir',
        'XLA_FLAGS': '--xla_force_host_platform_device_count=1',
    })
    assert result.returncode == 0, result.stderr[-3000:]
    assert 'dryrun_multichip(8)' in result.stdout
    assert 'OK' in result.stdout


@pytest.mark.slow
def test_dryrun_multichip_single_device_ambient():
    # Ambient env exposes only 1 CPU device; the dry run must still build
    # an 8-device mesh via its own forced host-platform device count.
    result = _run_in_env({
        'JAX_PLATFORMS': 'cpu',
        'XLA_FLAGS': '',
        'PYTHONPATH': REPO_ROOT,
    })
    assert result.returncode == 0, result.stderr[-3000:]
    assert 'OK' in result.stdout


def test_sanitized_env_contents(monkeypatch):
    import __graft_entry__ as g
    monkeypatch.setenv('XLA_FLAGS',
                       '--xla_force_host_platform_device_count=1 --foo')
    monkeypatch.setenv('JAX_PLATFORMS', 'cuda')
    env = g._child_env(8)
    assert env['JAX_PLATFORMS'] == 'cpu'
    assert env['XLA_FLAGS'].split() == [
        '--foo', '--xla_force_host_platform_device_count=8']
    assert REPO_ROOT in env['PYTHONPATH'].split(':')
    assert g._is_child(8) is False
