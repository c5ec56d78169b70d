"""Multi-host (DCN) smoke test: 2-process jax.distributed.initialize.

Exercises `parallel.mesh.initialize_distributed` (VERDICT round-1 item 8:
the only substantive uncovered code path) by launching two fresh
interpreters that form a 2-process CPU cluster, build the global chains
mesh, and pmean across hosts.  Skipped when the installed jax/XLA cannot
run multi-process CPU collectives.
"""

import os
import socket
import subprocess
import sys

import pytest

_CHILD = os.path.join(os.path.dirname(__file__), '_dcn_child.py')
_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_dcn_pmean():
    coordinator = f'127.0.0.1:{_free_port()}'
    env = dict(os.environ)
    env['PYTHONPATH'] = ':'.join(
        [_REPO] + [p for p in env.get('PYTHONPATH', '').split(':') if p])
    # The child pins its own JAX_PLATFORMS/XLA_FLAGS; scrub the ambient
    # device-count flag so each process gets exactly 2 virtual devices.
    env['XLA_FLAGS'] = ' '.join(
        f for f in env.get('XLA_FLAGS', '').split()
        if not f.startswith('--xla_force_host_platform_device_count'))
    env.pop('JAX_PLATFORMS', None)

    procs = [
        subprocess.Popen(
            [sys.executable, _CHILD, str(i), coordinator],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    for rc, out, err in outs:
        if rc != 0 and ('UNIMPLEMENTED' in err or 'not supported' in err
                        or 'Unable to initialize backend' in err):
            pytest.skip(f'multi-process CPU collectives unavailable: '
                        f'{err[-300:]}')
        assert rc == 0, f'child failed (rc={rc}):\n{err[-2000:]}'
        assert 'DCN_SMOKE_OK' in out, out
