"""CI pin of the flagship headline claim at ~1e-3 on CPU, no MCMC.

The committed sample set (tests/data/flagship_6x6_deep48_samples.npy,
512 int8 configurations) was drawn once from |psi|^2 of the
6x6 deep48 artifact (RESULTS.md headline row, rel err 7.05e-5 vs QMC;
examples/dump_flagship_pin_samples.py).  Re-evaluating the local energy
over these FIXED configurations gives an unbiased estimate of <H> at the
sample set's own Monte-Carlo precision — no equilibration or sampling at
test time, so the headline physics claim is re-verified on every CI run
in seconds.  The dump-time log-amplitudes double as a drift detector: if
the artifact bytes or the forward pass change, the recomputed log|psi|
moves, and self-normalized importance reweighting both flags the drift
and keeps the energy estimate unbiased.

Complements tests/test_artifacts.py (corruption fingerprint at ~0.6%):
this pins the ~1e-3 headline — the round-3 review's 'Weak #5' gap.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.utils import codec

HERE = os.path.dirname(__file__)
SAMPLES = os.path.join(HERE, 'data', 'flagship_6x6_deep48_samples.npy')
LOGPSI = os.path.join(HERE, 'data', 'flagship_6x6_deep48_logpsi.npy')
ARTIFACT = os.path.join(HERE, '..', 'artifacts',
                        'heisenberg_6x6_deep48.msgpack')
N = 36
E_QMC = -0.678872          # Sandvik QMC, square-lattice Heisenberg 6x6
# Band: ~4x the dump-time sem/N over the 512-sample set (dump run:
# E/N = -0.678661, sem/N = 2.02e-4), plus the headline model bias
# (rel err 7.05e-5).
BAND = 1.0e-3


def _flagship():
    cfg = Config(num_sites=N, size_x=6, size_y=6,
                 wavefunction_type='conv_2d', num_conv_layers=7,
                 num_conv_filters=48, kernel_size=3, symmetrize=True,
                 heisenberg_jx=-1.0)
    wf = build_wavefunction(cfg)
    params = codec.from_bytes(wf.init(jax.random.key(0)),
                              open(ARTIFACT, 'rb').read())
    return wf, params


@pytest.mark.slow
def test_flagship_headline_pinned():
    """~90 s of real local-energy compute (512 x 60-bond x 16-orbit
    fan-out) — slow tier; the full CI suite re-verifies the headline."""
    configs = jnp.asarray(np.load(SAMPLES), jnp.float32)
    log_ref = np.load(LOGPSI)
    assert configs.shape == (512, N)

    wf, params = _flagship()
    log_new = np.asarray(
        jax.jit(lambda p, c: wf.apply(p, c).log)(params, configs),
        np.float64)

    # Drift detector: on the committed artifact the recomputed
    # amplitudes must reproduce the dump (weights exactly ~1).
    drift = np.max(np.abs(log_new - log_ref))
    assert drift < 1e-3, f'artifact/forward drift: max |dlog| = {drift}'

    # Self-normalized importance reweighting (unbiased under drift).
    w = np.exp(2.0 * (log_new - log_ref - np.max(log_new - log_ref)))
    w = w / w.sum()

    ham = HeisenbergHamiltonian(lattice.square_lattice_bonds(6, 6),
                                -1.0, 1.0, sample_chunk=64)
    e_loc = np.asarray(
        jax.jit(lambda p, c: ham.local_value(wf, p, c))(params, configs),
        np.float64)
    e_per_site = float((w * e_loc).sum()) / N
    assert abs(e_per_site - E_QMC) < BAND, (
        f'flagship headline drifted: E/N = {e_per_site:.6f}, '
        f'QMC {E_QMC} +/- {BAND}')


@pytest.mark.gpu
def test_flagship_forward_parity_on_gpu(gpu):
    """Full-width deep48 forward on the GPU: logψ within 1e-4 of the CPU
    reference at 'highest' precision, and the reweighted E/N within the
    pin's band at both 'highest' and the default (TF32) precision
    (chip_smoke.py phase 1)."""
    from cgs_vmc_jax import gpu_checks
    gpu_checks.flagship_parity('highest')
    gpu_checks.flagship_parity(None)
