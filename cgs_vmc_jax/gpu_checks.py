"""Checks that need an NVIDIA GPU, at full width, against references
computed on the CPU or by plain XLA.

Run by chip_smoke.py and by the tests marked `gpu`
(`JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu`).  Each check raises
AssertionError on failure and returns what it measured.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import jax
import jax.numpy as jnp

CHECKOUT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_ARTIFACT = os.path.join(CHECKOUT_DIR, 'artifacts',
                                 'heisenberg_6x6_deep48.msgpack')
FLAGSHIP_SAMPLES = os.path.join(CHECKOUT_DIR, 'tests', 'data',
                                'flagship_6x6_deep48_samples.npy')
FLAGSHIP_LOGPSI = os.path.join(CHECKOUT_DIR, 'tests', 'data',
                               'flagship_6x6_deep48_logpsi.npy')
E_QMC = -0.678872          # Sandvik QMC, square-lattice Heisenberg 6x6
# Energy band of tests/test_flagship_pin.py: ~4x the sample set's sem/N
# plus the artifact's model bias.
ENERGY_BAND = 1.0e-3
# f32 accumulation-order noise through 7 conv layers and a 16-element
# symmetry orbit, between the CPU reference and the GPU at full precision.
LOGPSI_TOL_HIGHEST = 1.0e-4


def flagship_wavefunction():
    """The 7x48 symmetrized conv of artifacts/heisenberg_6x6_deep48."""
    from cgs_vmc_jax.config import Config
    from cgs_vmc_jax.models import build_wavefunction
    from cgs_vmc_jax.utils import codec
    cfg = Config(num_sites=36, size_x=6, size_y=6,
                 wavefunction_type='conv_2d', num_conv_layers=7,
                 num_conv_filters=48, kernel_size=3, symmetrize=True,
                 heisenberg_jx=-1.0)
    wf = build_wavefunction(cfg)
    with open(FLAGSHIP_ARTIFACT, 'rb') as f:
        params = codec.from_bytes(wf.init(jax.random.key(0)), f.read())
    return wf, params


def flagship_parity(precision: str | None) -> dict:
    """logψ of the deep48 artifact on its 512 committed samples vs the
    CPU-computed logψ, and the self-normalized reweighted E/N.

    precision: 'highest' for full f32 matmuls and convolutions (the logψ
    drift must then be <= LOGPSI_TOL_HIGHEST), or None for JAX's default
    (TF32 on this card; the drift is only reported).  Either way E/N must
    lie within ENERGY_BAND of the QMC value.
    """
    from cgs_vmc_jax import lattice
    from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
    wf, params = flagship_wavefunction()
    configs = jnp.asarray(np.load(FLAGSHIP_SAMPLES), jnp.float32)
    log_ref = np.load(FLAGSHIP_LOGPSI)
    ham = HeisenbergHamiltonian(lattice.square_lattice_bonds(6, 6),
                                -1.0, 1.0, sample_chunk=64)
    ctx = (jax.default_matmul_precision(precision) if precision
           else contextlib.nullcontext())
    with ctx:
        log_new = np.asarray(
            jax.jit(lambda p, c: wf.apply(p, c).log)(params, configs),
            np.float64)
        e_loc = np.asarray(
            jax.jit(lambda p, c: ham.local_value(wf, p, c))(params, configs),
            np.float64)
    drift = float(np.max(np.abs(log_new - log_ref)))
    if precision == 'highest':
        assert drift <= LOGPSI_TOL_HIGHEST, (
            f'deep48 logψ drift {drift:.3e} > {LOGPSI_TOL_HIGHEST:.0e} '
            'at highest precision')
    w = np.exp(2.0 * (log_new - log_ref - np.max(log_new - log_ref)))
    e_per_site = float((w / w.sum() * e_loc).sum()) / configs.shape[1]
    assert np.isfinite(e_per_site) and abs(e_per_site - E_QMC) < ENERGY_BAND, (
        f'reweighted E/N {e_per_site:.6f} outside {E_QMC} +/- {ENERGY_BAND}')
    return {'max_dlogpsi': drift, 'energy_per_site': e_per_site}


def rbm_problem(n_sites: int = 36, hidden: int = 64, chains: int = 2048,
                seed: int = 0):
    """Random RBM weights and Sz=0 chains at the benchmark's shapes."""
    from cgs_vmc_jax import basis
    k_w, k_b, k_a, k_c = jax.random.split(jax.random.key(seed), 4)
    w = 0.05 * jax.random.normal(k_w, (n_sites, hidden), jnp.float32)
    b = 0.05 * jax.random.normal(k_b, (hidden,), jnp.float32)
    a = 0.05 * jax.random.normal(k_a, (n_sites,), jnp.float32)
    configs = basis.random_configurations(k_c, n_sites, chains)
    return w, b, a, configs


def rbm_kernel_parity(sweeps_fn, n_sites: int = 36, hidden: int = 64,
                      chains: int = 2048, num_sweeps: int = 2) -> dict:
    """`sweeps_fn` (kernels.rbm_sweeps or rbm_sweeps_xla) against the
    full-recompute oracle on the same picks and uniforms: identical
    configs and accept counts, logψ within 1e-4.  Every matmul on both
    sides runs at HIGHEST precision (set in kernels.py), so TF32
    rounding cannot flip a marginal accept."""
    from cgs_vmc_jax.sampler import kernels
    w, b, a, configs = rbm_problem(n_sites, hidden, chains)
    picks = kernels.sample_picks(jax.random.key(1), num_sweeps * n_sites,
                                 n_sites, chains)
    key = jax.random.key(2)
    out = sweeps_fn(w, b, a, configs, picks, key)
    ref = jax.jit(kernels.rbm_sweeps_reference)(w, b, a, configs, picks, key)
    assert np.array_equal(np.asarray(out.configs), np.asarray(ref.configs)), \
        'configs differ from the oracle'
    assert np.array_equal(np.asarray(out.num_accepted),
                          np.asarray(ref.num_accepted)), \
        'accept counts differ from the oracle'
    dlog = float(jnp.max(jnp.abs(out.log_amp - ref.log_amp)))
    assert dlog <= 1e-4, f'logψ differs from the oracle by {dlog:.3e}'
    accepted = float(ref.num_accepted.sum())
    return {'max_dlogpsi': dlog,
            'acceptance': accepted / (num_sweeps * n_sites * chains)}
