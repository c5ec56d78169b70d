"""Multiple-try Metropolis: invariants and Born-distribution correctness."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.models import FullVector
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.sampler import metropolis, mtm
from cgs_vmc_jax.utils import ed

N = 8
BONDS = lattice.chain_bonds(N)


def _exact_wavefunction():
    e0, v0 = ed.ground_state(N, BONDS)
    wf = FullVector.for_sector(N, v0.astype(np.float32))
    return wf, wf.init(jax.random.key(0)), e0, v0


def test_mtm_conserves_sz_and_spins():
    wf, params, _, _ = _exact_wavefunction()
    state = metropolis.init_sampler(jax.random.key(1), wf, params, N, 64)
    state = jax.jit(lambda s: mtm.run_sweeps(wf, params, s, 10, k=4))(state)
    configs = np.asarray(state.configs)
    assert set(np.unique(configs)) == {-1.0, 1.0}
    np.testing.assert_array_equal(configs.sum(axis=1), np.zeros(64))


def test_mtm_amplitude_cache_consistent():
    wf, params, _, _ = _exact_wavefunction()
    state = metropolis.init_sampler(jax.random.key(2), wf, params, N, 32)
    state = jax.jit(lambda s: mtm.run_sweeps(wf, params, s, 5, k=4))(state)
    amp = wf.apply(params, state.configs)
    np.testing.assert_allclose(np.asarray(state.log_amp),
                               np.asarray(amp.log), rtol=1e-5)


@pytest.mark.slow
@pytest.mark.parametrize('k', [2, 4])
def test_mtm_samples_born_distribution(k):
    """The decisive detailed-balance check: MTM chains must reproduce
    |ψ|² (TV distance vs the exact ground-state distribution)."""
    wf, params, _, v0 = _exact_wavefunction()
    state = metropolis.init_sampler(jax.random.key(3), wf, params, N, 256)
    warm = jax.jit(lambda s: mtm.run_sweeps(wf, params, s, 30, k=k))
    state = warm(state)

    top, bot = basis.make_lin_tables(N)
    top, bot = jnp.asarray(top), jnp.asarray(bot)
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    lin_of_enum = np.asarray(basis.lin_index(states, top, bot))
    enum_of_lin = np.empty_like(lin_of_enum)
    enum_of_lin[lin_of_enum] = np.arange(len(lin_of_enum))

    step = jax.jit(lambda s: mtm.run_sweeps(wf, params, s, 2, k=k))
    counts = np.zeros(len(v0))
    for _ in range(50):
        state = step(state)
        idx = np.asarray(basis.lin_index(state.configs, top, bot))
        np.add.at(counts, enum_of_lin[idx], 1)
    empirical = counts / counts.sum()
    exact = v0 ** 2 / np.sum(v0 ** 2)
    tv = 0.5 * np.abs(empirical - exact).sum()
    assert tv < 0.05, f'k={k}: TV distance {tv} too large'


@pytest.mark.slow
def test_mtm_energy_estimate():
    wf, params, e0, _ = _exact_wavefunction()
    ham = HeisenbergHamiltonian(BONDS)
    state = metropolis.init_sampler(jax.random.key(4), wf, params, N, 128)
    state = jax.jit(lambda s: mtm.run_sweeps(wf, params, s, 25, k=4))(state)
    e_loc = np.asarray(ham.local_value(wf, params, state.configs))
    np.testing.assert_allclose(e_loc.mean(), e0, rtol=1e-3)


def test_make_sweeps_fn_dispatches_to_mtm():
    """config.mtm_candidates > 1 routes training sweeps through MTM."""
    from cgs_vmc_jax.config import Config
    from cgs_vmc_jax.models import build_wavefunction
    from cgs_vmc_jax.optim.common import make_sweeps_fn
    config = Config(num_sites=N, wavefunction_type='fully_connected',
                    num_fc_layers=1, fc_layer_size=8, mtm_candidates=4)
    wf = build_wavefunction(config)
    params = wf.init(jax.random.key(9))
    sweeps = make_sweeps_fn(wf, config)
    state = metropolis.init_sampler(jax.random.key(10), wf, params, N, 16)
    out = jax.jit(lambda s: sweeps(params, s, 2))(state)
    # MTM counts one proposal per STEP (n_sites//k steps/sweep), unlike the
    # single-try sampler's n_sites proposals per sweep.
    assert float(out.num_proposed[0]) == 2 * (N // 4)
    amp = wf.apply(params, out.configs)
    np.testing.assert_allclose(np.asarray(out.log_amp),
                               np.asarray(amp.log), rtol=1e-4, atol=1e-6)


def test_mtm_acceptance_higher_than_single_try():
    """With k candidates the per-step acceptance should beat single-try
    on the same peaked wavefunction."""
    # Moderately peaked RBM to depress single-try acceptance.
    from cgs_vmc_jax.config import Config
    from cgs_vmc_jax.models import build_wavefunction
    config = Config(num_sites=N, wavefunction_type='rbm',
                    num_fc_layers=0, fc_layer_size=16)
    wf = build_wavefunction(config)
    params = wf.init(jax.random.key(8))
    params['hidden']['w'] = params['hidden']['w'] * 8.0  # peak it

    single = metropolis.init_sampler(jax.random.key(5), wf, params, N, 256)
    single = metropolis.jitted_sweeps(wf, params, single, 10)
    rate_single = float(metropolis.acceptance_rate(single))

    multi = metropolis.init_sampler(jax.random.key(5), wf, params, N, 256)
    multi = jax.jit(lambda s: mtm.run_sweeps(wf, params, s, 10, k=8))(multi)
    rate_multi = float(metropolis.acceptance_rate(multi))
    assert rate_multi > rate_single
