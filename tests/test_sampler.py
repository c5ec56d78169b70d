"""Statistical and invariant tests for the Metropolis exchange sampler."""

import numpy as np
import jax
import jax.numpy as jnp

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.models import FullVector
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.sampler import metropolis
from cgs_vmc_jax.utils import ed

N = 8
BONDS = lattice.chain_bonds(N)


def _exact_wavefunction():
    e0, v0 = ed.ground_state(N, BONDS)
    wf = FullVector.for_sector(N, v0.astype(np.float32))
    return wf, wf.init(jax.random.key(0)), e0, v0


def test_moves_conserve_sz_and_spin_values():
    wf, params, _, _ = _exact_wavefunction()
    state = metropolis.init_sampler(jax.random.key(1), wf, params, N, 64)
    state = metropolis.jitted_sweeps(wf, params, state, 10)
    configs = np.asarray(state.configs)
    assert set(np.unique(configs)) == {-1.0, 1.0}
    np.testing.assert_array_equal(configs.sum(axis=1), np.zeros(64))


def test_amplitude_cache_consistent_after_sweeps():
    wf, params, _, _ = _exact_wavefunction()
    state = metropolis.init_sampler(jax.random.key(1), wf, params, N, 32)
    state = metropolis.jitted_sweeps(wf, params, state, 5)
    amp = wf.apply(params, state.configs)
    np.testing.assert_allclose(np.asarray(state.log_amp),
                               np.asarray(amp.log), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(state.sign),
                                  np.asarray(amp.sign))


def test_sampler_reproduces_born_distribution():
    """Chains sample |psi|^2: chi^2-style TV distance against the exact
    ground-state distribution (SURVEY.md §4.3)."""
    wf, params, _, v0 = _exact_wavefunction()
    state = metropolis.init_sampler(jax.random.key(2), wf, params, N, 256)
    state = metropolis.jitted_sweeps(wf, params, state, 30)

    top, bot = basis.make_lin_tables(N)
    top, bot = jnp.asarray(top), jnp.asarray(bot)
    counts = np.zeros(len(v0))
    for _ in range(40):
        state = metropolis.jitted_sweeps(wf, params, state, 2)
        idx = np.asarray(basis.lin_index(state.configs, top, bot))
        np.add.at(counts, idx, 1)
    empirical = counts / counts.sum()
    exact = v0 ** 2 / np.sum(v0 ** 2)
    tv = 0.5 * np.abs(empirical - exact).sum()
    assert tv < 0.05, f'TV distance {tv} too large'


def test_local_energy_under_sampling_matches_e0():
    wf, params, e0, _ = _exact_wavefunction()
    ham = HeisenbergHamiltonian(BONDS)
    state = metropolis.init_sampler(jax.random.key(3), wf, params, N, 128)
    state = metropolis.jitted_sweeps(wf, params, state, 20)
    e_loc = np.asarray(ham.local_value(wf, params, state.configs))
    np.testing.assert_allclose(e_loc.mean(), e0, rtol=1e-3)


def test_acceptance_counting():
    wf, params, _, _ = _exact_wavefunction()
    state = metropolis.init_sampler(jax.random.key(4), wf, params, N, 32)
    state = metropolis.jitted_sweeps(wf, params, state, 3)
    assert float(jnp.sum(state.num_proposed)) == 32 * 3 * N
    rate = float(metropolis.acceptance_rate(state))
    assert 0.05 < rate < 0.95
    state = metropolis.reset_stats(state)
    assert float(jnp.sum(state.num_proposed)) == 0.0


def test_chains_are_independent():
    """Different chains follow different trajectories (per-chain RNG)."""
    wf, params, _, _ = _exact_wavefunction()
    state = metropolis.init_sampler(jax.random.key(5), wf, params, N, 64)
    state = metropolis.jitted_sweeps(wf, params, state, 10)
    accepted = np.asarray(state.num_accepted)
    assert len(np.unique(accepted)) > 3  # not lock-stepped


def test_rng_keys_advance_every_step():
    """RNG-key discipline (SURVEY §5.2 analog): every Metropolis step must
    consume and replace the per-chain keys — key reuse silently biases
    the physics."""
    wf, params, _, _ = _exact_wavefunction()
    state = metropolis.init_sampler(jax.random.key(7), wf, params, N, 16)
    keys0 = np.asarray(jax.random.key_data(state.keys))
    state1 = metropolis.mc_step(wf, params, state)
    keys1 = np.asarray(jax.random.key_data(state1.keys))
    assert not (keys0 == keys1).all(axis=-1).any(), 'a chain key was reused'
    state2 = metropolis.mc_step(wf, params, state1)
    keys2 = np.asarray(jax.random.key_data(state2.keys))
    assert not (keys1 == keys2).all(axis=-1).any()


def test_refresh_amplitudes():
    wf, params, _, _ = _exact_wavefunction()
    state = metropolis.init_sampler(jax.random.key(6), wf, params, N, 16)
    stale = state._replace(log_amp=state.log_amp + 123.0)
    fixed = metropolis.refresh_amplitudes(wf, params, stale)
    np.testing.assert_allclose(np.asarray(fixed.log_amp),
                               np.asarray(state.log_amp), rtol=1e-6)


def test_detailed_balance_two_site_toy():
    """SURVEY §4.3: the 2-site, Sz=0 toy has exactly two states; the
    exchange proposal is deterministic (swap), so the chain's empirical
    occupation must match |psi|² = (a², b²)/(a²+b²) exactly in
    distribution."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from cgs_vmc_jax.models import FullVector
    from cgs_vmc_jax.sampler import metropolis

    a, b = 2.0, 1.0
    wf = FullVector.for_sector(2, np.asarray([a, b], np.float32))
    params = wf.init(jax.random.key(0))
    state = metropolis.init_sampler(jax.random.key(1), wf, params, 2, 512)
    state = metropolis.jitted_sweeps(wf, params, state, 20)

    counts = np.zeros(2)
    for _ in range(60):
        state = metropolis.jitted_sweeps(wf, params, state, 1)
        first = np.asarray(state.configs[:, 0])
        counts[0] += np.sum(first > 0)
        counts[1] += np.sum(first < 0)
    empirical = counts / counts.sum()
    # enumerate_sz_basis order fixes which state is (+,-) vs (-,+); the
    # stationary distribution is symmetric in the labels we count.
    probs = np.asarray([a * a, b * b]) / (a * a + b * b)
    tv = 0.5 * np.abs(np.sort(empirical) - np.sort(probs)).sum()
    assert tv < 0.03, f'TV {tv}: empirical {empirical} vs {probs}'
