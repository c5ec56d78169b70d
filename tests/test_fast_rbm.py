"""Tests for the fast-RBM sampler adapter."""

import functools

import numpy as np
import jax
import pytest

from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.sampler import fast_rbm, kernels, metropolis

N = 8
INTERPRETED = functools.partial(kernels.rbm_sweeps, interpret=True)


def _pure_rbm():
    config = Config(num_sites=N, wavefunction_type='rbm',
                    num_fc_layers=0, fc_layer_size=16)
    wf = build_wavefunction(config)
    return wf, wf.init(jax.random.key(0))


def test_supports():
    wf, _ = _pure_rbm()
    assert fast_rbm.supports(wf)
    config = Config(num_sites=N, wavefunction_type='rbm',
                    num_fc_layers=2, fc_layer_size=16)
    assert not fast_rbm.supports(build_wavefunction(config))
    config = Config(num_sites=N, wavefunction_type='fully_connected')
    assert not fast_rbm.supports(build_wavefunction(config))


@pytest.mark.slow
def test_cache_matches_model_apply():
    wf, params = _pure_rbm()
    state = metropolis.init_sampler(jax.random.key(1), wf, params, N, 32)
    state = fast_rbm.run_sweeps(wf, params, state, 5, sweeps_fn=INTERPRETED)
    amp = wf.apply(params, state.configs)
    np.testing.assert_allclose(np.asarray(state.log_amp),
                               np.asarray(amp.log), rtol=1e-4, atol=1e-4)
    configs = np.asarray(state.configs)
    assert set(np.unique(configs)) <= {-1.0, 1.0}
    np.testing.assert_array_equal(configs.sum(axis=1), np.zeros(32))
    assert float(state.num_proposed[0]) == 5 * N


def test_training_with_fast_sampler_converges():
    """EnergyGradient on a pure RBM reaches the N=8 chain ground state
    (Marshall gauge) through the registry's sampler for this backend."""
    import pytest
    pytest.importorskip('scipy')
    from cgs_vmc_jax import lattice
    from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
    from cgs_vmc_jax.optim import EnergyGradientOptimizer
    from cgs_vmc_jax.utils import ed

    config = Config(num_sites=N, wavefunction_type='rbm',
                    num_fc_layers=0, fc_layer_size=16,
                    batch_size=128, num_batches_per_epoch=5,
                    num_equilibration_sweeps=5, num_monte_carlo_sweeps=1,
                    learning_rates=[5e-3, 1e-3], learning_rate_stops=[120],
                    optimizer='adam', heisenberg_jx=-1.0,
                    use_fast_sampler=True, seed=2)
    bonds = lattice.chain_bonds(N)
    e0, _ = ed.ground_state(N, bonds, j_x=-1.0)
    wf = build_wavefunction(config)
    assert fast_rbm.supports(wf)
    ham = HeisenbergHamiltonian(bonds, -1.0, 1.0)
    opt = EnergyGradientOptimizer(wf, ham, config)
    state = opt.init_state(jax.random.key(1))
    epoch_fn = jax.jit(opt.epoch)
    for _ in range(150):
        state, metrics = epoch_fn(state)
    energy = float(metrics['energy'])
    assert abs(energy - e0) / abs(e0) < 0.05
    assert float(metrics['acceptance_rate']) > 0.05


@pytest.mark.slow
def test_stats_accumulate():
    wf, params = _pure_rbm()
    state = metropolis.init_sampler(jax.random.key(2), wf, params, N, 16)
    state = fast_rbm.run_sweeps(wf, params, state, 2, sweeps_fn=INTERPRETED)
    state = fast_rbm.run_sweeps(wf, params, state, 3, sweeps_fn=INTERPRETED)
    assert float(state.num_proposed[0]) == 5 * N
    rate = float(metropolis.acceptance_rate(state))
    assert 0.0 <= rate <= 1.0


@pytest.mark.slow
def test_fast_path_advances_all_chain_keys():
    """The fast path draws its randomness from keys[0] but must advance
    EVERY chain's key, so a later switch to the generic sampler never
    re-enters pre-fast-path streams (aliasing hazard)."""
    wf, params = _pure_rbm()
    state = metropolis.init_sampler(jax.random.key(7), wf, params, N, 8)
    before = np.asarray(jax.random.key_data(state.keys))
    out = fast_rbm.run_sweeps(wf, params, state, 2, sweeps_fn=INTERPRETED)
    after = np.asarray(jax.random.key_data(out.keys))
    # every chain's key changed, and all keys remain distinct
    assert (before != after).any(axis=-1).all()
    assert len({tuple(k) for k in after.tolist()}) == after.shape[0]


def test_fast_rbm_rejects_off_sector_state():
    """Half-filling guard: off-sector chains would bias detailed balance
    silently; must be a loud error instead."""
    import jax.numpy as jnp
    wf, params = _pure_rbm()
    state = metropolis.init_sampler(jax.random.key(7), wf, params, N, 4)
    bad = state._replace(configs=jnp.ones_like(state.configs))
    with pytest.raises(ValueError, match='Sz=0'):
        fast_rbm.run_sweeps(wf, params, bad, 1, sweeps_fn=INTERPRETED)


@pytest.mark.parametrize('impl', ['kernel', 'xla'])
def test_adapter_matches_model_apply_and_counts(impl):
    """Both sweep implementations through the adapter: the logψ cache
    equals wf.apply (onsite bias folded back in), Sz stays 0 and the
    proposal count is num_sweeps * n_sites per chain."""
    fn = {'kernel': INTERPRETED, 'xla': kernels.rbm_sweeps_xla}[impl]
    wf, params = _pure_rbm()
    state = metropolis.init_sampler(jax.random.key(3), wf, params, N, 6)
    state = fast_rbm.run_sweeps(wf, params, state, 2, sweeps_fn=fn)
    amp = wf.apply(params, state.configs)
    np.testing.assert_allclose(np.asarray(state.log_amp),
                               np.asarray(amp.log), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(np.asarray(state.configs).sum(axis=1),
                                  np.zeros(6))
    assert float(state.num_proposed[0]) == 2 * N
