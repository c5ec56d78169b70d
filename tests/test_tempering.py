"""Parallel-tempering oracle tests: physical and tempered marginals
against exact distributions, swap bookkeeping, registry dispatch, mesh
sharding, and a barrier-crossing demonstration the single-temperature
sampler fails."""

import pytest
import numpy as np
import jax
import jax.numpy as jnp

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.sampler import metropolis, registry, tempering

N = 8


def _rbm_config(**kw):
    base = dict(num_sites=N, wavefunction_type='rbm', num_fc_layers=0,
                fc_layer_size=12, batch_size=256, use_fast_sampler=False,
                pt_replicas=3, pt_beta_min=0.3, seed=3)
    base.update(kw)
    return Config(**base)


def _sector_probs(wf, params, beta=1.0):
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    amp = wf.apply(params, states)
    log2 = 2.0 * beta * np.asarray(amp.log, np.float64)
    p = np.exp(log2 - log2.max())
    return states, p / p.sum()


def _index_of(configs, states):
    lookup = {tuple(np.asarray(s, np.int8)): i
              for i, s in enumerate(np.asarray(states))}
    return np.asarray([lookup[tuple(np.asarray(c, np.int8))]
                       for c in np.asarray(configs)])


def test_geometric_ladder_endpoints_and_validation():
    ladder = np.asarray(tempering.geometric_ladder(4, 0.25))
    np.testing.assert_allclose(ladder[0], 1.0, rtol=1e-6)
    np.testing.assert_allclose(ladder[-1], 0.25, rtol=1e-6)
    assert np.all(np.diff(ladder) < 0)
    import pytest
    with pytest.raises(ValueError):
        tempering.geometric_ladder(1, 0.5)
    with pytest.raises(ValueError):
        tempering.geometric_ladder(3, 1.5)


def test_registry_dispatches_to_tempering():
    cfg = _rbm_config()
    wf = build_wavefunction(cfg)
    assert registry.resolved_name(wf, cfg) == 'tempering'
    assert registry.resolved_name(wf, cfg.replace(pt_replicas=0)) != \
        'tempering'


@pytest.mark.slow
def test_physical_replica_samples_born_distribution():
    """The beta=1 replica must still sample |psi|^2 exactly — swaps are a
    valid MCMC move on the joint ladder distribution."""
    cfg = _rbm_config()
    wf = build_wavefunction(cfg)
    params = wf.init(jax.random.key(0))
    states, born = _sector_probs(wf, params)

    state = metropolis.init_sampler_for(jax.random.key(1), wf, params, cfg)
    assert isinstance(state, tempering.PTSamplerState)
    sweeps = jax.jit(lambda s: tempering.run_sweeps(wf, params, s, 5))
    state = sweeps(state)  # equilibrate
    counts = np.zeros(len(states))
    for _ in range(30):
        state = sweeps(state)
        np.add.at(counts, _index_of(state.configs, states), 1.0)
    empirical = counts / counts.sum()
    tv = 0.5 * np.abs(empirical - born).sum()
    assert tv < 0.05, f'TV distance {tv} too large'


def test_tempered_replica_samples_flattened_distribution():
    """The coldest aux replica samples |psi|^(2*beta_min), not |psi|^2."""
    cfg = _rbm_config(pt_replicas=2, pt_beta_min=0.3)
    wf = build_wavefunction(cfg)
    params = wf.init(jax.random.key(7))
    states, born_beta = _sector_probs(wf, params, beta=0.3)
    _, born_phys = _sector_probs(wf, params, beta=1.0)

    state = metropolis.init_sampler_for(jax.random.key(8), wf, params, cfg)
    sweeps = jax.jit(lambda s: tempering.run_sweeps(wf, params, s, 5))
    state = sweeps(state)
    counts = np.zeros(len(states))
    for _ in range(30):
        state = sweeps(state)
        np.add.at(counts, _index_of(state.aux_configs[:, 0], states), 1.0)
    empirical = counts / counts.sum()
    tv_beta = 0.5 * np.abs(empirical - born_beta).sum()
    tv_phys = 0.5 * np.abs(empirical - born_phys).sum()
    assert tv_beta < 0.05, f'TV to |psi|^(2b) {tv_beta} too large'
    assert tv_beta < tv_phys, 'tempered replica closer to |psi|^2 than ' \
        'to its own target'


@pytest.mark.slow
def test_swap_bookkeeping_and_rates():
    cfg = _rbm_config(batch_size=64)
    wf = build_wavefunction(cfg)
    params = wf.init(jax.random.key(2))
    state = metropolis.init_sampler_for(jax.random.key(3), wf, params, cfg)
    n_sweeps = 6
    state = jax.jit(
        lambda s: tempering.run_sweeps(wf, params, s, n_sweeps))(state)
    # Each sweep proposes every pair of matching parity exactly once:
    # pair 0 on even sweeps, pair 1 on odd sweeps -> 3 proposals each.
    prop = np.asarray(state.swap_proposed)
    assert prop.shape == (64, 2)
    np.testing.assert_array_equal(prop, np.full((64, 2), n_sweeps / 2))
    rates = np.asarray(tempering.swap_rate(state))
    assert np.all(rates >= 0) and np.all(rates <= 1)
    assert rates.max() > 0.05, 'no swaps ever accepted — ladder broken?'
    # Physical-move counters count only replica 0's proposals.
    np.testing.assert_array_equal(np.asarray(state.num_proposed),
                                  np.full(64, n_sweeps * N))


@pytest.mark.slow
def test_refresh_and_reset_dispatch():
    cfg = _rbm_config(batch_size=32)
    wf = build_wavefunction(cfg)
    params = wf.init(jax.random.key(4))
    state = metropolis.init_sampler_for(jax.random.key(5), wf, params, cfg)
    state = jax.jit(lambda s: tempering.run_sweeps(wf, params, s, 2))(state)

    params2 = jax.tree.map(lambda p: p * 1.1, params)
    refreshed = metropolis.refresh_amplitudes(wf, params2, state)
    amp = wf.apply(params2, refreshed.configs)
    np.testing.assert_allclose(np.asarray(refreshed.log_amp),
                               np.asarray(amp.log), rtol=1e-5)
    flat_aux = refreshed.aux_configs.reshape(-1, N)
    aux_amp = wf.apply(params2, flat_aux)
    np.testing.assert_allclose(np.asarray(refreshed.aux_log).reshape(-1),
                               np.asarray(aux_amp.log), rtol=1e-5)

    cleared = metropolis.reset_stats(refreshed)
    assert float(jnp.sum(cleared.num_proposed)) == 0
    assert float(jnp.sum(cleared.swap_proposed)) == 0


@pytest.mark.slow
def test_pt_crosses_barrier_single_temperature_cannot():
    """Two spin configurations far apart in exchange-move distance carry
    ~all of |psi|^2; chains start in mode A.  Single-temperature chains
    stay trapped; the tempered ladder ferries chains to mode B."""
    from cgs_vmc_jax.models import FullVector

    states = np.asarray(basis.enumerate_sz_basis(N))
    mode_a = np.asarray([1, 1, 1, 1, -1, -1, -1, -1], np.float32)
    mode_b = -mode_a
    idx_a = int(np.where((states == mode_a).all(axis=1))[0][0])
    idx_b = int(np.where((states == mode_b).all(axis=1))[0][0])
    vec = np.full(len(states), 1e-4, np.float64)
    vec[idx_a] = 1.0
    vec[idx_b] = 1.0
    wf = FullVector.for_sector(N, jnp.asarray(vec, jnp.float32))
    params = wf.init(jax.random.key(0))

    n_chains = 64
    start = jnp.broadcast_to(jnp.asarray(mode_a), (n_chains, N))
    amp0 = wf.apply(params, start)

    def in_mode_b(configs):
        return float(jnp.mean(jnp.all(
            configs == jnp.asarray(mode_b), axis=-1)))

    # Single temperature: replace the chains with mode A and sweep.
    cfg1 = _rbm_config(pt_replicas=0, batch_size=n_chains)
    s1 = metropolis.init_sampler_for(jax.random.key(1), wf, params, cfg1)
    s1 = s1._replace(configs=start, log_amp=amp0.log, sign=amp0.sign)
    s1 = jax.jit(lambda s: metropolis.run_sweeps(wf, params, s, 60))(s1)

    # Tempering: same start in every replica of every chain.
    cfg2 = _rbm_config(pt_replicas=4, pt_beta_min=0.1,
                       batch_size=n_chains)
    s2 = metropolis.init_sampler_for(jax.random.key(1), wf, params, cfg2)
    aux_start = jnp.broadcast_to(start[:, None, :], s2.aux_configs.shape)
    aux_amp = wf.apply(params, aux_start.reshape(-1, N))
    s2 = s2._replace(
        configs=start, log_amp=amp0.log, sign=amp0.sign,
        aux_configs=aux_start,
        aux_log=aux_amp.log.reshape(s2.aux_log.shape),
        aux_sign=aux_amp.sign.reshape(s2.aux_sign.shape))
    s2 = jax.jit(lambda s: tempering.run_sweeps(wf, params, s, 60))(s2)

    frac_single = in_mode_b(s1.configs)
    frac_pt = in_mode_b(s2.configs)
    assert frac_single < 0.05, (
        f'barrier too low for the demonstration: {frac_single}')
    assert frac_pt > 0.2, (
        f'tempering failed to cross the barrier: {frac_pt}')


def test_sr_epoch_with_tempering_descends():
    """End-to-end: SR training with pt_replicas=2 runs through the
    standard optimizer path (init/refresh/sweeps dispatch) and lowers
    the energy."""
    from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
    cfg = _rbm_config(
        batch_size=64, num_batches_per_epoch=2, pt_replicas=2,
        num_equilibration_sweeps=2, num_monte_carlo_sweeps=1,
        wavefunction_optimizer_type='SR', heisenberg_jx=-1.0,
        sr_diag_shift=1e-2, sr_solver='dense',
        learning_rates=[0.05], learning_rate_stops=[],
        optimizer='gradient')
    wf = build_wavefunction(cfg)
    ham = HeisenbergHamiltonian(lattice.chain_bonds(N), -1.0, 1.0)
    opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
    state = opt.init_state(jax.random.key(6))
    assert isinstance(state.sampler, tempering.PTSamplerState)
    epoch_fn = jax.jit(opt.epoch)
    state, m0 = epoch_fn(state)
    for _ in range(25):
        state, m = epoch_fn(state)
    assert float(m['energy']) < float(m0['energy'])
    assert 0.0 < float(m['acceptance_rate']) <= 1.0


def test_dual_sampling_swo_with_tempering():
    """DualSamplingSWO drives BOTH sampler states through the registry,
    so its frozen-target chains keep their PT ladder intact."""
    from cgs_vmc_jax.optim import SUPERVISED_OPTIMIZERS
    cfg = _rbm_config(
        batch_size=64, num_batches_per_epoch=2, pt_replicas=2,
        num_equilibration_sweeps=1, num_monte_carlo_sweeps=1,
        learning_rates=[0.01], learning_rate_stops=[], optimizer='adam')
    wf = build_wavefunction(cfg)
    target_wf = build_wavefunction(cfg)
    target_params = target_wf.init(jax.random.key(11))
    opt = SUPERVISED_OPTIMIZERS['DualSamplingSWO'](wf, target_wf, cfg)
    state = opt.init_state(jax.random.key(12), target_params)
    assert isinstance(state.extra['target_sampler'],
                      tempering.PTSamplerState)
    state, metrics = jax.jit(opt.epoch)(state)
    assert np.isfinite(float(metrics['loss']))
    assert isinstance(state.extra['target_sampler'],
                      tempering.PTSamplerState)


def test_pt_state_shards_over_chain_mesh():
    """All PTSamplerState leaves are chain-leading, so the canonical
    mesh sharding (every sampler leaf on its leading axis) applies."""
    from cgs_vmc_jax.parallel import mesh as pmesh
    if len(jax.devices()) < 8:
        import pytest
        pytest.skip('needs the 8-device virtual mesh')
    from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
    cfg = _rbm_config(
        batch_size=64, num_batches_per_epoch=2, pt_replicas=3,
        num_equilibration_sweeps=1, num_monte_carlo_sweeps=1,
        wavefunction_optimizer_type='SR', heisenberg_jx=-1.0,
        sr_diag_shift=1e-2, sr_solver='dense',
        learning_rates=[0.05], learning_rate_stops=[],
        optimizer='gradient')
    wf = build_wavefunction(cfg)
    ham = HeisenbergHamiltonian(lattice.chain_bonds(N), -1.0, 1.0)
    opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
    state = opt.init_state(jax.random.key(9))
    mesh = pmesh.make_mesh(8)
    state = pmesh.shard_train_state(state, mesh)
    epoch_fn = pmesh.sharded_epoch_fn(
        opt.epoch, mesh, state,
        ['energy', 'energy_variance', 'acceptance_rate', 'grad_norm',
         'sr_residual_norm'])
    state, metrics = epoch_fn(state)
    assert np.isfinite(float(metrics['energy']))
