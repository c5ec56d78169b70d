"""Jastrow ansatz (models/jastrow.py) + incremental sampler (fast_jastrow).

Oracles: brute-force quadratic form for the amplitude; full-forward
differences for the exact O(n) delta; exact |psi|^2 enumeration for the
sampled distribution; the generic sampler for trajectory agreement
(identical key discipline -> identical picks)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import basis
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.models.jastrow import JastrowWavefunction
from cgs_vmc_jax.sampler import fast_jastrow, metropolis, registry

N = 8
CHAINS = 64


def _setup(seed=0, chains=CHAINS, n=N):
    wf = JastrowWavefunction(n)
    params = wf.init(jax.random.key(seed))
    # Non-trivial couplings so acceptance is neither 0 nor 1.
    params['pair']['w'] = 0.3 * jax.random.normal(
        jax.random.key(seed + 5), (n, n), jnp.float32)
    state = metropolis.init_sampler(jax.random.key(seed + 1), wf, params,
                                    n, chains)
    return wf, params, state


def test_apply_matches_quadratic_form():
    wf, params, state = _setup()
    s = np.asarray(state.configs, np.float64)
    w = np.asarray(params['pair']['w'], np.float64)
    sym = 0.5 * (w + w.T)
    b = np.asarray(params['onsite']['b'], np.float64)
    want = 0.5 * np.einsum('bi,ij,bj->b', s, sym, s) + s @ b
    amp = wf.apply(params, state.configs)
    np.testing.assert_allclose(np.asarray(amp.log), want, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(np.asarray(amp.sign), 1.0)


def test_delta_matches_full_forward():
    """The closed-form exchange delta equals log psi' - log psi for random
    down/up exchanges."""
    wf, params, state = _setup(seed=2)
    sym = JastrowWavefunction.symmetric_pair(params)
    b = params['onsite']['b']
    base = wf.apply(params, state.configs).log
    rng = np.random.default_rng(4)
    s = np.asarray(state.configs)
    for _ in range(10):
        down, up = [], []
        for c in range(CHAINS):
            down.append(rng.choice(np.where(s[c] < 0)[0]))
            up.append(rng.choice(np.where(s[c] > 0)[0]))
        down = jnp.asarray(down, jnp.int32)
        up = jnp.asarray(up, jnp.int32)
        chains = jnp.arange(CHAINS)
        flipped = (state.configs.at[chains, down].set(1.0)
                   .at[chains, up].set(-1.0))
        want = wf.apply(params, flipped).log - base

        rows_d = jnp.take(sym, down, axis=0)
        rows_u = jnp.take(sym, up, axis=0)
        got = (2.0 * jnp.sum(rows_d * state.configs, axis=-1)
               - 2.0 * jnp.sum(rows_u * state.configs, axis=-1)
               + 2.0 * rows_d[chains, down] + 2.0 * rows_u[chains, up]
               - 4.0 * rows_d[chains, up]
               + 2.0 * jnp.take(b, down) - 2.0 * jnp.take(b, up))
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


def test_fast_jastrow_invariants():
    wf, params, state = _setup(seed=3)
    out = fast_jastrow.run_sweeps(wf, params, state, 3)
    assert float(out.num_proposed.sum()) == CHAINS * 3 * N
    # Sz conserved, spins stay +-1.
    np.testing.assert_array_equal(np.asarray(out.configs.sum(-1)),
                                  np.zeros(CHAINS))
    assert set(np.unique(np.asarray(out.configs))) <= {-1.0, 1.0}
    # log_amp refreshed exactly at call end.
    np.testing.assert_allclose(np.asarray(out.log_amp),
                               np.asarray(wf.apply(params, out.configs).log),
                               rtol=1e-6, atol=1e-6)
    # All chain keys advanced.
    assert not np.any(np.asarray(jax.random.key_data(out.keys))
                      == np.asarray(jax.random.key_data(state.keys)))


def test_fast_jastrow_matches_generic_trajectories():
    """Same key discipline as metropolis.mc_step -> identical picks; with
    f64 scoring both samplers walk the same trajectory exactly."""
    wf, params, state = _setup(seed=6)
    gen = metropolis.run_sweeps(wf, params, state, 2)
    fast = fast_jastrow.run_sweeps(wf, params, state, 2)
    # f32 rounding can flip knife-edge accepts; demand near-total
    # agreement rather than bitwise equality.
    agree = np.mean(np.all(np.asarray(gen.configs)
                           == np.asarray(fast.configs), axis=-1))
    assert agree > 0.9, f'trajectory agreement {agree}'
    np.testing.assert_allclose(np.asarray(fast.num_proposed),
                               np.asarray(gen.num_proposed))


def test_fast_jastrow_samples_born_distribution():
    wf, params, _ = _setup(seed=7)
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    log = np.asarray(wf.apply(params, states).log, np.float64)
    exact = np.exp(2 * (log - log.max()))
    exact /= exact.sum()

    chains = 256
    state = metropolis.init_sampler(jax.random.key(11), wf, params, N,
                                    chains)
    top, bot = basis.make_lin_tables(N)
    all_lin = np.asarray(basis.lin_index(states, top, bot))
    enum_of_lin = np.empty_like(all_lin)
    enum_of_lin[all_lin] = np.arange(len(all_lin))

    run = jax.jit(lambda s: fast_jastrow.run_sweeps(wf, params, s, 2))
    counts = np.zeros(states.shape[0])
    for it in range(60):
        state = run(state)
        if it >= 12:
            idx = np.asarray(basis.lin_index(state.configs, top, bot))
            np.add.at(counts, enum_of_lin[idx], 1)
    empirical = counts / counts.sum()
    tv = 0.5 * np.abs(empirical - exact).sum()
    assert tv < 0.08, f'TV distance {tv} too large'


def test_dispatch_selects_jastrow_delta():
    wf, params, state = _setup(seed=9)
    cfg = Config(num_sites=N, wavefunction_type='jastrow')
    assert registry.resolved_name(wf, cfg) == 'jastrow_delta'
    # Symmetrized wrapper or non-log output -> generic.
    from cgs_vmc_jax.models.symmetry import SymmetrizedWavefunction
    wf_sym = SymmetrizedWavefunction(
        wf, np.arange(N, dtype=np.int32)[None, :], spin_flip=True)
    assert registry.resolved_name(wf_sym, cfg) == 'generic'
    assert registry.resolved_name(
        JastrowWavefunction(N, output_activation='cos'), cfg) == 'generic'
    # And the knob turns it off.
    assert registry.resolved_name(
        wf, cfg.replace(use_fast_sampler=False)) == 'generic'


def test_jastrow_trains_toward_ground_state():
    """SR on the Marshall-gauged N=8 chain: the Jastrow baseline descends
    well below the initial energy (it cannot reach the CNN floor — it is
    a two-body ansatz — but must capture most of the correlation)."""
    from cgs_vmc_jax import lattice
    from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
    from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
    from cgs_vmc_jax.utils import ed

    cfg = Config(num_sites=N, wavefunction_type='jastrow',
                 wavefunction_optimizer_type='SR',
                 batch_size=256, num_batches_per_epoch=1,
                 num_equilibration_sweeps=3, num_monte_carlo_sweeps=1,
                 learning_rates=[0.05], learning_rate_stops=[],
                 optimizer='gradient', heisenberg_jx=-1.0,
                 sr_diag_shift=1e-2, sr_solver='dense',
                 sr_delta_clip=1.0, seed=1)
    wf = build_wavefunction(cfg)
    ham = HeisenbergHamiltonian(lattice.chain_bonds(N), -1.0, 1.0)
    opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
    state = opt.init_state(jax.random.key(cfg.seed))
    epoch = jax.jit(opt.epoch)
    energies = []
    for _ in range(60):
        state, metrics = epoch(state)
        energies.append(float(metrics['energy']))
    e0, _ = ed.ground_state(N, lattice.chain_bonds(N), -1.0, 1.0)
    late = np.mean(energies[-10:])
    rel = abs(late - e0) / abs(e0)
    assert rel < 0.05, f'Jastrow stalled at rel err {rel}'


def test_jastrow_network_product_composite():
    """The standard Jastrow x network construction through the 'prod'
    composite builds, applies finitely, and matches the sum of the
    factors' logs."""
    cfg = Config(num_sites=16, size_x=4, size_y=4,
                 wavefunction_type='prod',
                 composite_wavefunction_types=('jastrow', 'conv_2d'),
                 composite_output_activations=('exp', 'exp'),
                 num_conv_layers=2, num_conv_filters=6, kernel_size=3)
    wf = build_wavefunction(cfg)
    params = wf.init(jax.random.key(0))
    configs = basis.random_configurations(jax.random.key(1), 16, 12)
    amp = wf.apply(params, configs)
    assert np.isfinite(np.asarray(amp.log)).all()
    # Product in log domain: log|psi| = log|psi_a| + log|psi_b|.
    log_a = wf._wf_a.apply(params['a'], configs).log
    log_b = wf._wf_b.apply(params['b'], configs).log
    np.testing.assert_allclose(np.asarray(amp.log),
                               np.asarray(log_a + log_b), rtol=1e-6)
