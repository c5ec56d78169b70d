"""Transverse-field Ising family: operator oracle, flip sampler, training.

BEYOND-REFERENCE: the reference has exactly one Hamiltonian (Heisenberg)
and an Sz-conserving sampler.  The TFIM (ops/ising.py) exercises the
LocalOperator protocol with a different connected set (single flips) and
the non-conserving 'flip' move over the full 2^N space.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.ising import TransverseFieldIsingHamiltonian
from cgs_vmc_jax.sampler import metropolis, registry
from cgs_vmc_jax.utils import ed


def _rbm_config(n, **kw):
    base = dict(num_sites=n, wavefunction_type='rbm', num_fc_layers=0,
                fc_layer_size=16, hamiltonian_type='ising',
                mc_move_type='flip', use_fast_sampler=False, seed=3)
    base.update(kw)
    return Config(**base)


@pytest.mark.slow
def test_local_value_matches_dense_matvec():
    """E_loc(R) == (H psi)(R) / psi(R) on every full-space basis state."""
    n = 6
    bonds = lattice.chain_bonds(n)
    ham = TransverseFieldIsingHamiltonian(bonds, h_x=0.9, j_zz=1.3)
    cfg = _rbm_config(n)
    wf = build_wavefunction(cfg)
    params = wf.init(jax.random.key(0))

    states = jnp.asarray(basis.enumerate_full_basis(n))
    amp = wf.apply(params, states)
    psi = np.asarray(amp.sign * jnp.exp(amp.log - jnp.max(amp.log)),
                     np.float64)
    h_mat = ed.ising_matrix(n, bonds, h_x=0.9, j_zz=1.3)
    expected = (h_mat @ psi) / psi

    e_loc = np.asarray(ham.local_value(wf, params, states), np.float64)
    np.testing.assert_allclose(e_loc, expected, rtol=1e-4, atol=1e-4)


@pytest.mark.slow
def test_local_value_2d_matches_sparse_matvec():
    """4x4 square TFIM near criticality (h/J ~ 3): E_loc against the
    sparse full-space matrix — the 2-D + sparse-oracle path."""
    n = 16
    bonds = lattice.square_lattice_bonds(4, 4)
    ham = TransverseFieldIsingHamiltonian(bonds, h_x=3.0, j_zz=1.0)
    cfg = _rbm_config(n, fc_layer_size=8, size_x=4, size_y=4)
    wf = build_wavefunction(cfg)
    params = wf.init(jax.random.key(8))

    states = jnp.asarray(basis.enumerate_full_basis(n))
    amp = wf.apply(params, states)
    psi = np.asarray(amp.sign * jnp.exp(amp.log - jnp.max(amp.log)),
                     np.float64)
    h_mat = ed.ising_matrix(n, bonds, h_x=3.0)   # CSR, dim 65536
    h_psi = h_mat @ psi

    idx = np.random.default_rng(0).choice(len(psi), 64, replace=False)
    expected = h_psi[idx] / psi[idx]
    e_loc = np.asarray(ham.local_value(wf, params, states[idx]), np.float64)
    np.testing.assert_allclose(e_loc, expected, rtol=1e-4, atol=1e-4)


def test_local_value_chunked_matches_unchunked():
    n = 6
    bonds = lattice.chain_bonds(n)
    cfg = _rbm_config(n)
    wf = build_wavefunction(cfg)
    params = wf.init(jax.random.key(1))
    configs = basis.random_spin_configurations(jax.random.key(2), n, 37)

    plain = TransverseFieldIsingHamiltonian(bonds, h_x=1.1)
    chunked = TransverseFieldIsingHamiltonian(bonds, h_x=1.1,
                                              sample_chunk=8)
    np.testing.assert_allclose(
        np.asarray(plain.local_value(wf, params, configs)),
        np.asarray(chunked.local_value(wf, params, configs)),
        rtol=1e-5, atol=1e-5)


def test_connected_set_shape_and_weights():
    n = 5
    ham = TransverseFieldIsingHamiltonian(lattice.chain_bonds(n), h_x=0.7)
    configs = basis.random_spin_configurations(jax.random.key(3), n, 4)
    flipped, weights = ham.connected(configs)
    assert flipped.shape == (4, n, n)
    assert weights.shape == (4, n)
    np.testing.assert_allclose(np.asarray(weights), -0.7)
    # Each connected config differs from its source in exactly one site.
    diff = np.asarray(flipped != configs[:, None, :]).sum(axis=-1)
    np.testing.assert_array_equal(diff, np.ones((4, n)))


def test_flip_sampler_reproduces_born_distribution():
    """Single-flip Metropolis samples |psi|^2 over the FULL 2^N space."""
    n = 6
    cfg = _rbm_config(n, batch_size=512)
    wf = build_wavefunction(cfg)
    params = wf.init(jax.random.key(4))

    states = jnp.asarray(basis.enumerate_full_basis(n))
    amp = wf.apply(params, states)
    log2 = 2.0 * np.asarray(amp.log, np.float64)
    born = np.exp(log2 - log2.max())
    born /= born.sum()

    state = metropolis.init_sampler_for(jax.random.key(5), wf, params, cfg)
    sweeps = jax.jit(
        lambda s: metropolis.run_sweeps(wf, params, s, 5, move='flip'))
    state = sweeps(state)  # equilibrate
    counts = np.zeros(2 ** n)
    weights = 2 ** np.arange(n)
    n_records = 40
    for _ in range(n_records):
        state = sweeps(state)
        idx = (((np.asarray(state.configs) + 1) / 2) @ weights).astype(int)
        np.add.at(counts, idx, 1.0)
    empirical = counts / counts.sum()
    tv = 0.5 * np.abs(empirical - born).sum()
    assert tv < 0.06, f'total variation {tv}'
    # The walk must explore multiple Sz sectors (exchange moves cannot).
    sz = np.asarray(state.configs).sum(axis=-1)
    assert len(np.unique(sz)) > 3


def test_flip_move_acceptance_and_stats():
    n = 8
    cfg = _rbm_config(n, batch_size=64)
    wf = build_wavefunction(cfg)
    params = wf.init(jax.random.key(6))
    state = metropolis.init_sampler_for(jax.random.key(7), wf, params, cfg)
    state = metropolis.run_sweeps(wf, params, state, 2, move='flip')
    assert float(jnp.sum(state.num_proposed)) == 64 * 2 * n
    acc = float(metropolis.acceptance_rate(state))
    assert 0.05 < acc <= 1.0
    assert jnp.all(jnp.abs(state.configs) == 1.0)


def test_registry_declines_fast_paths_on_flip_move():
    # MTM is explicitly requested but implements exchange moves only.
    cfg = _rbm_config(10, mtm_candidates=8, use_fast_sampler=True)
    wf = build_wavefunction(cfg)
    assert registry.resolved_name(wf, cfg) == 'generic'

    pb_cfg = Config(num_sites=10, wavefunction_type='pbdg',
                    mc_move_type='flip', use_fast_sampler=True)
    pb_wf = build_wavefunction(pb_cfg)
    assert registry.resolved_name(pb_wf, pb_cfg) == 'generic'


def test_build_hamiltonian_dispatch_and_ergodicity_validation():
    from cgs_vmc_jax.train import build_hamiltonian
    from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian

    ising_cfg = _rbm_config(8, ising_h=0.8, ising_j=1.2)
    ham = build_hamiltonian(ising_cfg)
    assert isinstance(ham, TransverseFieldIsingHamiltonian)
    assert ham.h_x == 0.8 and ham.j_zz == 1.2

    heis_cfg = Config(num_sites=8, wavefunction_type='rbm')
    assert isinstance(build_hamiltonian(heis_cfg), HeisenbergHamiltonian)

    with pytest.raises(ValueError, match='non-ergodic'):
        build_hamiltonian(_rbm_config(8, mc_move_type='exchange'))
    with pytest.raises(ValueError, match='Sz sector'):
        build_hamiltonian(Config(num_sites=8, wavefunction_type='rbm',
                                 mc_move_type='flip'))


def test_config_roundtrip_with_ising_fields(tmp_path):
    cfg = _rbm_config(8, ising_h=1.7)
    path = str(tmp_path / 'config.json')
    cfg.save(path)
    loaded = Config.load(path)
    assert loaded.hamiltonian_type == 'ising'
    assert loaded.mc_move_type == 'flip'
    assert loaded.ising_h == 1.7


def test_tfim_sr_reaches_ground_state_energy():
    """N=8 chain at the critical point h=J=1: RBM + dense minSR lands on
    the ED ground-state energy (the LocalOperator + flip-move stack works
    end to end)."""
    from cgs_vmc_jax.optim.sr import StochasticReconfiguration

    n = 8
    bonds = lattice.chain_bonds(n)
    cfg = _rbm_config(n, fc_layer_size=16, batch_size=256,
                      num_batches_per_epoch=2, num_equilibration_sweeps=3,
                      num_monte_carlo_sweeps=1,
                      learning_rates=[0.05, 0.02], learning_rate_stops=[60],
                      optimizer='gradient', sr_diag_shift=1e-2,
                      sr_solver='dense', sr_delta_clip=1.0, seed=11)
    wf = build_wavefunction(cfg)
    ham = TransverseFieldIsingHamiltonian(bonds, h_x=1.0, j_zz=1.0)
    opt = StochasticReconfiguration(wf, ham, cfg)
    state = opt.init_state(jax.random.key(cfg.seed))
    epoch_fn = jax.jit(opt.epoch)
    energies = []
    for _ in range(120):
        state, metrics = epoch_fn(state)
        energies.append(float(metrics['energy']))

    e_exact, _ = ed.ising_ground_state(n, bonds, h_x=1.0, j_zz=1.0)
    tail = np.mean(energies[-20:])
    rel = abs(tail - e_exact) / abs(e_exact)
    assert rel < 5e-3, f'rel err {rel} (E={tail} vs ED {e_exact})'
