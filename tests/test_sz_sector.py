"""Fixed-Sz-sector sampling beyond Sz=0: init invariants + the spin gap.

The reference hardcoded the Sz=0 sector (cgs_vmc/utils.py:169-192); the
exchange move conserves Sz, so supporting other sectors is purely an
initializer/bookkeeping concern — and it buys a real capability: the
triplet (spin) gap from a direct ground-state search in the Sz=1 sector,
cross-checked here against sector ED.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import FullVector, build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
from cgs_vmc_jax.sampler import metropolis, registry
from cgs_vmc_jax.utils import ed

N = 8
JX = -1.0
BONDS = lattice.chain_bonds(N)


def test_random_configurations_sector():
    configs = basis.random_configurations(jax.random.key(0), N, 64,
                                          n_down=3)
    np.testing.assert_array_equal(np.unique(np.abs(configs)), [1.0])
    np.testing.assert_array_equal(np.asarray(configs.sum(axis=-1)),
                                  np.full(64, N - 2 * 3))


def test_n_down_for_validation():
    assert basis.n_down_for(8, 0) == 4
    assert basis.n_down_for(8, 2) == 3
    assert basis.n_down_for(9, 1) == 4
    with pytest.raises(ValueError):
        basis.n_down_for(8, 1)      # parity mismatch
    with pytest.raises(ValueError):
        basis.n_down_for(8, 10)     # out of range


def test_flip_move_rejects_sector():
    config = Config(num_sites=N, wavefunction_type='rbm', fc_layer_size=8,
                    total_sz2=2, mc_move_type='flip', batch_size=16)
    wf = build_wavefunction(config)
    params = wf.init(jax.random.key(0))
    with pytest.raises(ValueError, match='total_sz2'):
        metropolis.init_sampler_for(jax.random.key(1), wf, params, config)


def test_sweeps_conserve_nonzero_sector():
    config = Config(num_sites=N, wavefunction_type='rbm', num_fc_layers=1,
                    fc_layer_size=8, total_sz2=2, batch_size=32)
    wf = build_wavefunction(config)
    params = wf.init(jax.random.key(0))
    state = metropolis.init_sampler_for(jax.random.key(1), wf, params,
                                        config)
    np.testing.assert_array_equal(np.asarray(state.configs.sum(axis=-1)),
                                  np.full(32, 2))
    state = metropolis.run_sweeps(wf, params, state, 10)
    np.testing.assert_array_equal(np.asarray(state.configs.sum(axis=-1)),
                                  np.full(32, 2))
    assert float(metropolis.acceptance_rate(state)) > 0.0


def test_half_filling_fast_paths_decline_off_sector():
    config = Config(num_sites=N, wavefunction_type='rbm', num_fc_layers=1,
                    fc_layer_size=8, total_sz2=2)
    wf = build_wavefunction(config)
    # The Pallas RBM kernel ranks exactly n//2 down spins; off the Sz=0
    # sector it must fall through to the generic sampler (on any backend).
    assert registry.resolved_name(wf, config) == 'generic'

    made_cfg = Config(num_sites=N, wavefunction_type='made',
                      num_fc_layers=1, fc_layer_size=8, total_sz2=2)
    made = build_wavefunction(made_cfg)
    assert registry.resolved_name(made, made_cfg) == 'generic'


@pytest.mark.slow
def test_triplet_gap_from_sz1_sector():
    """Ground-state search in the Sz=1 sector == the lowest triplet, so
    E(Sz=1) − E(Sz=0) is the spin gap; both sector energies pinned to ED."""
    mat1 = ed.heisenberg_matrix(N, BONDS, j_x=JX, n_down=3)
    e1_exact = float(np.linalg.eigvalsh(mat1)[0])
    e0_exact, _ = ed.ground_state(N, BONDS, j_x=JX)
    assert e1_exact > e0_exact  # AFM chain has a finite-size spin gap

    # Trainable dense vector in the n_down=3 sector (exactly expressive).
    dim = basis.enumerate_sz_basis(N, 3).shape[0]
    rng = np.random.default_rng(0)
    init = rng.uniform(0.5, 1.5, size=dim).astype(np.float32)
    wf = FullVector.for_sector(N, init, n_up=N - 3)

    config = Config(
        num_sites=N, total_sz2=2, batch_size=256,
        num_batches_per_epoch=4, num_equilibration_sweeps=5,
        num_monte_carlo_sweeps=1, optimizer='gradient',
        learning_rates=[0.05, 0.02], learning_rate_stops=[60],
        sr_diag_shift=1e-2, heisenberg_jx=JX, seed=3)
    ham = HeisenbergHamiltonian(BONDS, JX, 1.0)
    opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, config)
    state = opt.init_state(jax.random.key(4))
    epoch_fn = jax.jit(opt.epoch)
    energies = []
    for _ in range(90):
        state, metrics = epoch_fn(state)
        energies.append(float(metrics['energy']))
    tail = float(np.mean(energies[-15:]))
    gap = e1_exact - e0_exact
    assert abs(tail - e1_exact) < 0.25 * gap, (tail, e1_exact, gap)
    # And it is genuinely the triplet, not the global (singlet) ground
    # state leaking through a sector bug.
    assert tail > e0_exact + 0.5 * gap
