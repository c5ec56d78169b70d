"""Short training-descent checks across model families.

Convergence-to-ED is covered for RBM/FC/conv in test_training.py; here the
remaining families (residual, MPS, determinant) must at least train:
gradients flow, energy decreases, nothing NaNs.
"""

import numpy as np
import jax
import pytest

from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import EnergyGradientOptimizer

N = 8


@pytest.mark.slow
@pytest.mark.parametrize('wf_type,extra', [
    ('res_net_2d', dict(size_x=4, size_y=2, num_resnet_blocks=1,
                        num_conv_filters=4, kernel_size=3)),
    ('res_net_1d', dict(num_resnet_blocks=1, num_conv_filters=4,
                        kernel_size=3)),
    ('mps', dict(bond_dimension=4)),
    ('pbdg', {}),
    ('fully_connected_nnb', dict(num_fc_layers=1, fc_layer_size=8)),
    ('gnn', dict(num_conv_layers=2, num_conv_filters=4)),
])
def test_family_trains_and_energy_decreases(wf_type, extra):
    config = Config(
        num_sites=N, wavefunction_type=wf_type,
        batch_size=64, num_batches_per_epoch=2,
        num_equilibration_sweeps=3, num_monte_carlo_sweeps=1,
        learning_rates=[3e-3, 1e-3], learning_rate_stops=[100],
        optimizer='adam', heisenberg_jx=-1.0, seed=5,
        **extra)
    bonds = lattice.chain_bonds(N) if config.size_x <= 1 \
        else lattice.square_lattice_bonds(config.size_x, config.size_y)
    wf = build_wavefunction(config)
    ham = HeisenbergHamiltonian(bonds, -1.0, 1.0)
    opt = EnergyGradientOptimizer(wf, ham, config)
    state = opt.init_state(jax.random.key(1))
    epoch_fn = jax.jit(opt.epoch)
    energies = []
    for _ in range(40):
        state, metrics = epoch_fn(state)
        energies.append(float(metrics['energy']))
    assert np.isfinite(energies).all(), f'{wf_type}: NaN energies'
    early = np.mean(energies[:5])
    late = np.mean(energies[-5:])
    assert late < early - 0.05, (
        f'{wf_type}: no descent (early {early:.3f}, late {late:.3f})')


@pytest.mark.slow
def test_composite_product_trains():
    """'prod' composite (Jastrow-style product of two ansatzes) trains."""
    config = Config(
        num_sites=N, wavefunction_type='prod',
        composite_wavefunction_types=('rbm', 'fully_connected'),
        composite_output_activations=('exp', 'exp'),
        num_fc_layers=1, fc_layer_size=8,
        batch_size=64, num_batches_per_epoch=2,
        num_equilibration_sweeps=3, num_monte_carlo_sweeps=1,
        learning_rates=[3e-3, 1e-3], learning_rate_stops=[100],
        optimizer='adam', heisenberg_jx=-1.0, seed=6)
    bonds = lattice.chain_bonds(N)
    wf = build_wavefunction(config)
    ham = HeisenbergHamiltonian(bonds, -1.0, 1.0)
    opt = EnergyGradientOptimizer(wf, ham, config)
    state = opt.init_state(jax.random.key(2))
    epoch_fn = jax.jit(opt.epoch)
    energies = []
    for _ in range(40):
        state, metrics = epoch_fn(state)
        energies.append(float(metrics['energy']))
    assert np.isfinite(energies).all()
    assert np.mean(energies[-5:]) < np.mean(energies[:5]) - 0.05
