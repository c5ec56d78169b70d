"""12x12 sharded-Jacobian SR on the 8-device mesh (round-2 VERDICT #6).

The sample_cg solver exists precisely for lattices whose Jacobian cannot
be gathered on one device; this exercises it END-TO-END at 12x12 (144
sites, 288 bonds) — the scale it was built for — on the virtual CPU mesh:
(a) the sharded solve equals the single-device solve at real shapes, and
(b) full sharded SR epochs (sweeps + fused local energy + CG solve +
update) descend.
"""

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import PartitionSpec as P

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim.sr import StochasticReconfiguration
from cgs_vmc_jax.parallel import mesh as mesh_lib

NX = NY = 12
N = NX * NY


def _setup(batch_size=256):
    config = Config(num_sites=N, size_x=NX, size_y=NY,
                    wavefunction_type='conv_2d', num_conv_layers=2,
                    num_conv_filters=8, kernel_size=3,
                    wavefunction_optimizer_type='SR',
                    batch_size=batch_size, num_batches_per_epoch=1,
                    num_equilibration_sweeps=2, num_monte_carlo_sweeps=1,
                    optimizer='gradient', learning_rates=[0.05],
                    learning_rate_stops=[], heisenberg_jx=-1.0,
                    sr_solver='sample_cg', sr_diag_shift=1e-2,
                    sr_cg_tol=1e-7, sr_cg_maxiter=150,
                    sr_delta_clip=10.0, sr_jacobian_chunk=64,
                    energy_chunk_samples=64, seed=21)
    wf = build_wavefunction(config)
    ham = HeisenbergHamiltonian(lattice.square_lattice_bonds(NX, NY),
                                -1.0, 1.0,
                                sample_chunk=config.energy_chunk_samples)
    opt = StochasticReconfiguration(wf, ham, config)
    return config, wf, ham, opt


@pytest.mark.slow
def test_12x12_sample_cg_sharded_matches_single_device():
    config, wf, ham, opt = _setup()
    params = wf.init(jax.random.key(3))
    configs = basis.random_configurations(jax.random.key(4), N, 128)
    e_loc = ham.local_value(wf, params, configs)
    e_mean = jnp.mean(e_loc)
    delta_single, grad_single, _ = opt._sample_cg_solve(
        configs, params, e_loc, e_mean, None)

    device_mesh = mesh_lib.make_mesh(8)
    param_specs = jax.tree.map(lambda _: P(), params)

    @jax.jit
    @partial(jax.shard_map, mesh=device_mesh,
             in_specs=(P(mesh_lib.CHAINS_AXIS), param_specs,
                       P(mesh_lib.CHAINS_AXIS)),
             out_specs=(param_specs, param_specs), check_vma=False)
    def sharded_solve(configs_shard, p, e_shard):
        e_m = jax.lax.pmean(jnp.mean(e_shard), mesh_lib.CHAINS_AXIS)
        delta, grad, _ = opt._sample_cg_solve(
            configs_shard, p, e_shard, e_m, mesh_lib.CHAINS_AXIS)
        return delta, grad

    delta_sharded, grad_sharded = sharded_solve(configs, params, e_loc)
    for a, b in zip(jax.tree.leaves(grad_sharded),
                    jax.tree.leaves(grad_single)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-7)
    for a, b in zip(jax.tree.leaves(delta_sharded),
                    jax.tree.leaves(delta_single)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-3, atol=5e-4)


@pytest.mark.slow
def test_12x12_sharded_sr_epochs_descend():
    """Full sharded SR training epochs at 12x12: the complete pipeline
    (per-device chains, psum'd moments, sharded-Jacobian CG) under one
    jitted shard_map call per epoch, energy descending from random init
    toward the AFM ground state (E/N approx -0.6715 at 10x10; any
    decrease of a few units over 6 epochs proves optimization, not
    convergence)."""
    config, wf, ham, opt = _setup()
    device_mesh = mesh_lib.make_mesh(8)
    state = opt.init_state(jax.random.key(config.seed))
    state = mesh_lib.shard_train_state(state, device_mesh)
    epoch_fn = mesh_lib.sharded_epoch_fn(
        opt.epoch, device_mesh, state,
        metric_names=('energy', 'energy_variance', 'acceptance_rate',
                      'grad_norm', 'sr_residual_norm'))

    energies = []
    for _ in range(6):
        state, metrics = epoch_fn(state)
        e = float(metrics['energy'])
        assert np.isfinite(e)
        energies.append(e)
    assert energies[-1] < energies[0] - 2.0, energies
    assert 0.0 < float(metrics['acceptance_rate']) <= 1.0
