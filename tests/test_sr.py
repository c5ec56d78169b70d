"""SR oracle: natural gradient against the explicitly constructed S-matrix
(SURVEY.md §4.2d) and solver cross-checks."""

import pytest
import numpy as np
import jax
import jax.flatten_util
import jax.numpy as jnp

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim.sr import StochasticReconfiguration

N = 8
BONDS = lattice.chain_bonds(N)
SHIFT = 1e-2


def _setup(solver):
    config = Config(num_sites=N, wavefunction_type='rbm', num_fc_layers=0,
                    fc_layer_size=8, batch_size=64, num_batches_per_epoch=2,
                    num_equilibration_sweeps=2, heisenberg_jx=-1.0,
                    sr_diag_shift=SHIFT, sr_solver=solver,
                    sr_cg_maxiter=400, sr_cg_tol=1e-10,
                    use_fast_sampler=False, seed=4)
    wf = build_wavefunction(config)
    ham = HeisenbergHamiltonian(BONDS, -1.0, 1.0)
    return config, wf, StochasticReconfiguration(wf, ham, config)


def _explicit_natural_gradient(wf, params, configs, e_loc):
    """Reference computation: build S and g explicitly, dense-solve in f64.
    Uses the same scale-invariant shift as the dense solver:
    eps_eff = SHIFT * mean(diag(O O^T / M))."""
    flat, unravel = jax.flatten_util.ravel_pytree(params)

    def log_flat(p):
        return wf.apply(unravel(p), configs).log

    jac = np.asarray(jax.jacrev(log_flat)(flat), np.float64)
    jac = jac - jac.mean(axis=0, keepdims=True)
    m = jac.shape[0]
    e_centered = np.asarray(e_loc, np.float64) - np.mean(e_loc)
    s_matrix = jac.T @ jac / m
    g = jac.T @ e_centered / m
    eps_eff = SHIFT * np.mean(np.sum(jac * jac, axis=1) / m)
    delta = np.linalg.solve(s_matrix + eps_eff * np.eye(len(flat)), g)
    return delta, eps_eff


@pytest.mark.slow
def test_dense_solver_matches_explicit_s_matrix():
    config, wf, opt = _setup('dense')
    params = wf.init(jax.random.key(0))
    configs = basis.random_configurations(jax.random.key(1), N, 64)
    e_loc = opt.hamiltonian.local_value(wf, params, configs)
    e_mean = jnp.mean(e_loc)

    def log_fn(p):
        return wf.apply(p, configs).log

    delta, _, _ = opt._dense_solve(configs, params, e_loc, e_mean, None)
    flat_delta, _ = jax.flatten_util.ravel_pytree(delta)
    expected, _ = _explicit_natural_gradient(wf, params, configs, e_loc)
    np.testing.assert_allclose(np.asarray(flat_delta), expected,
                               rtol=2e-3, atol=2e-4)


def test_sample_cg_matches_dense_single_device():
    """The sharded-Jacobian sample-space CG solves the SAME system as the
    dense Cholesky path (single device: identical Jacobian, same shift)."""
    config, wf, opt = _setup('sample_cg')
    params = wf.init(jax.random.key(5))
    configs = basis.random_configurations(jax.random.key(6), N, 64)
    e_loc = opt.hamiltonian.local_value(wf, params, configs)
    e_mean = jnp.mean(e_loc)

    delta_cg, grad_cg, _ = opt._sample_cg_solve(
        configs, params, e_loc, e_mean, None)
    _, wf_d, opt_dense = _setup('dense')
    delta_d, grad_d, _ = opt_dense._dense_solve(
        configs, params, e_loc, e_mean, None)
    for a, b in zip(jax.tree.leaves(delta_cg), jax.tree.leaves(delta_d)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-3, atol=5e-4)
    for a, b in zip(jax.tree.leaves(grad_cg), jax.tree.leaves(grad_d)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=1e-5)


def test_dense_cg_matches_dense_cholesky():
    """'dense_cg' solves the same assembled [M, M] system as 'dense' — the
    natural-gradient direction must agree to CG tolerance."""
    config, wf, opt = _setup('dense')
    params = wf.init(jax.random.key(20))
    configs = basis.random_configurations(jax.random.key(21), N, 64)
    e_loc = opt.hamiltonian.local_value(wf, params, configs)
    e_mean = jnp.mean(e_loc)
    delta_chol, grad_chol, _ = opt._dense_solve(
        configs, params, e_loc, e_mean, None, use_cg=False)
    delta_cg, grad_cg, _ = opt._dense_solve(
        configs, params, e_loc, e_mean, None, use_cg=True)
    for a, b in zip(jax.tree.leaves(delta_cg), jax.tree.leaves(delta_chol)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=2e-4)
    for a, b in zip(jax.tree.leaves(grad_cg), jax.tree.leaves(grad_chol)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)


def test_dense_cg_epoch_descends():
    """End-to-end: an SR epoch with sr_solver='dense_cg' runs and lowers
    the energy on the N=8 chain."""
    config, wf, opt = _setup('dense_cg')
    from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
    opt = GROUND_STATE_OPTIMIZERS['SR'](
        wf, HeisenbergHamiltonian(BONDS, -1.0, 1.0),
        config.replace(learning_rates=[0.05], learning_rate_stops=[],
                       optimizer='gradient'))
    state = opt.init_state(jax.random.key(2))
    epoch_fn = jax.jit(opt.epoch)
    state, m0 = epoch_fn(state)
    for _ in range(30):
        state, m = epoch_fn(state)
    assert float(m['energy']) < float(m0['energy'])


def test_jacobian_chunking_is_exact():
    """sr_jacobian_chunk changes memory, not the answer."""
    config, wf, opt = _setup('dense')
    params = wf.init(jax.random.key(10))
    configs = basis.random_configurations(jax.random.key(11), N, 64)
    e_loc = opt.hamiltonian.local_value(wf, params, configs)
    e_mean = jnp.mean(e_loc)
    delta_full, _, _ = opt._dense_solve(configs, params, e_loc, e_mean,
                                        None)
    opt.config = config.replace(sr_jacobian_chunk=16)
    delta_chunked, _, _ = opt._dense_solve(configs, params, e_loc, e_mean,
                                           None)
    for a, b in zip(jax.tree.leaves(delta_full),
                    jax.tree.leaves(delta_chunked)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)


def test_sample_cg_sharded_matches_single_device():
    """Sharding the Jacobian over an 8-device mesh must not change the
    solution: psum'd matvecs/dots reproduce the single-device solve."""
    from functools import partial
    from jax.sharding import PartitionSpec as P
    from cgs_vmc_jax.parallel import mesh as mesh_lib

    config, wf, opt = _setup('sample_cg')
    params = wf.init(jax.random.key(7))
    configs = basis.random_configurations(jax.random.key(8), N, 64)
    e_loc = opt.hamiltonian.local_value(wf, params, configs)
    e_mean = jnp.mean(e_loc)
    delta_single, _, _ = opt._sample_cg_solve(
        configs, params, e_loc, e_mean, None)

    device_mesh = mesh_lib.make_mesh(8)
    param_specs = jax.tree.map(lambda _: P(), params)

    @jax.jit
    @partial(jax.shard_map, mesh=device_mesh,
             in_specs=(P(mesh_lib.CHAINS_AXIS), param_specs,
                       P(mesh_lib.CHAINS_AXIS)),
             out_specs=param_specs, check_vma=False)
    def sharded_solve(configs_shard, p, e_shard):
        e_m = jax.lax.pmean(jnp.mean(e_shard), mesh_lib.CHAINS_AXIS)
        delta, _, _ = opt._sample_cg_solve(
            configs_shard, p, e_shard, e_m, mesh_lib.CHAINS_AXIS)
        return delta

    delta_sharded = sharded_solve(configs, params, e_loc)
    for a, b in zip(jax.tree.leaves(delta_sharded),
                    jax.tree.leaves(delta_single)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-3, atol=5e-4)


def test_sample_cg_complex_epoch_descends():
    """sample_cg accepts complex-log ansatzes (stacked re/im rows)."""
    config = Config(num_sites=N, wavefunction_type='complex',
                    composite_wavefunction_types=('fully_connected',
                                                  'fully_connected'),
                    num_fc_layers=1, fc_layer_size=8,
                    heisenberg_j2=0.5,
                    batch_size=128, num_batches_per_epoch=2,
                    num_equilibration_sweeps=5, num_monte_carlo_sweeps=1,
                    optimizer='gradient', learning_rates=[0.05],
                    learning_rate_stops=[],
                    sr_solver='sample_cg', sr_diag_shift=1e-3,
                    sr_cg_maxiter=200, sr_cg_tol=1e-8,
                    sr_delta_clip=10.0, seed=9)
    wf = build_wavefunction(config)
    bonds, mask = lattice.j1j2_chain_bonds(N)
    ham = HeisenbergHamiltonian(bonds, couplings=(1.0 - mask) + 0.5 * mask)
    opt = StochasticReconfiguration(wf, ham, config)
    state = opt.init_state(jax.random.key(config.seed))
    epoch = jax.jit(lambda s: opt.epoch(s))
    energies = []
    for _ in range(20):
        state, metrics = epoch(state)
        energies.append(float(metrics['energy']))
    assert np.mean(energies[-4:]) < np.mean(energies[:4]) - 0.5


@pytest.mark.slow
def test_cg_solver_matches_dense():
    """CG (absolute shift) equals dense (relative shift) when the CG config
    is given the dense solver's effective epsilon."""
    config, wf, opt_dense = _setup('dense')
    params = wf.init(jax.random.key(2))
    configs = basis.random_configurations(jax.random.key(3), N, 64)
    e_loc = opt_dense.hamiltonian.local_value(wf, params, configs)
    e_mean = jnp.mean(e_loc)

    _, eps_eff = _explicit_natural_gradient(wf, params, configs, e_loc)
    config_cg, wf_cg, opt_cg = _setup('cg')
    opt_cg.config = config_cg.replace(sr_diag_shift=float(eps_eff))

    def log_fn(p):
        return wf.apply(p, configs).log

    delta_cg, _, _ = opt_cg._cg_solve(log_fn, params, e_loc, e_mean, 64,
                                      None)
    delta_dense, _, _ = opt_dense._dense_solve(configs, params, e_loc,
                                               e_mean, None)
    for a, b in zip(jax.tree.leaves(delta_cg), jax.tree.leaves(delta_dense)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=5e-3, atol=5e-4)


@pytest.mark.slow
def test_jacobian_chunking_non_divisible_batch():
    """batch % sr_jacobian_chunk != 0 pads and chunks instead of silently
    running the unchunked vmap (round-1 ADVICE)."""
    config, wf, opt = _setup('dense')
    params = wf.init(jax.random.key(10))
    configs = basis.random_configurations(jax.random.key(11), N, 56)  # 56%16!=0
    e_loc = opt.hamiltonian.local_value(wf, params, configs)
    e_mean = jnp.mean(e_loc)
    delta_full, _, _ = opt._dense_solve(configs, params, e_loc, e_mean, None)
    opt.config = config.replace(sr_jacobian_chunk=16)
    delta_chunked, _, _ = opt._dense_solve(configs, params, e_loc, e_mean,
                                           None)
    for a, b in zip(jax.tree.leaves(delta_full),
                    jax.tree.leaves(delta_chunked)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)


def test_update_from_samples_matches_epoch():
    """Split-program contract: replaying epoch()'s sampling schedule by
    hand and feeding the batch to the public update_from_samples()
    reproduces epoch()'s parameter update bit-for-bit — the guarantee
    the flagship driver scripts (examples/heisenberg_12x12_deep.py,
    examples/heisenberg_6x6_transformer.py) rely on."""
    from jax import lax
    from cgs_vmc_jax.sampler import metropolis

    config, wf, opt = _setup('dense')
    state = opt.init_state(jax.random.key(20))
    new_state, metrics = jax.jit(opt.epoch)(state)

    # Replay the identical sampling schedule (epoch's collect scan).
    params = state.params
    smp = metropolis.reset_stats(state.sampler)
    smp = metropolis.refresh_amplitudes(wf, params, smp)
    smp = opt.sweeps(params, smp, config.num_equilibration_sweeps)

    def collect(s, _):
        configs = s.configs
        s = opt.sweeps(params, s, config.num_monte_carlo_sweeps)
        return s, configs

    smp, batches = lax.scan(collect, smp, None,
                            length=config.num_batches_per_epoch)
    all_configs = batches.reshape(-1, N)
    e_loc = opt.hamiltonian.local_value(wf, params, all_configs)

    got_params, _, res, grad_e = jax.jit(opt.update_from_samples)(
        params, state.opt_state, state.epoch, all_configs, e_loc)

    np.testing.assert_allclose(float(jnp.mean(e_loc)),
                               float(metrics['energy']), rtol=1e-6)
    # Residuals are at solver-noise scale (~1e-5); the two differently
    # fused programs agree only to absolute tolerance there.
    np.testing.assert_allclose(float(res),
                               float(metrics['sr_residual_norm']),
                               atol=1e-4)
    for a, b in zip(jax.tree.leaves(got_params),
                    jax.tree.leaves(new_state.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-6, atol=1e-8)


def test_update_from_samples_rejects_on_residual_gate():
    """With an impossibly tight sr_reject_residual the natural-gradient
    update must be zeroed: params come back unchanged (the gating the
    examples previously re-implemented by hand, now in one place)."""
    config, wf, opt = _setup('dense')
    opt.config = config.replace(sr_reject_residual=1e-30)
    params = wf.init(jax.random.key(21))
    configs = basis.random_configurations(jax.random.key(22), N, 64)
    e_loc = opt.hamiltonian.local_value(wf, params, configs)
    got_params, _, res, _ = opt.update_from_samples(
        params, opt.optax_opt.init(params), jnp.zeros((), jnp.int32),
        configs, e_loc)
    assert float(res) > 1e-30 * 1e-12  # the gate actually fired
    for a, b in zip(jax.tree.leaves(got_params), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
