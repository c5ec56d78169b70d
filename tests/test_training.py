"""Integration tests: short training runs against exact-diagonalization.

Ground-state runs use the Marshall-rotated AFM Hamiltonian (j_x = -1) where
the ground state is positive — the gauge the reference pipeline trains in
(cgs_vmc/run_training.py:74-79 docstring).
"""

import numpy as np
import jax
import jax.flatten_util
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import FullVector, build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS, SUPERVISED_OPTIMIZERS
from cgs_vmc_jax.utils import ed
from cgs_vmc_jax.evaluate import evaluate_vector, overlap_with_vector

N = 8
JX = -1.0
BONDS = lattice.chain_bonds(N)
E0, V0 = ed.ground_state(N, BONDS, j_x=JX)


def _config(**kwargs) -> Config:
    defaults = dict(
        num_sites=N,
        wavefunction_type='rbm', num_fc_layers=1, fc_layer_size=16,
        batch_size=128, num_batches_per_epoch=5,
        num_equilibration_sweeps=5, num_monte_carlo_sweeps=1,
        learning_rates=[3e-3, 1e-3], learning_rate_stops=[60],
        optimizer='adam', heisenberg_jx=JX, time_evolution_beta=0.12,
        seed=7,
    )
    defaults.update(kwargs)
    return Config(**defaults)


def _run_ground_state(opt_name: str, epochs: int, config: Config):
    wf = build_wavefunction(config)
    ham = HeisenbergHamiltonian(BONDS, config.heisenberg_jx, 1.0)
    opt = GROUND_STATE_OPTIMIZERS[opt_name](wf, ham, config)
    state = opt.init_state(jax.random.key(config.seed))
    epoch_fn = jax.jit(opt.epoch)
    energy = None
    for _ in range(epochs):
        state, metrics = epoch_fn(state)
        energy = float(metrics['energy'])
    return wf, state, energy, metrics


@pytest.mark.slow
def test_energy_gradient_converges_to_ed():
    config = _config(learning_rates=[5e-3, 1e-3],
                     learning_rate_stops=[120])
    _, _, energy, metrics = _run_ground_state('EnergyGradient', 180, config)
    assert abs(energy - E0) / abs(E0) < 0.03
    assert float(metrics['acceptance_rate']) > 0.05


@pytest.mark.slow
def test_sr_converges_to_ed():
    config = _config(optimizer='gradient',
                     learning_rates=[0.05, 0.02],
                     learning_rate_stops=[60],
                     sr_diag_shift=1e-2)
    _, _, energy, _ = _run_ground_state('SR', 60, config)
    assert abs(energy - E0) / abs(E0) < 0.03


@pytest.mark.slow
def test_itswo_lowers_energy():
    _, _, energy, _ = _run_ground_state('ITSWO', 80, _config())
    assert energy < 0.6 * E0  # most of the way to the ground state
    assert energy - E0 > -0.5  # not below the exact ground state


@pytest.mark.slow
def test_logoverlap_itswo_lowers_energy():
    _, _, energy, _ = _run_ground_state('LogOverlapITSWO', 80, _config())
    assert energy < 0.6 * E0


@pytest.mark.slow
@pytest.mark.parametrize('opt_name', sorted(SUPERVISED_OPTIMIZERS))
def test_supervised_distillation_reaches_high_overlap(opt_name):
    """Distilling the exact ED target into an RBM must drive overlap -> 1
    (SURVEY.md §4.4)."""
    config = _config(
        batch_size=64, num_batches_per_epoch=10,
        learning_rates=[1e-2, 3e-3], learning_rate_stops=[40],
        wavefunction_optimizer_type=opt_name)
    target_wf = FullVector.for_sector(N, np.abs(V0).astype(np.float32))
    target_params = target_wf.init(jax.random.key(0))
    wf = build_wavefunction(config)
    opt = SUPERVISED_OPTIMIZERS[opt_name](wf, target_wf, config)
    state = opt.init_state(jax.random.key(3), target_params,
                           config.batch_size)
    epoch_fn = jax.jit(opt.epoch)
    for _ in range(60):
        state, metrics = epoch_fn(state)
    psi = evaluate_vector(wf, state.params, config,
                          basis_array=basis.enumerate_sz_basis(N))
    fidelity = overlap_with_vector(psi, np.abs(V0))
    assert fidelity > 0.97, f'{opt_name}: overlap {fidelity}'


@pytest.mark.slow
def test_basis_iteration_covers_full_basis_without_replacement():
    """BasisIterSWO iterates a SHUFFLED permutation of the basis (reference
    training.py:242-251), not with-replacement batches: within one pass
    every basis row appears exactly once."""
    import jax.numpy as jnp
    from cgs_vmc_jax.optim.swo import BasisIterationSWO

    dim = basis.enumerate_sz_basis(N).shape[0]  # 70 for N=8
    config = _config(batch_size=35, num_batches_per_epoch=2,
                     wavefunction_optimizer_type='BasisIterSWO')
    target_wf = FullVector.for_sector(N, np.abs(V0).astype(np.float32))
    target_params = target_wf.init(jax.random.key(0))
    wf = build_wavefunction(config)
    opt = BasisIterationSWO(wf, target_wf, config)
    state = opt.init_state(jax.random.key(3), target_params)

    # Reproduce the epoch's index stream from its data_key.
    data_key, perm_key = jax.random.split(state.extra['data_key'])
    perm = jax.random.permutation(perm_key, dim)
    idx = np.asarray(perm[jnp.arange(70) % dim])
    assert sorted(idx.tolist()) == list(range(dim))  # one full pass

    # And the epoch still trains.
    state, metrics = jax.jit(opt.epoch)(state)
    assert np.isfinite(float(metrics['loss']))


@pytest.mark.slow
def test_basis_iteration_seed_changes_order():
    """config.seed must change the basis-iteration permutation sequence
    (round-2 review: a constant data_key made every run identical)."""
    import jax.numpy as jnp
    from cgs_vmc_jax.optim.swo import BasisIterationSWO

    dim = basis.enumerate_sz_basis(N).shape[0]
    config = _config(batch_size=35, num_batches_per_epoch=2,
                     wavefunction_optimizer_type='BasisIterSWO')
    target_wf = FullVector.for_sector(N, np.abs(V0).astype(np.float32))
    target_params = target_wf.init(jax.random.key(0))
    wf = build_wavefunction(config)
    opt = BasisIterationSWO(wf, target_wf, config)

    orders = []
    for seed in (3, 4):
        state = opt.init_state(jax.random.key(seed), target_params)
        _, perm_key = jax.random.split(state.extra['data_key'])
        orders.append(np.asarray(jax.random.permutation(perm_key, dim)))
    assert not np.array_equal(orders[0], orders[1])


def test_param_ema_tracks_and_resumes(tmp_path):
    """param_ema_decay > 0: the EMA slot follows ema <- d*ema+(1-d)*p
    exactly, is checkpointed, survives resume, and `cgs eval --ema`'s
    restore helper reads it back."""
    import numpy as np
    from cgs_vmc_jax.models import build_wavefunction
    from cgs_vmc_jax.utils import checkpoint as ckpt_lib
    from cgs_vmc_jax.train import train

    cfg = Config(num_sites=8, wavefunction_type='rbm',
                 num_fc_layers=0, fc_layer_size=8,
                 wavefunction_optimizer_type='EnergyGradient',
                 batch_size=32, num_batches_per_epoch=1,
                 num_equilibration_sweeps=1, num_monte_carlo_sweeps=1,
                 num_epochs=4, checkpoint_frequency=2,
                 learning_rates=[0.05], learning_rate_stops=[],
                 optimizer='gradient', heisenberg_jx=-1.0,
                 param_ema_decay=0.8, use_fast_sampler=False,
                 checkpoint_dir=str(tmp_path), seed=3)
    state = train(cfg)
    assert 'ema_params' in state.extra

    # EMA lags params but is not equal to them after updates.
    flat_p = jax.flatten_util.ravel_pytree(state.params)[0]
    flat_e = jax.flatten_util.ravel_pytree(state.extra['ema_params'])[0]
    assert not np.allclose(np.asarray(flat_p), np.asarray(flat_e))

    # The restore helper reads the averaged weights back.
    wf = build_wavefunction(cfg)
    template = wf.init(jax.random.key(cfg.seed))
    latest = ckpt_lib.latest_checkpoint(str(tmp_path))
    ema = ckpt_lib.restore_ema_from_checkpoint(latest, template)
    np.testing.assert_allclose(
        np.asarray(jax.flatten_util.ravel_pytree(ema)[0]),
        np.asarray(flat_e), rtol=1e-6)

    # Resume continues from the stored slot without structure errors.
    cfg2 = cfg.replace(num_epochs=6)
    state2 = train(cfg2, resume=True)
    assert 'ema_params' in state2.extra

    # Exact recurrence check over one epoch: rerun the last epoch's
    # update by hand from the checkpointed state.
    # (Integration-level: d*ema + (1-d)*params with d=0.8.)
    # Covered implicitly by the restore equality above plus the lag
    # assertion; a unit check of the wrapper:
    from cgs_vmc_jax.train import _ema_wrap
    def fake_epoch(s, axis_name=None):
        new_p = jax.tree.map(lambda p: p + 1.0, s.params)
        return s._replace(params=new_p), {'energy': jnp.zeros(())}
    s0 = state._replace(extra={'ema_params': state.params})
    s1, _ = _ema_wrap(fake_epoch, 0.8)(s0)
    want = jax.tree.map(lambda p: p + 0.2, state.params)
    np.testing.assert_allclose(
        np.asarray(jax.flatten_util.ravel_pytree(
            s1.extra['ema_params'])[0]),
        np.asarray(jax.flatten_util.ravel_pytree(want)[0]), rtol=1e-6)


def test_param_ema_enabled_on_resume_of_old_run(tmp_path):
    """Turning param_ema_decay on for an EXISTING run must resume cleanly:
    the old checkpoint has no EMA slot, so the restore falls back to the
    slotless template and seeds the average at the restored params."""
    base = dict(num_sites=8, wavefunction_type='rbm',
                num_fc_layers=0, fc_layer_size=8,
                wavefunction_optimizer_type='EnergyGradient',
                batch_size=32, num_batches_per_epoch=1,
                num_equilibration_sweeps=1, num_monte_carlo_sweeps=1,
                checkpoint_frequency=2,
                learning_rates=[0.05], learning_rate_stops=[],
                optimizer='gradient', heisenberg_jx=-1.0,
                use_fast_sampler=False,
                checkpoint_dir=str(tmp_path), seed=3)
    from cgs_vmc_jax.train import train
    train(Config(num_epochs=2, param_ema_decay=0.0, **base))
    state = train(Config(num_epochs=4, param_ema_decay=0.8, **base),
                  resume=True)
    assert 'ema_params' in state.extra
