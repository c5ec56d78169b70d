"""Excited-state penalty optimizer: exactness oracles + gap convergence.

The physics gives sharp oracles: with FullVector ansatzes the overlap
estimator is exact sample-by-sample when psi == psi_0 (every ratio is 1),
the exact first excited state is a zero-variance fixed point with
energy == E1, and a trainable dense vector penalized against the exact
ground state must converge to the first excited sector eigenvalue.
The reference has no excited-state machinery at all
(cgs_vmc/training.py:913-925 lists ground-state + supervised fits only).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import FullVector, build_wavefunction
from cgs_vmc_jax.models.complex_phase import ComplexPhaseWavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
from cgs_vmc_jax.optim.excited import PenaltyExcitedOptimizer
from cgs_vmc_jax.utils import ed

N = 8
JX = -1.0
BONDS = lattice.chain_bonds(N)
_MAT = ed.heisenberg_matrix(N, BONDS, j_x=JX)
_VALS, _VECS = np.linalg.eigh(_MAT)
E0, E1 = float(_VALS[0]), float(_VALS[1])
V0, V1 = _VECS[:, 0], _VECS[:, 1]


def _config(**kwargs) -> Config:
    defaults = dict(
        num_sites=N,
        batch_size=128, num_batches_per_epoch=4,
        num_equilibration_sweeps=5, num_monte_carlo_sweeps=1,
        learning_rates=[0.0], learning_rate_stops=[],
        optimizer='gradient', heisenberg_jx=JX,
        orthogonality_penalty=10.0, seed=11,
    )
    defaults.update(kwargs)
    return Config(**defaults)


def _ham():
    return HeisenbergHamiltonian(BONDS, JX, 1.0)


def _vector_state(vec: np.ndarray):
    wf = FullVector.for_sector(N, vec.astype(np.float32))
    return wf, wf.init(jax.random.key(0))


def test_overlap_estimator_exact_for_identical_states():
    """psi == psi_0: every ratio r = s = 1, so F-hat == 1 to f32 rounding
    regardless of which configurations the chains visit."""
    wf0, params0 = _vector_state(V0)
    wf, _ = _vector_state(V0)
    opt = PenaltyExcitedOptimizer(wf, _ham(), _config(),
                                  lower_states=[(wf0, params0)])
    state = opt.init_state(jax.random.key(1))
    state, metrics = jax.jit(opt.epoch)(state)
    assert abs(float(metrics['overlap']) - 1.0) < 1e-4
    # Zero-variance energy: the exact eigenstate gives E0 exactly.
    assert abs(float(metrics['energy']) - E0) < 1e-3
    assert float(metrics['energy_variance']) < 1e-4


def test_exact_excited_state_is_zero_variance_fixed_point():
    """psi = exact first excited sector eigenstate, frozen psi_0 = exact
    ground state: energy == E1 with ~zero variance and small overlap."""
    wf0, params0 = _vector_state(V0)
    wf, _ = _vector_state(V1)
    opt = PenaltyExcitedOptimizer(wf, _ham(), _config(),
                                  lower_states=[(wf0, params0)])
    state = opt.init_state(jax.random.key(2))
    state, metrics = jax.jit(opt.epoch)(state)
    assert abs(float(metrics['energy']) - E1) < 1e-3
    assert float(metrics['energy_variance']) < 1e-4
    # <psi_0|psi_1> = 0: the estimator is unbiased but noisy; exchange of
    # exact eigenvectors keeps the tails mild at this size.
    assert abs(float(metrics['overlap'])) < 0.1


def test_penalty_requires_positive_lambda():
    wf0, params0 = _vector_state(V0)
    wf, _ = _vector_state(V1)
    with pytest.raises(ValueError, match='orthogonality_penalty'):
        PenaltyExcitedOptimizer(
            wf, _ham(), _config(orthogonality_penalty=0.0),
            lower_states=[(wf0, params0)])


def test_registry_requires_lower_states():
    config = _config(wavefunction_type='rbm', fc_layer_size=8)
    wf = build_wavefunction(config)
    with pytest.raises(ValueError, match='orthogonal_to'):
        GROUND_STATE_OPTIMIZERS['ExcitedPenalty'](wf, _ham(), config)


@pytest.mark.slow
def test_penalty_training_converges_to_first_excited():
    """Trainable dense vector + exact frozen ground state: the penalized
    minimum is the first excited sector eigenvalue."""
    rng = np.random.default_rng(3)
    init = rng.normal(size=V0.shape) * 0.3 + V1  # warmish start, not exact
    wf0, params0 = _vector_state(V0)
    wf, _ = _vector_state(init / np.linalg.norm(init))
    config = _config(optimizer='adam',
                     learning_rates=[0.03, 0.01],
                     learning_rate_stops=[150],
                     batch_size=256, num_batches_per_epoch=4,
                     orthogonality_penalty=5.0)
    opt = PenaltyExcitedOptimizer(wf, _ham(), config,
                                  lower_states=[(wf0, params0)])
    state = opt.init_state(jax.random.key(4))
    epoch_fn = jax.jit(opt.epoch)
    energies, overlaps = [], []
    for _ in range(260):
        state, metrics = epoch_fn(state)
        energies.append(float(metrics['energy']))
        overlaps.append(float(metrics['overlap']))
    tail_e = float(np.mean(energies[-30:]))
    tail_f = float(np.mean(overlaps[-30:]))
    gap = E1 - E0
    assert abs(tail_e - E1) < 0.25 * gap, (tail_e, E1, gap)
    assert tail_e > E0 + 0.5 * gap  # genuinely not the ground state
    assert abs(tail_f) < 0.05


def test_complex_path_overlap_exact():
    """Complex-log ansatz, psi == psi_0: F-hat == 1 exactly (ratio
    plumbing through the phase pullback path)."""
    rng = np.random.default_rng(5)
    dim = V0.shape[0]
    modulus = rng.uniform(0.2, 1.0, size=dim).astype(np.float32)
    phase = rng.uniform(-2.0, 2.0, size=dim).astype(np.float32)

    def make():
        return ComplexPhaseWavefunction(
            FullVector.for_sector(N, modulus),
            FullVector.for_sector(N, np.exp(phase)))

    wf0 = make()
    params0 = wf0.init(jax.random.key(0))
    wf = make()
    opt = PenaltyExcitedOptimizer(wf, _ham(), _config(),
                                  lower_states=[(wf0, params0)])
    state = opt.init_state(jax.random.key(6))
    state, metrics = jax.jit(opt.epoch)(state)
    assert abs(float(metrics['overlap']) - 1.0) < 1e-4
    assert np.isfinite(float(metrics['grad_norm']))


@pytest.mark.slow
def test_excited_pipeline_from_run_dir(tmp_path):
    """End-to-end: train a tiny ground-state run, then an ExcitedPenalty
    run orthogonalized against that run directory (the CLI path)."""
    from cgs_vmc_jax.train import train

    ground_dir = str(tmp_path / 'ground')
    g_config = _config(
        wavefunction_type='rbm', num_fc_layers=1, fc_layer_size=16,
        wavefunction_optimizer_type='EnergyGradient',
        optimizer='adam', learning_rates=[3e-3], learning_rate_stops=[],
        num_epochs=3, checkpoint_dir=ground_dir)
    train(g_config)

    ex_dir = str(tmp_path / 'excited')
    ex_config = _config(
        wavefunction_type='rbm', num_fc_layers=1, fc_layer_size=16,
        wavefunction_optimizer_type='ExcitedPenalty',
        optimizer='adam', learning_rates=[3e-3], learning_rate_stops=[],
        num_epochs=3, checkpoint_dir=ex_dir,
        orthogonal_to=[ground_dir])
    state = train(ex_config)
    assert 'lower_samplers' in state.extra
    # Metrics stream exists and carries the overlap column.
    import json, os
    lines = [json.loads(l) for l in
             open(os.path.join(ex_dir, 'metrics.jsonl'))]
    assert 'overlap' in lines[-1]
    assert np.isfinite(lines[-1]['overlap'])


# ---------------------------------------------------------------------------
# SR-preconditioned variant ('ExcitedSR'): the penalty force folds into
# minSR as an effective local value E_loc + lambda*(F/A)*r.

def test_sr_excited_overlap_exact_for_identical_states():
    from cgs_vmc_jax.optim.excited import SRPenaltyExcitedOptimizer
    wf0, params0 = _vector_state(V0)
    wf, _ = _vector_state(V0)
    config = _config(sr_diag_shift=1e-2)
    opt = SRPenaltyExcitedOptimizer(wf, _ham(), config,
                                    lower_states=[(wf0, params0)])
    state = opt.init_state(jax.random.key(7))
    state, metrics = jax.jit(opt.epoch)(state)
    assert abs(float(metrics['overlap']) - 1.0) < 1e-4
    assert abs(float(metrics['energy']) - E0) < 1e-3


@pytest.mark.slow
def test_sr_excited_converges_to_first_excited():
    """Natural-gradient penalty descent: same target as the adam path but
    through the SR solve — converges in far fewer epochs."""
    from cgs_vmc_jax.optim.excited import SRPenaltyExcitedOptimizer
    rng = np.random.default_rng(8)
    init = rng.normal(size=V0.shape) * 0.3 + V1  # warmish start (as adam)
    wf0, params0 = _vector_state(V0)
    wf, _ = _vector_state(init / np.linalg.norm(init))
    config = _config(optimizer='gradient',
                     learning_rates=[0.08, 0.03],
                     learning_rate_stops=[60],
                     batch_size=256, num_batches_per_epoch=4,
                     sr_diag_shift=1e-2,
                     orthogonality_penalty=5.0)
    opt = SRPenaltyExcitedOptimizer(wf, _ham(), config,
                                    lower_states=[(wf0, params0)])
    state = opt.init_state(jax.random.key(9))
    epoch_fn = jax.jit(opt.epoch)
    energies, overlaps = [], []
    for _ in range(120):
        state, metrics = epoch_fn(state)
        energies.append(float(metrics['energy']))
        overlaps.append(float(metrics['overlap']))
    tail_e = float(np.mean(energies[-20:]))
    tail_f = float(np.mean(overlaps[-20:]))
    gap = E1 - E0
    assert abs(tail_e - E1) < 0.25 * gap, (tail_e, E1, gap)
    assert tail_e > E0 + 0.5 * gap
    assert abs(tail_f) < 0.05


def test_sr_excited_registry_and_requirements():
    from cgs_vmc_jax.optim.excited import SRPenaltyExcitedOptimizer
    assert GROUND_STATE_OPTIMIZERS['ExcitedSR'] is SRPenaltyExcitedOptimizer
    config = _config(wavefunction_type='rbm', fc_layer_size=8)
    wf = build_wavefunction(config)
    with pytest.raises(ValueError, match='orthogonal_to'):
        SRPenaltyExcitedOptimizer(wf, _ham(), config)


@pytest.mark.slow
def test_sr_excited_second_state_with_two_lower_states():
    """Orthogonalize against BOTH exact lowest states: the minimizer is
    pinned to the second-excited shelf (between the E1/E2 and E2/E3
    midpoints — convergence onto E2 itself is slow near the end, but the
    level selection is unambiguous)."""
    from cgs_vmc_jax.optim.excited import SRPenaltyExcitedOptimizer
    E2, E3 = float(_VALS[2]), float(_VALS[3])
    V2 = _VECS[:, 2]
    rng = np.random.default_rng(12)
    init = rng.normal(size=V2.shape) * 0.3 + V2
    wf0, params0 = _vector_state(V0)
    wf1, params1 = _vector_state(V1)
    wf, _ = _vector_state(init / np.linalg.norm(init))
    config = _config(optimizer='gradient',
                     learning_rates=[0.08], learning_rate_stops=[],
                     batch_size=512, num_batches_per_epoch=4,
                     sr_diag_shift=1e-2, orthogonality_penalty=5.0)
    opt = SRPenaltyExcitedOptimizer(
        wf, _ham(), config,
        lower_states=[(wf0, params0), (wf1, params1)])
    state = opt.init_state(jax.random.key(13))
    epoch_fn = jax.jit(opt.epoch)
    energies, overlaps = [], []
    for _ in range(250):
        state, metrics = epoch_fn(state)
        energies.append(float(metrics['energy']))
        overlaps.append(float(metrics['overlap']))
    tail_e = float(np.mean(energies[-30:]))
    assert tail_e < E2 + 0.5 * (E3 - E2), (tail_e, E2, E3)
    assert tail_e > E1 + 0.5 * (E2 - E1), (tail_e, E1, E2)
    assert abs(float(np.mean(overlaps[-30:]))) < 0.05


def test_excited_sr_sharded_epoch_matches_oracle():
    """8-device mesh: the lower-state samplers (a LIST of SamplerStates in
    extra) shard on the chains axis, and the F==1 identical-state oracle
    holds under shard_map with pmean'd overlap moments."""
    from cgs_vmc_jax.optim.excited import SRPenaltyExcitedOptimizer
    from cgs_vmc_jax.parallel import mesh as mesh_lib

    n_dev = 8
    wf0, params0 = _vector_state(V0)
    wf, _ = _vector_state(V0)
    config = _config(batch_size=4 * n_dev, num_batches_per_epoch=2,
                     sr_diag_shift=1e-2)
    opt = SRPenaltyExcitedOptimizer(wf, _ham(), config,
                                    lower_states=[(wf0, params0)])
    device_mesh = mesh_lib.make_mesh(n_dev)
    state = opt.init_state(jax.random.key(21), config.batch_size)
    _, metric_shapes = jax.eval_shape(opt.epoch, state)
    epoch_fn = mesh_lib.sharded_epoch_fn(
        opt.epoch, device_mesh, state, list(metric_shapes))
    state = mesh_lib.shard_train_state(state, device_mesh)

    # The frozen lower chains shard over devices (not replicated).
    lower_configs = state.extra['lower_samplers'][0].configs
    assert len(lower_configs.addressable_shards) == n_dev
    assert lower_configs.addressable_shards[0].data.shape[0] == 4

    state, metrics = epoch_fn(state)
    assert abs(float(metrics['overlap']) - 1.0) < 1e-4
    assert abs(float(metrics['energy']) - E0) < 1e-3


@pytest.mark.slow
def test_penalty_force_identity_against_dense_autodiff():
    """EXACT algebra check of the X-form penalty force used by ExcitedSR:
    with exact enumeration weights, 2*Re<O*(v - v_bar)> for
    v = (F/A)*psi_k/psi equals jax.grad of the dense fidelity
    F = |<psi_k|psi>|^2 / (<psi_k|psi_k><psi|psi>) — complex ansatz,
    complex frozen state, machine precision."""
    import jax.flatten_util
    from cgs_vmc_jax import basis as basis_lib

    n = 6
    states = jnp.asarray(basis_lib.enumerate_sz_basis(n))
    dim = states.shape[0]
    rng = np.random.default_rng(2)
    wf = ComplexPhaseWavefunction(
        FullVector.for_sector(n, rng.uniform(0.3, 1.0, dim)
                              .astype(np.float32)),
        FullVector.for_sector(n, np.exp(rng.uniform(-1, 1, dim))
                              .astype(np.float32)))
    params = wf.init(jax.random.key(0))
    psi0 = jnp.asarray((rng.normal(size=dim) + 1j * rng.normal(size=dim))
                       .astype(np.complex64))

    def amps(p):
        a = wf.apply(p, states)
        return a.sign * jnp.exp(a.log)

    def dense_fidelity(p):
        psi = amps(p)
        num = jnp.abs(jnp.vdot(psi0, psi)) ** 2
        return jnp.real(num / (jnp.vdot(psi0, psi0).real
                               * jnp.vdot(psi, psi).real))

    df_exact = jax.grad(dense_fidelity)(params)

    psi = amps(params)
    p = jnp.abs(psi) ** 2
    p = p / p.sum()
    p0 = jnp.abs(psi0) ** 2
    p0 = p0 / p0.sum()
    r = psi0 / psi
    a_coef = jnp.sum(p * r)
    b_coef = jnp.sum(p0 * (psi / psi0))
    fid = jnp.real(a_coef * b_coef)
    v = (fid / a_coef) * r
    w = v - jnp.sum(p * v)

    def log_phase(pp):
        amp = wf.apply(pp, states)
        return amp.log.real, amp.log.imag

    _, vjp = jax.vjp(log_phase, params)
    force = vjp((p * jnp.real(w), p * jnp.imag(w)))[0]

    flat_e, _ = jax.flatten_util.ravel_pytree(df_exact)
    flat_f, _ = jax.flatten_util.ravel_pytree(
        jax.tree.map(lambda x: 2.0 * x, force))
    np.testing.assert_allclose(np.asarray(flat_f), np.asarray(flat_e),
                               atol=1e-6)
