"""Complex-phase wavefunctions: exactness oracles + frustrated training.

The reference framework is strictly real-amplitude; this validates the new
complex-log capability end to end: log-domain algebra, batched local
energy, |psi|² sampling, the complex energy-gradient estimator, and dense
SR on the Majumdar-Ghosh point of the J1-J2 chain.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import FullVector, build_wavefunction
from cgs_vmc_jax.models.complex_phase import ComplexPhaseWavefunction, is_complex
from cgs_vmc_jax.ops import logamp
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import common
from cgs_vmc_jax.optim.energy_gradient import EnergyGradientOptimizer
from cgs_vmc_jax.optim.sr import StochasticReconfiguration
from cgs_vmc_jax.sampler import metropolis
from cgs_vmc_jax.utils import ed

N = 8


def _j1j2(j2: float):
    bonds, mask = lattice.j1j2_chain_bonds(N)
    return bonds, (1.0 - mask) + j2 * mask


def _exact_complex_state(seed: int = 0):
    """A known complex state psi_R = m_R * exp(i*phi_R) as a wavefunction."""
    rng = np.random.default_rng(seed)
    dim = basis.enumerate_sz_basis(N).shape[0]
    modulus = rng.uniform(0.2, 1.0, size=dim)
    phi = rng.uniform(-2.0, 2.0, size=dim)
    wf = ComplexPhaseWavefunction(
        FullVector.for_sector(N, modulus.astype(np.float32)),
        FullVector.for_sector(N, np.exp(phi).astype(np.float32)))
    params = wf.init(jax.random.key(0))
    return wf, params, modulus * np.exp(1j * phi)


def test_complex_apply_and_logamp_algebra():
    wf, params, psi = _exact_complex_state()
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    amp = wf.apply(params, states)
    assert jnp.iscomplexobj(amp.log)
    assert is_complex(wf, params, N)
    np.testing.assert_allclose(
        np.asarray(logamp.to_value(amp)), psi, rtol=1e-5)

    # Signed logsumexp over complex terms == direct complex sum.
    pair_logs = jnp.stack([amp.log, amp.log[::-1]], axis=-1)
    pair_signs = jnp.stack([amp.sign, -amp.sign[::-1]], axis=-1)
    total = logamp.sum_terms(pair_signs, pair_logs, axis=-1)
    np.testing.assert_allclose(np.asarray(logamp.to_value(total)),
                               psi - psi[::-1], rtol=1e-4, atol=1e-6)


def test_complex_local_energy_matches_dense_matrix():
    """E_loc(R) = (H psi)(R) / psi(R) for a complex state on the
    frustrated J1-J2 chain — exact, per basis state."""
    bonds, couplings = _j1j2(0.4)
    wf, params, psi = _exact_complex_state()
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    mat = ed.heisenberg_matrix(N, bonds, couplings=couplings)
    dense = mat.toarray() if hasattr(mat, 'toarray') else mat

    ham = HeisenbergHamiltonian(bonds, couplings=couplings)
    e_local = np.asarray(ham.local_value(wf, params, states))
    assert np.iscomplexobj(e_local)
    np.testing.assert_allclose(e_local, (dense @ psi) / psi, rtol=2e-4)


@pytest.mark.slow
def test_complex_sampler_born_distribution():
    """|psi|² sampling must ignore the phase: chains driven by a complex
    wavefunction reproduce the modulus-squared distribution."""
    wf, params, psi = _exact_complex_state(seed=3)
    state = metropolis.init_sampler(jax.random.key(1), wf, params, N, 256)
    assert jnp.iscomplexobj(state.log_amp)
    state = metropolis.jitted_sweeps(wf, params, state, 30)

    top, bot = basis.make_lin_tables(N)
    top, bot = jnp.asarray(top), jnp.asarray(bot)
    states_np = basis.enumerate_sz_basis(N)
    lin_of_enum = np.asarray(
        basis.lin_index(jnp.asarray(states_np), top, bot))
    enum_of_lin = np.empty_like(lin_of_enum)
    enum_of_lin[lin_of_enum] = np.arange(len(lin_of_enum))

    counts = np.zeros(len(psi))
    for _ in range(50):
        state = metropolis.jitted_sweeps(wf, params, state, 2)
        idx = np.asarray(basis.lin_index(state.configs, top, bot))
        np.add.at(counts, enum_of_lin[idx], 1)
    empirical = counts / counts.sum()
    exact = np.abs(psi) ** 2 / np.sum(np.abs(psi) ** 2)
    tv = 0.5 * np.abs(empirical - exact).sum()
    assert tv < 0.05, f'TV distance {tv} too large'


def test_symmetrized_complex_wavefunction():
    """Symmetry projection composes with complex logs: the orbit average
    runs through the complex branch of logamp.sum_terms and stays
    invariant under the group (spin flip here)."""
    from cgs_vmc_jax.models import build_wavefunction
    config = Config(num_sites=16, size_x=4, size_y=4,
                    wavefunction_type='complex',
                    composite_wavefunction_types=('fully_connected',
                                                  'fully_connected'),
                    num_fc_layers=1, fc_layer_size=6,
                    symmetrize=True, symmetrize_spin_flip=True)
    wf = build_wavefunction(config)
    params = wf.init(jax.random.key(3))
    configs = basis.random_configurations(jax.random.key(4), 16, 32)
    amp = wf.apply(params, configs)
    assert jnp.iscomplexobj(amp.log)
    psi = np.asarray(logamp.to_value(amp))
    # Spin-flip invariance.
    psi_f = np.asarray(logamp.to_value(wf.apply(params, -configs)))
    np.testing.assert_allclose(psi, psi_f, rtol=1e-4, atol=1e-6)
    # 90-degree rotation invariance (row-major site = x*4 + y).
    grid = np.asarray(configs).reshape(-1, 4, 4)
    rotated = jnp.asarray(np.rot90(grid, axes=(1, 2)).reshape(-1, 16))
    psi_r = np.asarray(logamp.to_value(wf.apply(params, rotated)))
    np.testing.assert_allclose(psi, psi_r, rtol=1e-4, atol=1e-6)


def test_complex_conv_ansatz_and_mtm():
    """'complex' composites work with conv parts; MTM samples them
    (acceptance uses Re log, cache stays complex and consistent)."""
    from cgs_vmc_jax.sampler import metropolis, mtm
    config = Config(num_sites=16, size_x=4, size_y=4,
                    wavefunction_type='complex',
                    composite_wavefunction_types=('conv_2d', 'conv_2d'),
                    num_conv_layers=2, num_conv_filters=4, kernel_size=3)
    wf = build_wavefunction(config)
    params = wf.init(jax.random.key(6))
    state = metropolis.init_sampler(jax.random.key(7), wf, params, 16, 32)
    assert jnp.iscomplexobj(state.log_amp)
    state = jax.jit(lambda s: mtm.run_sweeps(wf, params, s, 3, k=4))(state)
    amp = wf.apply(params, state.configs)
    np.testing.assert_allclose(np.asarray(state.log_amp),
                               np.asarray(amp.log), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(state.configs).sum(axis=1), np.zeros(32))


def test_complex_evaluators():
    """evaluate_operator / exact_expectation / evaluate_vector /
    overlap_with_vector all handle complex amplitudes."""
    from cgs_vmc_jax.evaluate import (
        evaluate_operator, exact_expectation, evaluate_vector,
        overlap_with_vector)
    bonds, couplings = _j1j2(0.4)
    e0, v0 = ed.ground_state(N, bonds, couplings=couplings)
    wf, params, psi = _exact_complex_state(seed=4)
    ham = HeisenbergHamiltonian(bonds, couplings=couplings)
    mat = ed.heisenberg_matrix(N, bonds, couplings=couplings)
    dense = mat.toarray() if hasattr(mat, 'toarray') else mat

    # Deterministic full-basis expectation == Rayleigh quotient.
    exact = exact_expectation(wf, params, ham, N)
    rayleigh = np.real(np.vdot(psi, dense @ psi) / np.vdot(psi, psi))
    np.testing.assert_allclose(exact, rayleigh, rtol=1e-4)

    # MC estimate agrees within error bars.
    config = Config(num_sites=N, batch_size=256,
                    num_equilibration_sweeps=20, num_monte_carlo_sweeps=2,
                    num_evaluation_samples=60)
    result = evaluate_operator(wf, params, ham, config,
                               key=jax.random.key(12))
    assert abs(result.mean - rayleigh) < 6 * max(result.error, 1e-3)

    # Vector dump preserves relative phases; fidelity is conjugate-correct.
    dumped = evaluate_vector(wf, params, config)
    assert np.iscomplexobj(dumped)
    np.testing.assert_allclose(dumped / np.linalg.norm(dumped),
                               psi / np.linalg.norm(psi)
                               * np.exp(-0j), rtol=2e-4, atol=1e-6)
    assert overlap_with_vector(dumped, psi) > 1 - 1e-6


def test_complex_vector_dump_format(tmp_path):
    """The (re,im) text dump round-trips the complex amplitudes."""
    from cgs_vmc_jax.evaluate import evaluate_vector
    wf, params, psi = _exact_complex_state(seed=5)
    config = Config(num_sites=N, batch_size=64)
    out = str(tmp_path / 'wavefunction_epoch_0.txt')
    dumped = evaluate_vector(wf, params, config, output_path=out)
    parsed = []
    with open(out) as f:
        for line in f:
            re_s, im_s = line.strip()[1:-1].split(',')
            parsed.append(float(re_s) + 1j * float(im_s))
    np.testing.assert_allclose(np.asarray(parsed), dumped, rtol=1e-5,
                               atol=1e-7)


@pytest.mark.slow
def test_complex_gradient_formula_vs_rayleigh_autodiff():
    """Full-basis estimator gradient (the formula the optimizer uses,
    built from log_amp_phase_pullback) == 1/2 * autodiff of the exact
    Rayleigh quotient — same half-scale convention the real path's
    oracle test establishes."""
    bonds, couplings = _j1j2(0.4)
    config = Config(num_sites=N, wavefunction_type='complex',
                    composite_wavefunction_types=('fully_connected',
                                                  'fully_connected'),
                    num_fc_layers=1, fc_layer_size=6)
    wf = build_wavefunction(config)
    params = wf.init(jax.random.key(2))
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    mat = ed.heisenberg_matrix(N, bonds, couplings=couplings)
    dense = jnp.asarray(mat.toarray() if hasattr(mat, 'toarray') else mat,
                        jnp.complex64)

    def rayleigh(p):
        amp = wf.apply(p, states)
        psi = amp.sign * jnp.exp(amp.log - jnp.real(amp.log).max())
        num = jnp.vdot(psi, dense @ psi)
        return jnp.real(num) / jnp.real(jnp.vdot(psi, psi))

    exact_grad = jax.grad(rayleigh)(params)

    ham = HeisenbergHamiltonian(bonds, couplings=couplings)
    amp = wf.apply(params, states)
    weights = jax.nn.softmax(2.0 * jnp.real(amp.log))      # exact |psi|²/Z
    e_loc = ham.local_value(wf, params, states, amp)
    e_mean = jnp.sum(weights * e_loc)
    logs, pull = common.log_amp_phase_pullback(wf, params, states)
    w = weights * (e_loc - e_mean)
    est_grad = pull(jnp.real(w), jnp.imag(w))

    for exact_leaf, est_leaf in zip(jax.tree.leaves(exact_grad),
                                    jax.tree.leaves(est_grad)):
        np.testing.assert_allclose(np.asarray(exact_leaf),
                                   2.0 * np.asarray(est_leaf),
                                   rtol=2e-3, atol=2e-6)


@pytest.mark.slow
def test_complex_log_overlap_distillation():
    """LogOverlapSWO distills a complex target into a complex student:
    |<psi_t|psi>| fidelity rises toward 1."""
    from cgs_vmc_jax.evaluate import evaluate_vector, overlap_with_vector
    from cgs_vmc_jax.optim.swo import LogOverlapSWO

    target_wf, target_params, psi_t = _exact_complex_state(seed=6)
    config = Config(num_sites=N, wavefunction_type='complex',
                    composite_wavefunction_types=('fully_connected',
                                                  'fully_connected'),
                    num_fc_layers=1, fc_layer_size=16,
                    batch_size=256, num_batches_per_epoch=4,
                    num_equilibration_sweeps=5, num_monte_carlo_sweeps=1,
                    optimizer='adam', learning_rates=[0.01],
                    learning_rate_stops=[], seed=17)
    wf = build_wavefunction(config)
    opt = LogOverlapSWO(wf, target_wf, config)
    state = opt.init_state(jax.random.key(17), target_params, 256)

    def fidelity(params):
        dumped = evaluate_vector(wf, params, config)
        return overlap_with_vector(dumped, psi_t)

    f0 = fidelity(state.params)
    epoch = jax.jit(lambda s: opt.epoch(s))
    for _ in range(100):
        state, metrics = epoch(state)
    f1 = fidelity(state.params)
    assert f1 > f0 + 0.05 and f1 > 0.9, f'fidelity {f0} -> {f1}'


@pytest.mark.slow
def test_complex_log_overlap_itswo_descends():
    """LogOverlapITSWO (imaginary-time log-overlap) lowers the energy of
    a complex ansatz on the frustrated chain."""
    from cgs_vmc_jax.optim.swo import LogOverlapImaginaryTimeSWO
    config = Config(num_sites=N, wavefunction_type='complex',
                    composite_wavefunction_types=('fully_connected',
                                                  'fully_connected'),
                    num_fc_layers=1, fc_layer_size=12,
                    heisenberg_j2=0.5, time_evolution_beta=0.1,
                    batch_size=256, num_batches_per_epoch=4,
                    num_equilibration_sweeps=5, num_monte_carlo_sweeps=1,
                    optimizer='adam', learning_rates=[0.01],
                    learning_rate_stops=[], seed=19)
    wf = build_wavefunction(config)
    bonds, mask = lattice.j1j2_chain_bonds(N)
    ham = HeisenbergHamiltonian(bonds, couplings=(1.0 - mask) + 0.5 * mask)
    opt = LogOverlapImaginaryTimeSWO(wf, ham, config)
    state = opt.init_state(jax.random.key(19))
    epoch = jax.jit(lambda s: opt.epoch(s))
    energies = []
    for _ in range(40):
        state, metrics = epoch(state)
        energies.append(float(metrics['energy']))
    assert np.mean(energies[-5:]) < np.mean(energies[:5]) - 0.3


@pytest.mark.slow
def test_complex_sr_trains_majumdar_ghosh():
    """Dense SR with a complex fc+fc ansatz descends to the exact
    Majumdar-Ghosh energy E0 = -3N/8 on the frustrated J1-J2 chain —
    the physics a positive (Marshall-gauge) ansatz cannot represent."""
    config = Config(
        num_sites=N, wavefunction_type='complex',
        composite_wavefunction_types=('fully_connected', 'fully_connected'),
        num_fc_layers=1, fc_layer_size=16,
        heisenberg_j2=0.5,
        batch_size=256, num_batches_per_epoch=4,
        num_equilibration_sweeps=10, num_monte_carlo_sweeps=1,
        optimizer='gradient', learning_rates=[0.05, 0.02],
        learning_rate_stops=[40],
        sr_solver='dense', sr_diag_shift=1e-3, sr_delta_clip=10.0,
        seed=7)
    wf = build_wavefunction(config)
    bonds, couplings = _j1j2(0.5)
    ham = HeisenbergHamiltonian(bonds, couplings=couplings)
    opt = StochasticReconfiguration(wf, ham, config)
    state = opt.init_state(jax.random.key(config.seed))

    epoch = jax.jit(lambda s: opt.epoch(s))
    energies = []
    for _ in range(150):
        state, metrics = epoch(state)
        energies.append(float(metrics['energy']))
    e0 = -3.0 * N / 8.0
    final = np.mean(energies[-10:])
    assert final < -2.85, f'SR failed to descend: E={final} vs E0={e0}'
    assert abs(final - e0) / abs(e0) < 0.05


@pytest.mark.slow
def test_complex_energy_gradient_descends():
    """The EnergyGradient complex branch lowers the energy."""
    config = Config(
        num_sites=N, wavefunction_type='complex',
        composite_wavefunction_types=('fully_connected', 'fully_connected'),
        num_fc_layers=1, fc_layer_size=10,
        heisenberg_j2=0.5,
        batch_size=128, num_batches_per_epoch=4,
        num_equilibration_sweeps=10, num_monte_carlo_sweeps=1,
        optimizer='adam', learning_rates=[0.02], learning_rate_stops=[],
        seed=11)
    wf = build_wavefunction(config)
    bonds, couplings = _j1j2(0.5)
    ham = HeisenbergHamiltonian(bonds, couplings=couplings)
    opt = EnergyGradientOptimizer(wf, ham, config)
    state = opt.init_state(jax.random.key(config.seed))

    epoch = jax.jit(lambda s: opt.epoch(s))
    energies = []
    for _ in range(25):
        state, metrics = epoch(state)
        energies.append(float(metrics['energy']))
    assert np.mean(energies[-5:]) < np.mean(energies[:5]) - 0.3


@pytest.mark.slow
@pytest.mark.parametrize('opt_name', ['SWO', 'DualSamplingSWO',
                                      'BasisIterSWO'])
def test_complex_l2_distillation(opt_name):
    """The L2-loss supervised family (SWO / DualSampling / BasisIter) with
    COMPLEX logs: |residual|² losses distill a complex ED-style target into
    a complex student to high fidelity (round-1 gap: these losses squared
    real residuals and silently mishandled complex-log ansatzes)."""
    from cgs_vmc_jax.evaluate import evaluate_vector, overlap_with_vector
    from cgs_vmc_jax.optim import SUPERVISED_OPTIMIZERS

    target_wf, target_params, psi_t = _exact_complex_state(seed=23)
    config = Config(num_sites=N, wavefunction_type='complex',
                    composite_wavefunction_types=('fully_connected',
                                                  'fully_connected'),
                    num_fc_layers=1, fc_layer_size=24,
                    batch_size=256, num_batches_per_epoch=5,
                    num_equilibration_sweeps=5, num_monte_carlo_sweeps=1,
                    optimizer='adam',
                    learning_rates=[0.01, 3e-3, 1e-3],
                    learning_rate_stops=[80, 140],
                    seed=29)
    wf = build_wavefunction(config)
    opt = SUPERVISED_OPTIMIZERS[opt_name](wf, target_wf, config)
    state = opt.init_state(jax.random.key(31), target_params, 256)

    def fidelity(params):
        dumped = evaluate_vector(wf, params, config)
        return overlap_with_vector(dumped, psi_t)

    epoch = jax.jit(lambda s: opt.epoch(s))
    for _ in range(180):
        state, metrics = epoch(state)
    f1 = fidelity(state.params)
    assert f1 > 0.97, f'{opt_name}: complex fidelity {f1}'


@pytest.mark.slow
def test_complex_itswo_descends():
    """The default ITSWO optimizer (L2 loss + EMA normalization) with a
    complex-log ansatz lowers the frustrated-chain energy (round-1 gap)."""
    from cgs_vmc_jax.optim.swo import ImaginaryTimeSWO
    config = Config(num_sites=N, wavefunction_type='complex',
                    composite_wavefunction_types=('fully_connected',
                                                  'fully_connected'),
                    num_fc_layers=1, fc_layer_size=12,
                    heisenberg_j2=0.5, time_evolution_beta=0.1,
                    batch_size=256, num_batches_per_epoch=4,
                    num_equilibration_sweeps=5, num_monte_carlo_sweeps=1,
                    optimizer='adam', learning_rates=[0.01],
                    learning_rate_stops=[], seed=37)
    wf = build_wavefunction(config)
    bonds, couplings = _j1j2(0.5)
    ham = HeisenbergHamiltonian(bonds, couplings=couplings)
    opt = ImaginaryTimeSWO(wf, ham, config)
    state = opt.init_state(jax.random.key(37))
    epoch = jax.jit(lambda s: opt.epoch(s))
    energies = []
    for _ in range(50):
        state, metrics = epoch(state)
        energies.append(float(metrics['energy']))
    assert np.isfinite(energies[-1])
    assert np.mean(energies[-5:]) < np.mean(energies[:5]) - 0.3


@pytest.mark.slow
def test_complex_cg_sr_trains_majumdar_ghosh():
    """sr_solver='cg' (parameter-space matrix-free CG) with a complex-log
    ansatz: the stacked re/im matvec descends to the Majumdar-Ghosh energy
    (round-1 gap: this path raised NotImplementedError)."""
    config = Config(
        num_sites=N, wavefunction_type='complex',
        composite_wavefunction_types=('fully_connected', 'fully_connected'),
        num_fc_layers=1, fc_layer_size=16,
        heisenberg_j2=0.5,
        batch_size=256, num_batches_per_epoch=4,
        num_equilibration_sweeps=10, num_monte_carlo_sweeps=1,
        optimizer='gradient', learning_rates=[0.05, 0.02],
        learning_rate_stops=[40],
        sr_solver='cg', sr_diag_shift=1e-3, sr_delta_clip=10.0,
        seed=7)
    wf = build_wavefunction(config)
    bonds, couplings = _j1j2(0.5)
    ham = HeisenbergHamiltonian(bonds, couplings=couplings)
    opt = StochasticReconfiguration(wf, ham, config)
    state = opt.init_state(jax.random.key(config.seed))

    epoch = jax.jit(lambda s: opt.epoch(s))
    energies = []
    for _ in range(150):
        state, metrics = epoch(state)
        energies.append(float(metrics['energy']))
    e0 = -3.0 * N / 8.0
    final = np.mean(energies[-10:])
    assert final < -2.85, f'CG SR failed to descend: E={final} vs E0={e0}'
    assert abs(final - e0) / abs(e0) < 0.05
