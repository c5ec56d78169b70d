"""t-VMC / TDVP: exact-dynamics oracles on a complete parameterization.

With a (modulus, phase) FullVector pair the variational manifold is the
entire sector Hilbert space, so TDVP must reproduce exact Schrodinger
dynamics up to integrator error — the decisive correctness check for the
metric/force construction in optim/tvmc.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.linalg

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import FullVector, build_wavefunction
from cgs_vmc_jax.models.complex_phase import ComplexPhaseWavefunction
from cgs_vmc_jax.ops import logamp
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim.tvmc import TimeEvolution, tdvp_direction
from cgs_vmc_jax.utils import ed

N = 6


def _setup(j2: float):
    bonds, mask = lattice.j1j2_chain_bonds(N)
    couplings = (1.0 - mask) + j2 * mask
    mat = ed.heisenberg_matrix(N, bonds, couplings=couplings)
    dense = mat.toarray() if hasattr(mat, 'toarray') else mat
    ham = HeisenbergHamiltonian(bonds, couplings=couplings)
    return dense, ham


def _exact_param_wf(v0: np.ndarray):
    """Wraps a REAL sector vector as modulus*exp(i*phase) with phase=0."""
    wf = ComplexPhaseWavefunction(
        FullVector.for_sector(N, v0.astype(np.float32)),
        FullVector.for_sector(N, np.ones_like(v0, np.float32)))
    return wf, wf.init(jax.random.key(0))


def _state_vector(wf, params, states):
    amp = wf.apply(params, states)
    psi = np.asarray(logamp.to_value(
        amp._replace(log=amp.log - np.real(np.asarray(amp.log)).max())))
    return psi / np.linalg.norm(psi)


def _evolve_tdvp(wf, params, ham, states, dt, n_steps, mode='real'):
    """Heun integration of TDVP with exact full-basis |psi|² weights."""
    @jax.jit
    def direction(p):
        amp = wf.apply(p, states)
        weights = jax.nn.softmax(2.0 * jnp.real(amp.log))
        e_loc = ham.local_value(wf, p, states, amp)
        # Shift must clear f32 Cholesky resolution: the complete
        # parameterization has gauge null directions (global norm/phase),
        # so the sample-space matrix is singular without it.
        return tdvp_direction(wf, p, states, e_loc, mode=mode,
                              diag_shift=1e-6, weights=weights)

    energies, r2s = [], []
    for _ in range(n_steps):
        k1, e, r2 = direction(params)
        mid = jax.tree.map(lambda p, d: p + 0.5 * dt * d, params, k1)
        k2, _, _ = direction(mid)
        params = jax.tree.map(lambda p, d: p + dt * d, params, k2)
        energies.append(complex(e))
        r2s.append(float(r2))
    return params, energies, r2s


def test_tdvp_stationary_ground_state():
    """The ground state of H is stationary under real-time TDVP in H."""
    dense, ham = _setup(0.5)
    vals, vecs = np.linalg.eigh(dense)
    v0 = vecs[:, 0]
    wf, params = _exact_param_wf(v0)
    states = jnp.asarray(basis.enumerate_sz_basis(N))

    params, energies, r2s = _evolve_tdvp(wf, params, ham, states,
                                         dt=0.01, n_steps=20)
    psi_t = _state_vector(wf, params, states)
    fidelity = abs(np.vdot(psi_t, v0))
    assert fidelity > 1 - 1e-6
    np.testing.assert_allclose([e.real for e in energies], vals[0],
                               rtol=1e-5)


def test_tdvp_real_time_quench_matches_expm():
    """Quench: NN-chain ground state evolved under the frustrated J1-J2
    Hamiltonian must track exp(-iHt)|psi0> (complete parameterization)."""
    dense, ham = _setup(0.5)
    e_chain, v_chain = ed.ground_state(N, lattice.chain_bonds(N))
    wf, params = _exact_param_wf(v_chain)
    states = jnp.asarray(basis.enumerate_sz_basis(N))

    t_final, n_steps = 0.2, 40
    params, energies, r2s = _evolve_tdvp(wf, params, ham, states,
                                         dt=t_final / n_steps,
                                         n_steps=n_steps)
    # Complete parameterization: the McLachlan residual is ~0.
    assert max(r2s) < 1e-4, f'tdvp r2 {max(r2s)}'
    psi_t = _state_vector(wf, params, states)
    exact_t = scipy.linalg.expm(-1j * dense * t_final) @ v_chain
    exact_t = exact_t / np.linalg.norm(exact_t)

    fidelity = abs(np.vdot(psi_t, exact_t))
    assert fidelity > 0.9999, f'fidelity {fidelity}'
    # Unitary dynamics conserves <H>.
    e_start = float(np.real(energies[0]))
    e_end = float(np.real(energies[-1]))
    assert abs(e_end - e_start) < 1e-3 * max(1.0, abs(e_start))


def test_tdvp_imaginary_time_descends_to_ground_state():
    """Imaginary-time TDVP flows any state to the ground state."""
    dense, ham = _setup(0.5)
    vals, vecs = np.linalg.eigh(dense)
    rng = np.random.default_rng(1)
    v = rng.uniform(0.3, 1.0, size=dense.shape[0])
    wf, params = _exact_param_wf(v)
    states = jnp.asarray(basis.enumerate_sz_basis(N))

    params, energies, _ = _evolve_tdvp(wf, params, ham, states,
                                       dt=0.05, n_steps=120, mode='imag')
    assert energies[-1].real < vals[0] + 1e-3
    psi_t = _state_vector(wf, params, states)
    # The Majumdar-Ghosh ground state is two-fold degenerate (the two
    # dimer coverings): check overlap with the ground SUBSPACE.
    gs_basis = vecs[:, vals < vals[0] + 1e-8]
    proj = np.linalg.norm(gs_basis.conj().T @ psi_t)
    assert proj > 0.999, f'ground-subspace overlap {proj}'


def test_real_time_requires_complex_ansatz():
    bonds = lattice.chain_bonds(N)
    e0, v0 = ed.ground_state(N, bonds)
    wf = FullVector.for_sector(N, v0.astype(np.float32))
    params = wf.init(jax.random.key(0))
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    ham = HeisenbergHamiltonian(bonds)
    e_loc = ham.local_value(wf, params, states)
    with pytest.raises(ValueError, match='complex'):
        tdvp_direction(wf, params, states, e_loc, mode='real')


@pytest.mark.slow
def test_cli_evolve(tmp_path, capsys):
    """Train a tiny complex ansatz, then `cgs evolve` it in imaginary time."""
    from cgs_vmc_jax.cli import main as cli_main
    run_dir = str(tmp_path / 'evolve_run')
    rc = cli_main([
        'train', '--checkpoint_dir', run_dir,
        '--num_sites', str(N), '--num_epochs', '1',
        '--wavefunction_type', 'complex',
        '--optimizer_type', 'EnergyGradient',
        '--override',
        "composite_wavefunction_types=[fully_connected;fully_connected],"
        'num_fc_layers=1,fc_layer_size=6,batch_size=16,'
        'num_batches_per_epoch=1,num_equilibration_sweeps=1,'
        'heisenberg_j2=0.5',
    ])
    assert rc == 0
    rc = cli_main(['evolve', '--checkpoint_dir', run_dir,
                   '--dt', '0.01', '--steps', '3', '--mode', 'imag',
                   '--override', 'num_equilibration_sweeps=2'])
    assert rc == 0
    out = capsys.readouterr().out
    assert 'Final energy:' in out
    import json as json_lib
    with open(f'{run_dir}/evolution.jsonl') as f:
        lines = [json_lib.loads(line) for line in f]
    assert len(lines) == 3 and np.isfinite(lines[-1]['energy'])


@pytest.mark.slow
def test_adaptive_dt_adjusts_without_recompiles():
    """adaptive_tol rescales dt from the embedded Heun error; dt is a
    traced argument so the step compiles once."""
    config = Config(
        num_sites=N, wavefunction_type='complex',
        composite_wavefunction_types=('fully_connected', 'fully_connected'),
        num_fc_layers=1, fc_layer_size=8,
        batch_size=256, num_monte_carlo_sweeps=1,
        sr_diag_shift=1e-4, seed=21)
    wf = build_wavefunction(config)
    params = wf.init(jax.random.key(22))
    bonds, mask = lattice.j1j2_chain_bonds(N)
    ham = HeisenbergHamiltonian(bonds, couplings=(1.0 - mask) + 0.5 * mask)
    evo = TimeEvolution(wf, ham, config, dt=0.002, mode='real',
                        adaptive_tol=1e-3)
    sampler = evo.init_state(jax.random.key(23), params)
    params, sampler, records = evo.evolve(params, sampler, 8)
    dts = [r['dt'] for r in records]
    assert len(set(round(d, 8) for d in dts)) > 1, 'dt never adapted'
    assert all(np.isfinite(r['energy']) for r in records)
    assert all(r['integrator_rel_error'] >= 0 for r in records)


@pytest.mark.slow
def test_time_evolution_driver_mc_sampling():
    """The MC-sampled TimeEvolution driver approximately conserves energy
    over a short real-time window (complex fc ansatz, J1-J2 quench)."""
    config = Config(
        num_sites=N, wavefunction_type='complex',
        composite_wavefunction_types=('fully_connected', 'fully_connected'),
        num_fc_layers=1, fc_layer_size=12,
        batch_size=512, num_monte_carlo_sweeps=2,
        sr_diag_shift=1e-4, seed=3)
    wf = build_wavefunction(config)
    params = wf.init(jax.random.key(5))
    bonds, mask = lattice.j1j2_chain_bonds(N)
    ham = HeisenbergHamiltonian(bonds, couplings=(1.0 - mask) + 0.5 * mask)

    evo = TimeEvolution(wf, ham, config, dt=0.005, mode='real')
    sampler = evo.init_state(jax.random.key(6), params)
    sampler = jax.jit(
        lambda s: evo.sweeps(params, s, 30))(sampler)  # equilibrate
    params, sampler, records = evo.evolve(params, sampler, 10)
    energies = [r['energy'] for r in records]
    # MC noise allows drift; catch sign errors / blowups, not noise.
    assert abs(energies[-1] - energies[0]) < 0.5
    assert np.all(np.isfinite(energies))
