"""Linear-response dynamics oracles (ops/dynamics.py).

On the complete (modulus, phase) parameterization TDVP is exact
Schrodinger evolution (tests/test_tvmc.py), so the linear-response
correlator must match the dense Re<0|O(t) O|0>_c and the spectral
transform must peak at exact excitation energies with the exact
weights.  NEW capability beyond the reference (no dynamics at all)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import scipy.linalg

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.models import FullVector
from cgs_vmc_jax.models.complex_phase import ComplexPhaseWavefunction
from cgs_vmc_jax.ops import dynamics, logamp
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.ops.observables import chain_positions
from cgs_vmc_jax.utils import ed

N = 6


def _setup():
    bonds = lattice.chain_bonds(N)
    mat = ed.heisenberg_matrix(N, bonds, 1.0, 1.0)
    dense = mat.toarray() if hasattr(mat, 'toarray') else np.asarray(mat)
    ham = HeisenbergHamiltonian(bonds, 1.0, 1.0)
    return dense, ham


def _exact_param_wf(v0: np.ndarray):
    wf = ComplexPhaseWavefunction(
        FullVector.for_sector(N, v0.astype(np.float32)),
        FullVector.for_sector(N, np.ones_like(v0, np.float32)))
    return wf, wf.init(jax.random.key(0))


def _probe_matrix(probe, states):
    """Dense diagonal matrix of the probe over the enumerated basis."""
    coeff = np.asarray(probe.coeff, np.float64)
    return np.diag((0.5 * np.asarray(states, np.float64) @ coeff))


def _state_vector(wf, params, states):
    amp = wf.apply(params, states)
    psi = np.asarray(logamp.to_value(
        amp._replace(log=amp.log - np.real(np.asarray(amp.log)).max())))
    return psi / np.linalg.norm(psi)


@pytest.mark.slow
def test_quench_matches_first_order_multiplication():
    """The tangent-space quench on a complete manifold IS (1 + eps O) to
    first order: fidelity with the dense (1 + eps O)|0> state is
    1 - O(eps^4)."""
    dense, _ = _setup()
    _, vecs = np.linalg.eigh(dense)
    v0 = vecs[:, 0]
    wf, params = _exact_param_wf(v0)
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    probe = dynamics.FourierSz([np.pi], chain_positions(N))
    o_mat = _probe_matrix(probe, states)

    eps = 0.05
    amp = wf.apply(params, states)
    weights = jax.nn.softmax(2.0 * jnp.real(amp.log))
    quenched = dynamics.quench_params(wf, params, states, probe, eps,
                                      weights=weights)
    got = _state_vector(wf, quenched, states)
    want = v0 + eps * (o_mat @ v0)
    want = want / np.linalg.norm(want)
    fidelity = abs(np.vdot(got, want))
    assert fidelity > 1 - 5e-5, fidelity


@pytest.mark.slow
def test_correlator_matches_dense_dynamics():
    """C(t) from the exact-basis linear-response run == the dense
    Re<0|O(t)O|0>_connected, within O(eps^2) + integrator error."""
    dense, ham = _setup()
    vals, vecs = np.linalg.eigh(dense)
    v0 = vecs[:, 0]
    wf, params = _exact_param_wf(v0)
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    probe = dynamics.FourierSz([np.pi], chain_positions(N))
    o_mat = _probe_matrix(probe, states)

    dt, n_steps, eps = 0.02, 60, 0.05
    times, corr, diag = dynamics.exact_linear_response(
        wf, params, ham, probe, states, eps, dt, n_steps)
    # Complete manifold: the McLachlan residual must be ~0 throughout.
    assert max(diag['tdvp_r2']) < 1e-4

    ov = o_mat @ v0
    o0 = float(v0 @ ov)
    want = []
    for t in times:
        u = scipy.linalg.expm(-1j * dense * t)
        want.append(np.real(np.vdot(u @ v0, o_mat @ (u @ ov))) - o0 * o0)
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(corr, want, atol=0.02 * scale + 5e-4)


def test_spectral_peak_at_excitation_energy():
    """S(q=pi, omega) peaks at the lowest O-coupled excitation with the
    exact spectral weight dominating."""
    dense, ham = _setup()
    vals, vecs = np.linalg.eigh(dense)
    v0 = vecs[:, 0]
    wf, params = _exact_param_wf(v0)
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    probe = dynamics.FourierSz([np.pi], chain_positions(N))
    o_mat = _probe_matrix(probe, states)

    # Exact spectral decomposition: weights |<n|O|0>|^2 at E_n - E_0.
    amps = vecs.T @ (o_mat @ v0)
    w_exact = amps ** 2
    w_exact[0] = 0.0  # connected part
    gaps = vals - vals[0]
    main = int(np.argmax(w_exact))

    dt, n_steps, eps, eta = 0.02, 400, 0.05, 0.25
    times, corr, _ = dynamics.exact_linear_response(
        wf, params, ham, probe, states, eps, dt, n_steps)
    omegas = np.linspace(0.05, gaps.max() + 1.0, 400)
    s = dynamics.spectral_function(times, corr, omegas, eta)
    peak_omega = omegas[int(np.argmax(s))]
    assert abs(peak_omega - gaps[main]) < 2 * eta, (peak_omega, gaps[main])
    # On-peak height of the finite-window transform of w*cos(w0 t):
    # 2 int_0^T cos(w0 t)^2 e^{-eta t} w dt ~= w (1 - e^{-eta T}) / eta.
    peak_height = s.max()
    t_max = times[-1]
    expected = w_exact[main] * (1.0 - np.exp(-eta * t_max)) / eta
    assert 0.7 * expected < peak_height < 1.4 * expected, (
        peak_height, expected)


@pytest.mark.slow
def test_sampled_linear_response_runs():
    """MC path smoke + consistency: sampled C(t) tracks the dense answer
    within MC noise on a short window."""
    from cgs_vmc_jax.config import Config
    dense, ham = _setup()
    vals, vecs = np.linalg.eigh(dense)
    v0 = vecs[:, 0]
    wf, params = _exact_param_wf(v0)
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    probe = dynamics.FourierSz([np.pi], chain_positions(N))
    o_mat = _probe_matrix(probe, states)

    cfg = Config(num_sites=N, batch_size=1024,
                 num_equilibration_sweeps=20, num_monte_carlo_sweeps=1,
                 sr_diag_shift=1e-4, seed=5)
    dt, n_steps, eps = 0.05, 10, 0.1
    times, corr, records = dynamics.sampled_linear_response(
        wf, params, ham, probe, cfg, eps, dt, n_steps)
    assert len(records) == n_steps
    assert np.isfinite(corr).all()
    ov = o_mat @ v0
    o0 = float(v0 @ ov)
    want = []
    for t in times:
        u = scipy.linalg.expm(-1j * dense * t)
        want.append(np.real(np.vdot(u @ v0, o_mat @ (u @ ov))) - o0 * o0)
    want = np.asarray(want)
    # MC tolerance: the antithetic coupled-chain estimator's residual
    # noise over 1024 chains, a few sigma.
    assert np.max(np.abs(corr - want)) < 0.2 * np.abs(want).max() + 0.05


@pytest.mark.slow
def test_cli_evolve_linear_response(tmp_path, capsys):
    """`cgs evolve --linear_response` end-to-end on a tiny complex
    ansatz: writes (t, C(t)) + S(q, omega) and prints the peak."""
    import json as json_lib
    from cgs_vmc_jax.cli import main as cli_main
    run_dir = str(tmp_path / 'lr_run')
    rc = cli_main([
        'train', '--checkpoint_dir', run_dir,
        '--num_sites', str(N), '--num_epochs', '1',
        '--wavefunction_type', 'complex',
        '--optimizer_type', 'EnergyGradient',
        '--heisenberg_jx', '-1.0',
        '--override',
        "composite_wavefunction_types=[fully_connected;fully_connected],"
        'num_fc_layers=1,fc_layer_size=6,batch_size=16,'
        'num_batches_per_epoch=1,num_equilibration_sweeps=1',
    ])
    assert rc == 0
    rc = cli_main(['evolve', '--checkpoint_dir', run_dir,
                   '--linear_response', '1', '--eps', '0.05',
                   '--dt', '0.02', '--steps', '3',
                   '--override', 'num_equilibration_sweeps=2'])
    assert rc == 0
    out = capsys.readouterr().out
    assert 'S(q,omega) peak at omega=' in out
    with open(f'{run_dir}/linear_response.jsonl') as f:
        lines = [json_lib.loads(line) for line in f]
    assert len(lines[0]['times']) == 4
    assert np.isfinite(lines[0]['correlator']).all()
    assert np.isfinite(lines[1]['spectral_function']).all()
