"""Twisted boundary conditions / spin stiffness (ops/heisenberg.py
twist_phases + lattice.twist_phases + utils/ed.py mirror).

Oracles: per-basis-state local-value identity against the dense complex
Hermitian matrix; uniform-gauge winding; pure-gauge spectrum invariance;
E(phi) evenness + positive curvature (the stiffness); end-to-end complex
SR training on a twisted chain.  Beyond the reference entirely (it has
no twisted Hamiltonians and no complex local energies).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.utils import ed

N = 8
BONDS = lattice.chain_bonds(N)
PHI = 0.7


def test_local_value_matches_dense_twisted_matrix():
    """E_loc(R) == (H(phi) psi)(R) / psi(R) for every sector basis state,
    complex weights included."""
    phases = lattice.twist_phases(N, BONDS, PHI, size_x=N)
    ham = HeisenbergHamiltonian(BONDS, j_x=-1.0, j_z=1.0,
                                twist_phases=phases)
    mat = ed.heisenberg_matrix(N, BONDS, j_x=-1.0, j_z=1.0,
                               twist_phases=phases)
    assert mat.dtype == np.complex128
    np.testing.assert_allclose(mat, mat.conj().T, atol=1e-14)  # Hermitian

    cfg = Config(num_sites=N, wavefunction_type='rbm', num_fc_layers=0,
                 fc_layer_size=12, seed=3)
    wf = build_wavefunction(cfg)
    params = wf.init(jax.random.key(5))
    states = basis.enumerate_sz_basis(N)
    configs = jnp.asarray(states, jnp.float32)
    amp = wf.apply(params, configs)
    psi = np.asarray(amp.sign, np.float64) * np.exp(
        np.asarray(amp.log, np.float64))
    expected = (mat @ psi) / psi

    e_loc = np.asarray(ham.local_value(wf, params, configs))
    assert np.iscomplexobj(e_loc)
    np.testing.assert_allclose(e_loc, expected, rtol=5e-5, atol=5e-6)


def test_uniform_gauge_winds_exactly_phi():
    """The twist table accumulates exactly phi around the torus, per
    direction, including the wrap bond (a raw coordinate-difference gauge
    would telescope to zero and twist nothing)."""
    phases = lattice.twist_phases(N, BONDS, PHI, size_x=N)
    # Directed +x loop over the chain: bonds as (i, i+1), wrap included.
    # chain_bonds emits (i, (i+1) % N); phase of bond b is theta_i-theta_j
    # convention folded into exp(i d (s_i - s_j)/2), so the loop sum of
    # (-delta_b) over bonds traversed i->j must be +phi (or -phi; the
    # overall sign is a convention — E(phi) is even).
    assert abs(abs(phases.sum()) - PHI) < 1e-12

    bonds_sq = lattice.square_lattice_bonds(4, 4)
    ph_x = lattice.twist_phases(16, bonds_sq, PHI, size_x=4, size_y=4,
                                direction='x')
    ph_y = lattice.twist_phases(16, bonds_sq, PHI, size_x=4, size_y=4,
                                direction='y')
    # Each of the 4 rows (columns) winds once: total 4*phi, x-bonds only.
    assert abs(abs(ph_x.sum()) - 4 * PHI) < 1e-12
    assert abs(abs(ph_y.sum()) - 4 * PHI) < 1e-12
    # x-twist puts no phase on y-bonds and vice versa.
    is_x_bond = (bonds_sq[:, 0] // 4) != (bonds_sq[:, 1] // 4)
    assert np.all(ph_x[~is_x_bond] == 0)
    assert np.all(ph_y[is_x_bond] == 0)


def test_pure_gauge_leaves_spectrum_unchanged():
    """Phases that telescope from site angles (delta_b = theta_i - theta_j)
    are a unitary gauge: identical spectrum to the untwisted model."""
    rng = np.random.default_rng(7)
    theta = rng.uniform(-np.pi, np.pi, size=N)
    phases = theta[BONDS[:, 0]] - theta[BONDS[:, 1]]
    e_plain = np.linalg.eigvalsh(
        ed.heisenberg_matrix(N, BONDS, j_x=-1.0, j_z=1.0))
    e_gauged = np.linalg.eigvalsh(
        ed.heisenberg_matrix(N, BONDS, j_x=-1.0, j_z=1.0,
                             twist_phases=phases))
    np.testing.assert_allclose(e_gauged, e_plain, atol=1e-10)


def test_stiffness_curvature_positive_and_even():
    """E0(phi) is even in phi and curves upward at phi=0; the curvature is
    the spin stiffness rho_s = L * d^2 E0/dphi^2 (chain).  Cross-checked
    at two step sizes (Richardson-stable to ~1%)."""
    def e0(phi):
        phases = lattice.twist_phases(N, BONDS, phi, size_x=N)
        e, _ = ed.ground_state(N, BONDS, j_x=-1.0, j_z=1.0,
                               twist_phases=phases)
        return e

    e_center = e0(0.0)
    for d in (0.2, 0.1):
        e_p, e_m = e0(d), e0(-d)
        np.testing.assert_allclose(e_p, e_m, atol=1e-10)  # even
        assert e_p > e_center                             # variational min
    rho1 = N * (e0(0.2) - 2 * e_center + e0(-0.2)) / 0.2**2
    rho2 = N * (e0(0.1) - 2 * e_center + e0(-0.1)) / 0.1**2
    assert rho1 > 0 and rho2 > 0
    np.testing.assert_allclose(rho1, rho2, rtol=2e-2)
    # Finite-chain stiffness is O(0.1-0.5) J here; sanity-band it so a
    # convention error (e.g. phases applied to the diagonal) fails loudly.
    assert 0.05 < rho2 < 2.0


@pytest.mark.slow
def test_complex_sr_trains_on_twisted_chain():
    """End-to-end: dense SR with the complex (modulus x phase) ansatz
    reaches a few percent of the twisted-chain ED ground energy — complex
    local energies flow through sampling, SR solve, and metrics."""
    n = 6
    bonds = lattice.chain_bonds(n)
    phases = lattice.twist_phases(n, bonds, PHI, size_x=n)
    e0, _ = ed.ground_state(n, bonds, j_x=-1.0, j_z=1.0,
                            twist_phases=phases)

    cfg = Config(num_sites=n, wavefunction_type='complex',
                 composite_wavefunction_types=['fully_connected',
                                               'fully_connected'],
                 num_fc_layers=1, fc_layer_size=16,
                 batch_size=256, num_batches_per_epoch=2,
                 num_equilibration_sweeps=3, num_monte_carlo_sweeps=1,
                 learning_rates=[0.05, 0.02], learning_rate_stops=[80],
                 optimizer='gradient', heisenberg_jx=-1.0,
                 sr_diag_shift=1e-3, sr_solver='dense',
                 sr_delta_clip=1.0, seed=9)
    wf = build_wavefunction(cfg)
    ham = HeisenbergHamiltonian(bonds, -1.0, 1.0, twist_phases=phases)
    from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
    opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
    state = opt.init_state(jax.random.key(11))
    epoch_fn = jax.jit(opt.epoch)
    energies = []
    for _ in range(150):
        state, metrics = epoch_fn(state)
        energies.append(float(metrics['energy']))
    late = np.mean(energies[-10:])
    assert np.isfinite(energies).all()
    assert abs(late - e0) / abs(e0) < 0.05, f'late {late:.4f} vs ED {e0:.4f}'


def test_config_builds_twisted_hamiltonian():
    """config.twist_phi wires through build_hamiltonian for chains and
    square lattices (geometry resolution mirrors the bond builder)."""
    from cgs_vmc_jax.train import build_hamiltonian

    chain_cfg = Config(num_sites=N, heisenberg_jx=-1.0, twist_phi=PHI)
    ham = build_hamiltonian(chain_cfg)
    np.testing.assert_allclose(
        ham.twist_phases,
        lattice.twist_phases(N, lattice.chain_bonds(N), PHI, size_x=N))

    sq_cfg = Config(num_sites=16, size_x=4, size_y=4, heisenberg_jx=-1.0,
                    twist_phi=PHI, twist_direction='y')
    ham_sq = build_hamiltonian(sq_cfg)
    np.testing.assert_allclose(
        ham_sq.twist_phases,
        lattice.twist_phases(16, lattice.square_lattice_bonds(4, 4), PHI,
                             size_x=4, size_y=4, direction='y'))

    assert build_hamiltonian(
        Config(num_sites=N, heisenberg_jx=-1.0)).twist_phases is None


def test_twist_refuses_unsupported_geometries(tmp_path):
    """twist_phi on a non-chain/square geometry or a J-file must raise:
    twist_phases derives coordinates from the built-in site indexing, so
    honeycomb/kagome/J-file graphs would silently get unphysical phases
    (round-4 advisor finding)."""
    from cgs_vmc_jax.train import build_hamiltonian
    import pytest

    with pytest.raises(ValueError, match='twist_phi'):
        build_hamiltonian(Config(num_sites=8, heisenberg_jx=-1.0,
                                 lattice_type='honeycomb', size_x=2,
                                 size_y=2, twist_phi=0.3))

    j_file = tmp_path / 'J.txt'
    j_file.write_text('0 1\n1 2\n2 0\n')
    with pytest.raises(ValueError, match='j_file'):
        build_hamiltonian(Config(num_sites=3, heisenberg_jx=-1.0,
                                 j_file_path=str(j_file), twist_phi=0.3))
