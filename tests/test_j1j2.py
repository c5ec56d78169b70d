"""Per-bond couplings / frustrated J1-J2 model: ED + local-energy oracles.

The reference's J.txt carried bare bond indices with a single global
coupling (cgs_vmc/run_training.py:105-113); per-bond couplings are a new
capability enabling frustrated (non-bipartite-sign) Hamiltonians.
"""

import numpy as np
import jax
import jax.numpy as jnp

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import FullVector
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.train import build_hamiltonian
from cgs_vmc_jax.utils import ed

N = 8


def _j1j2(j2: float):
    bonds, mask = lattice.j1j2_chain_bonds(N)
    couplings = (1.0 - mask) + j2 * mask
    return bonds, couplings


def test_majumdar_ghosh_exact_energy():
    """At J2/J1 = 1/2 (Majumdar-Ghosh point) the periodic-chain ground
    state is the exact dimer product with E0 = -3N/8."""
    bonds, couplings = _j1j2(0.5)
    e0, _ = ed.ground_state(N, bonds, couplings=couplings)
    np.testing.assert_allclose(e0, -3.0 * N / 8.0, rtol=1e-12)


def test_local_energy_matches_dense_matrix():
    """E_loc(R) from the batched connected-config kernel must equal
    (H v)(R) / v(R) from the dense sector matrix, per basis state."""
    bonds, couplings = _j1j2(0.4)
    e0, v0 = ed.ground_state(N, bonds, couplings=couplings)
    mat = ed.heisenberg_matrix(N, bonds, couplings=couplings)
    dense = mat.toarray() if hasattr(mat, 'toarray') else mat

    # Generic vector (not an eigenstate) exercises off-diagonal terms.
    rng = np.random.default_rng(0)
    v = rng.normal(size=v0.shape) + 2.5  # mostly positive, some sign flips
    wf = FullVector.for_sector(N, v.astype(np.float32))
    params = wf.init(jax.random.key(0))
    states = jnp.asarray(basis.enumerate_sz_basis(N))

    ham = HeisenbergHamiltonian(bonds, couplings=couplings)
    e_local = np.asarray(ham.local_value(wf, params, states))
    expected = (dense @ v) / v
    np.testing.assert_allclose(e_local, expected, rtol=2e-4)

    # Sanity: the ground state is a zero-variance eigenstate.
    wf0 = FullVector.for_sector(N, v0.astype(np.float32))
    params0 = wf0.init(jax.random.key(0))
    e_gs = np.asarray(ham.local_value(wf0, params0, states))
    np.testing.assert_allclose(e_gs, e0, rtol=1e-4)


def test_config_builds_j1j2_hamiltonian():
    config = Config(num_sites=N, heisenberg_j2=0.3)
    ham = build_hamiltonian(config)
    assert ham.n_bonds == 2 * N  # N nearest + N next-nearest (periodic)
    c = np.asarray(ham.couplings)
    np.testing.assert_allclose(c[:N], 1.0)
    np.testing.assert_allclose(c[N:], 0.3, rtol=1e-6)


def test_j_file_coupling_column(tmp_path):
    path = tmp_path / 'J.txt'
    path.write_text('0 1 1.0\n1 2 0.5\n2 0 0.25\n')
    bonds, couplings = lattice.load_bonds_and_couplings(str(path))
    np.testing.assert_array_equal(bonds, [[0, 1], [1, 2], [2, 0]])
    np.testing.assert_allclose(couplings, [1.0, 0.5, 0.25])

    config = Config(num_sites=3, j_file_path=str(path))
    ham = build_hamiltonian(config)
    assert ham.n_bonds == 3
    np.testing.assert_allclose(np.asarray(ham.couplings), [1.0, 0.5, 0.25])

    # Two-column files (the reference format) still load, couplings=None.
    path2 = tmp_path / 'J2.txt'
    path2.write_text('0 1\n1 2\n')
    bonds2, couplings2 = lattice.load_bonds_and_couplings(str(path2))
    np.testing.assert_array_equal(bonds2, [[0, 1], [1, 2]])
    assert couplings2 is None


def test_marshall_gauge_spectrum_invariant():
    """The sublattice-A pi-rotation is a unitary: the gauged Hamiltonian
    (off-diagonal −J1/+J2, diagonal +J1/+J2) must have the identical
    spectrum to the bare J1–J2 model."""
    bonds, mask = lattice.j1j2_chain_bonds(N)
    for j2 in (0.2, 0.4, 0.55):
        diag = (1.0 - mask) + j2 * mask
        off = -(1.0 - mask) + j2 * mask
        bare = ed.heisenberg_matrix(N, bonds, couplings=diag)
        gauged = ed.heisenberg_matrix(N, bonds, couplings=diag,
                                      offdiag_couplings=off)
        to_d = lambda m: m.toarray() if hasattr(m, 'toarray') else m
        ev_bare = np.linalg.eigvalsh(to_d(bare))
        ev_gauged = np.linalg.eigvalsh(to_d(gauged))
        np.testing.assert_allclose(ev_gauged, ev_bare, atol=1e-10)


def test_gauged_local_value_matches_dense_matrix():
    """local_value with offdiag_couplings equals (H_gauged v)/v per basis
    state — the operator kernel and the ED oracle implement the same
    gauged matrix."""
    bonds, mask = lattice.j1j2_chain_bonds(N)
    j2 = 0.45
    diag = (1.0 - mask) + j2 * mask
    off = -(1.0 - mask) + j2 * mask
    mat = ed.heisenberg_matrix(N, bonds, couplings=diag,
                               offdiag_couplings=off)
    dense = mat.toarray() if hasattr(mat, 'toarray') else mat

    rng = np.random.default_rng(3)
    v = rng.normal(size=dense.shape[0]) + 2.5
    wf = FullVector.for_sector(N, v.astype(np.float32))
    params = wf.init(jax.random.key(0))
    states = jnp.asarray(basis.enumerate_sz_basis(N))

    ham = HeisenbergHamiltonian(bonds, couplings=diag,
                                offdiag_couplings=off)
    e_local = np.asarray(ham.local_value(wf, params, states))
    expected = (dense @ v) / v
    np.testing.assert_allclose(e_local, expected, rtol=2e-4)


def test_gauged_ground_state_near_positive():
    """The point of the gauge: at moderate J2/J1 the gauged ground state
    is (near-)positive, while the bare one has heavy sign structure."""
    bonds, mask = lattice.j1j2_chain_bonds(N)
    j2 = 0.3
    diag = (1.0 - mask) + j2 * mask
    off = -(1.0 - mask) + j2 * mask
    _, v_bare = ed.ground_state(N, bonds, couplings=diag)
    _, v_gauged = ed.ground_state(N, bonds, couplings=diag,
                                  offdiag_couplings=off)
    # Fraction of l2 weight carried by the dominant sign.
    frac = lambda v: max((v[v > 0] ** 2).sum(), (v[v < 0] ** 2).sum())
    assert frac(v_gauged) > 0.999
    assert frac(v_bare) < 0.9


def test_config_builds_gauged_hamiltonian():
    config = Config(num_sites=N, heisenberg_j2=0.5,
                    heisenberg_marshall_gauge=True)
    ham = build_hamiltonian(config)
    np.testing.assert_allclose(np.asarray(ham.couplings[:N]), 1.0)
    np.testing.assert_allclose(np.asarray(ham.offdiag_couplings[:N]), -1.0)
    np.testing.assert_allclose(np.asarray(ham.offdiag_couplings[N:]), 0.5)

    import pytest
    with pytest.raises(ValueError, match='marshall_gauge'):
        build_hamiltonian(Config(num_sites=N, heisenberg_marshall_gauge=True))


def test_j1j2_square_bonds():
    bonds, mask = lattice.j1j2_square_bonds(4, 4)
    # 4x4 periodic: 32 NN bonds + 32 diagonal bonds.
    assert bonds.shape == (64, 2)
    assert mask.sum() == 32 and (1 - mask).sum() == 32
    # No duplicate unordered pairs.
    keys = {(min(i, j), max(i, j)) for i, j in bonds}
    assert len(keys) == 64
