"""Unit tests for lattice geometry and basis utilities."""

import numpy as np
import jax
import jax.numpy as jnp
from math import comb

import pytest

from cgs_vmc_jax import basis, lattice


def test_chain_bonds_match_reference_default():
    # Reference default: [(i, (i+1) % n) for i in range(n)]
    # (cgs_vmc/run_training.py:109).
    bonds = lattice.chain_bonds(6)
    expected = [(i, (i + 1) % 6) for i in range(6)]
    assert bonds.tolist() == [list(b) for b in expected]


def test_square_lattice_bond_count():
    bonds = lattice.square_lattice_bonds(4, 4)
    assert bonds.shape == (32, 2)  # 2*L^2 bonds on an LxL torus
    # every site has degree 4
    degree = np.zeros(16, int)
    for i, j in bonds:
        degree[i] += 1
        degree[j] += 1
    assert (degree == 4).all()


def test_square_lattice_open_boundary():
    bonds = lattice.square_lattice_bonds(3, 3, periodic=False)
    assert bonds.shape == (12, 2)  # 2*L*(L-1)


def test_marshall_sublattice_bipartite():
    mask = lattice.marshall_sublattice(16, 4, 4)
    bonds = lattice.square_lattice_bonds(4, 4)
    for i, j in bonds:
        assert mask[i] * mask[j] == -1  # neighbours on opposite sublattices


def test_random_configurations_sz0():
    configs = basis.random_configurations(jax.random.key(0), 12, 64)
    arr = np.asarray(configs)
    assert set(np.unique(arr)) == {-1.0, 1.0}
    np.testing.assert_array_equal(arr.sum(axis=1), np.zeros(64))


def test_enumerate_sz_basis():
    states = basis.enumerate_sz_basis(6)
    assert states.shape == (comb(6, 3), 6)
    assert (states.sum(axis=1) == 0).all()
    assert len(np.unique(states, axis=0)) == states.shape[0]


def test_lin_tables_bijective():
    for n in (6, 7, 10):
        top, bot = basis.make_lin_tables(n)
        states = basis.enumerate_sz_basis(n)
        idx = np.asarray(basis.lin_index(
            jnp.asarray(states), jnp.asarray(top), jnp.asarray(bot)))
        assert sorted(idx.tolist()) == list(range(states.shape[0]))


def test_basis_file_roundtrip(tmp_path):
    states = basis.enumerate_sz_basis(6)
    path = str(tmp_path / 'basis.txt')
    basis.save_basis_file(path, states)
    loaded = basis.load_basis_file(path)
    np.testing.assert_array_equal(loaded, states)


def test_adjacency_from_bonds():
    adj = lattice.adjacency_from_bonds(lattice.chain_bonds(6), 6)
    assert adj.shape == (6, 2)
    assert set(adj[0].tolist()) == {1, 5}


def test_j1j2_chain_nnn_dedup():
    """n=4 periodic chain: each NNN bond must appear once, not twice
    (round-1 ADVICE: duplicated NNN bonds doubled the effective J2)."""
    from cgs_vmc_jax.lattice import j1j2_chain_bonds
    bonds, mask = j1j2_chain_bonds(4)
    nnn = bonds[mask == 1.0]
    keys = {tuple(sorted(b)) for b in nnn.tolist()}
    assert len(keys) == len(nnn) == 2  # (0,2) and (1,3), once each
    # Larger chain unaffected: n NNN bonds for n > 4.
    bonds8, mask8 = j1j2_chain_bonds(8)
    assert int(mask8.sum()) == 8


def test_displacement_pairs_square_lattice():
    """True lattice pairs at displacement (dx,dy) — the y-offset pairs must
    match the hand-built construction in examples/measure_6x6_observables.py
    and never cross row boundaries the way flat (i, i+d) pairing does."""
    pairs = lattice.displacement_pairs(36, 6, 6, 0, 1)
    expected = [(x * 6 + y, x * 6 + (y + 1) % 6)
                for x in range(6) for y in range(6)]
    assert [tuple(p) for p in pairs] == expected
    # x-displacement wraps in x, keeps y.
    pairs_x = lattice.displacement_pairs(36, 6, 6, 2, 0)
    for i, j in pairs_x:
        assert i % 6 == j % 6          # same y
        assert (i // 6 + 2) % 6 == j // 6


def test_displacement_pairs_chain():
    pairs = lattice.displacement_pairs(8, 1, 1, 3)
    assert [tuple(p) for p in pairs] == [(i, (i + 3) % 8) for i in range(8)]


def test_triangular_lattice_geometry():
    """3 bonds/site, coordination 6, translation-invariant, dedup at L=2."""
    from cgs_vmc_jax.lattice import triangular_lattice_bonds
    bonds = triangular_lattice_bonds(4, 3)
    n = 12
    assert bonds.shape == (3 * n, 2)
    degree = np.zeros(n, int)
    for i, j in bonds:
        degree[i] += 1
        degree[j] += 1
    assert (degree == 6).all()
    # Unordered pairs unique.
    keys = {(min(i, j), max(i, j)) for i, j in bonds}
    assert len(keys) == 3 * n
    # L=2 direction: duplicate wrap bonds must be deduplicated.
    small = triangular_lattice_bonds(2, 2)
    keys = {(min(i, j), max(i, j)) for i, j in small}
    assert len(keys) == len(small)


def test_triangular_config_dispatch():
    from cgs_vmc_jax.config import Config
    from cgs_vmc_jax import lattice
    cfg = Config(num_sites=12, size_x=4, size_y=3,
                 lattice_type='triangular')
    bonds, couplings = lattice.bonds_and_couplings_for_config(cfg)
    assert bonds.shape == (36, 2) and couplings is None
    with pytest.raises(ValueError):
        lattice.bonds_and_couplings_for_config(
            Config(num_sites=12, lattice_type='triangular'))
    with pytest.raises(ValueError):
        lattice.bonds_and_couplings_for_config(
            Config(num_sites=12, size_x=4, size_y=3, lattice_type='kagome'))


@pytest.mark.slow
def test_triangular_local_energy_matches_dense_matrix():
    """Frustrated-lattice wiring: E_loc from the triangular bond list ==
    (H psi)(R)/psi(R) from the dense matrix on the same bonds."""
    from cgs_vmc_jax.lattice import triangular_lattice_bonds
    from cgs_vmc_jax.models.full_vector import FullVector
    from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
    from cgs_vmc_jax.utils import ed
    import jax
    import jax.numpy as jnp

    n = 12
    bonds = triangular_lattice_bonds(4, 3)
    rng = np.random.default_rng(1)
    dim = len(basis.enumerate_sz_basis(n))
    vec = (rng.normal(size=dim) + 2.5).astype(np.float32)
    wf = FullVector.for_sector(n, vec)
    params = wf.init(jax.random.key(0))
    states = basis.enumerate_sz_basis(n)
    ham = HeisenbergHamiltonian(bonds, j_x=1.0, j_z=1.0)
    e_loc = np.asarray(ham.local_value(wf, params, jnp.asarray(states)))
    dense = ed.heisenberg_matrix(n, bonds, j_x=1.0, j_z=1.0, sparse=False)
    expected = (dense @ vec.astype(np.float64)) / vec
    np.testing.assert_allclose(e_loc, expected, rtol=3e-4)


@pytest.mark.slow
def test_triangular_complex_sr_descends():
    """Geometric frustration end-to-end: complex fc x fc + dense SR on the
    4x3 triangular AFM torus learns a nontrivial sign structure.  No
    Marshall gauge exists here; measured positive baselines (fc, rbm, same
    budget) stall at rel err 0.60-0.70 — the complex ansatz must get
    within 0.20 of ED (measured 0.12 at 250 epochs, seed 7), i.e. far
    below anything a positive amplitude can represent."""
    from cgs_vmc_jax.config import Config
    from cgs_vmc_jax.lattice import triangular_lattice_bonds
    from cgs_vmc_jax.models import build_wavefunction
    from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
    from cgs_vmc_jax.optim.sr import StochasticReconfiguration
    from cgs_vmc_jax.utils import ed

    n = 12
    config = Config(
        num_sites=n, size_x=4, size_y=3, lattice_type='triangular',
        wavefunction_type='complex',
        composite_wavefunction_types=('fully_connected', 'fully_connected'),
        num_fc_layers=1, fc_layer_size=32,
        batch_size=256, num_batches_per_epoch=4,
        num_equilibration_sweeps=10, num_monte_carlo_sweeps=1,
        optimizer='gradient', learning_rates=[0.05, 0.02, 0.01],
        learning_rate_stops=[80, 160],
        sr_solver='dense', sr_diag_shift=1e-3, sr_delta_clip=10.0,
        heisenberg_jx=1.0, seed=7)
    wf = build_wavefunction(config)
    bonds = triangular_lattice_bonds(4, 3)
    ham = HeisenbergHamiltonian(bonds, j_x=1.0, j_z=1.0)
    opt = StochasticReconfiguration(wf, ham, config)
    state = opt.init_state(jax.random.key(config.seed))

    epoch = jax.jit(lambda s: opt.epoch(s))
    energies = []
    for _ in range(250):
        state, metrics = epoch(state)
        energies.append(float(metrics['energy']))
    e0, _ = ed.ground_state(n, bonds, 1.0, 1.0)
    final = np.mean(energies[-10:])
    rel = abs(final - e0) / abs(e0)
    assert rel < 0.20, f'triangular SR stalled: E={final} vs E0={e0} ({rel})'


def test_honeycomb_lattice_geometry():
    """3 bonds per unit cell, coordination 3, bipartite (even<->odd)."""
    from cgs_vmc_jax.lattice import honeycomb_lattice_bonds
    bonds = honeycomb_lattice_bonds(3, 3)
    n = 18
    assert bonds.shape == (3 * 9, 2)
    degree = np.zeros(n, int)
    for i, j in bonds:
        degree[i] += 1
        degree[j] += 1
        # Bipartite: every bond joins sublattice A (even index) to B
        # (odd), so the parity Marshall mask is exact.
        assert (i + j) % 2 == 1
    assert (degree == 3).all()
    keys = {(min(i, j), max(i, j)) for i, j in bonds}
    assert len(keys) == 27
    # Width-2 tori wrap duplicate pairs; emitted once.
    small = honeycomb_lattice_bonds(2, 1)
    keys = {(min(i, j), max(i, j)) for i, j in small}
    assert len(keys) == len(small)


def test_honeycomb_config_dispatch_and_marshall_gauge():
    """Dispatch + the physics: with jx = -1 (Marshall gauge) the 2x2-cell
    honeycomb AFM ground state is positive and the gauge leaves the
    spectrum unchanged."""
    from cgs_vmc_jax.config import Config
    from cgs_vmc_jax import lattice
    from cgs_vmc_jax.utils import ed
    cfg = Config(num_sites=8, size_x=2, size_y=2,
                 lattice_type='honeycomb')
    bonds, couplings = lattice.bonds_and_couplings_for_config(cfg)
    assert couplings is None
    assert bonds.shape == (12, 2)
    with pytest.raises(ValueError):
        lattice.bonds_and_couplings_for_config(
            Config(num_sites=12, size_x=2, size_y=2,
                   lattice_type='honeycomb'))
    e_gauged, v_gauged = ed.ground_state(8, bonds, j_x=-1.0, j_z=1.0)
    e_bare, _ = ed.ground_state(8, bonds, j_x=1.0, j_z=1.0)
    np.testing.assert_allclose(e_gauged, e_bare, rtol=1e-10)
    v = v_gauged * np.sign(v_gauged[np.argmax(np.abs(v_gauged))])
    assert (v > -1e-10).all()   # positive ground state in the gauge


@pytest.mark.slow
def test_honeycomb_sr_reaches_ed():
    """End-to-end: Marshall-gauged RBM + dense SR on the 2x2-cell (8-site)
    honeycomb AFM torus converges to the ED ground state."""
    from cgs_vmc_jax.config import Config
    from cgs_vmc_jax import lattice
    from cgs_vmc_jax.models import build_wavefunction
    from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
    from cgs_vmc_jax.optim.sr import StochasticReconfiguration
    from cgs_vmc_jax.utils import ed

    n = 8
    config = Config(
        num_sites=n, size_x=2, size_y=2, lattice_type='honeycomb',
        wavefunction_type='rbm', num_fc_layers=0, fc_layer_size=24,
        batch_size=256, num_batches_per_epoch=2,
        num_equilibration_sweeps=5, num_monte_carlo_sweeps=1,
        optimizer='gradient', learning_rates=[0.05, 0.02],
        learning_rate_stops=[120],
        sr_solver='dense', sr_diag_shift=1e-2, sr_delta_clip=1.0,
        heisenberg_jx=-1.0, use_fast_sampler=False, seed=3)
    wf = build_wavefunction(config)
    bonds = lattice.bonds_for_config(config)
    ham = HeisenbergHamiltonian(bonds, j_x=-1.0, j_z=1.0)
    opt = StochasticReconfiguration(wf, ham, config)
    state = opt.init_state(jax.random.key(config.seed))
    epoch = jax.jit(lambda s: opt.epoch(s))
    energies = []
    for _ in range(200):
        state, metrics = epoch(state)
        energies.append(float(metrics['energy']))
    e0, _ = ed.ground_state(n, bonds, -1.0, 1.0)
    final = np.mean(energies[-10:])
    rel = abs(final - e0) / abs(e0)
    assert rel < 5e-3, f'honeycomb SR stalled: E={final} vs E0={e0} ({rel})'


def test_kagome_lattice_geometry():
    """6 bonds/cell, coordination 4, corner-sharing triangles (odd
    cycles -> frustrated, NOT bipartite)."""
    from cgs_vmc_jax.lattice import kagome_lattice_bonds
    bonds = kagome_lattice_bonds(3, 3)
    n = 27
    assert bonds.shape == (6 * 9, 2)
    degree = np.zeros(n, int)
    for i, j in bonds:
        degree[i] += 1
        degree[j] += 1
    assert (degree == 4).all()
    keys = {(min(i, j), max(i, j)) for i, j in bonds}
    assert len(keys) == 54
    # In-cell up-triangle is an odd cycle: sites 0,1,2 pairwise bonded.
    assert {(0, 1), (1, 2), (0, 2)} <= keys
    small = kagome_lattice_bonds(2, 2)
    keys = {(min(i, j), max(i, j)) for i, j in small}
    assert len(keys) == len(small)


@pytest.mark.slow
def test_kagome_config_dispatch_and_local_energy():
    """Dispatch + wiring: kagome E_loc from the bond list == the dense
    matrix on the same bonds (2x2 cells, 12 sites)."""
    from cgs_vmc_jax.config import Config
    from cgs_vmc_jax import lattice
    from cgs_vmc_jax.models.full_vector import FullVector
    from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
    from cgs_vmc_jax.utils import ed
    import jax.numpy as jnp

    cfg = Config(num_sites=12, size_x=2, size_y=2, lattice_type='kagome')
    bonds, couplings = lattice.bonds_and_couplings_for_config(cfg)
    assert couplings is None and bonds.shape == (24, 2)
    with pytest.raises(ValueError):
        lattice.bonds_and_couplings_for_config(
            Config(num_sites=12, size_x=3, size_y=3,
                   lattice_type='kagome'))
    n = 12
    rng = np.random.default_rng(2)
    dim = len(basis.enumerate_sz_basis(n))
    vec = (rng.normal(size=dim) + 2.5).astype(np.float32)
    wf = FullVector.for_sector(n, vec)
    params = wf.init(jax.random.key(0))
    states = basis.enumerate_sz_basis(n)
    ham = HeisenbergHamiltonian(bonds, j_x=1.0, j_z=1.0)
    e_loc = np.asarray(ham.local_value(wf, params, jnp.asarray(states)))
    dense = ed.heisenberg_matrix(n, bonds, j_x=1.0, j_z=1.0, sparse=False)
    expected = (dense @ vec.astype(np.float64)) / vec
    np.testing.assert_allclose(e_loc, expected, rtol=2e-4)
