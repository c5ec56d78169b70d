"""Observable operators vs exact-diagonalization expectation values."""

import numpy as np
import jax
import jax.numpy as jnp

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.evaluate import evaluate_operator
from cgs_vmc_jax.models import FullVector
from cgs_vmc_jax.ops.observables import (
    SpinStructureFactor,
    SzSzCorrelation,
    StaggeredMagnetizationSquared,
    TransverseCorrelation,
    chain_positions,
    square_positions,
)
from cgs_vmc_jax.utils import ed

N = 8
BONDS = lattice.chain_bonds(N)


def test_szsz_correlation_matches_ed():
    e0, v0 = ed.ground_state(N, BONDS)
    wf = FullVector.for_sector(N, v0.astype(np.float32))
    params = wf.init(jax.random.key(0))
    states = basis.enumerate_sz_basis(N)

    pairs = [(i, (i + 2) % N) for i in range(N)]  # distance-2 correlator
    obs = SzSzCorrelation(pairs)
    local = np.asarray(obs.local_value(wf, params, jnp.asarray(states)))
    weights = v0 ** 2 / np.sum(v0 ** 2)
    exact = float(np.sum(weights * local))

    config = Config(num_sites=N, batch_size=256,
                    num_equilibration_sweeps=20, num_monte_carlo_sweeps=2,
                    num_evaluation_samples=60)
    result = evaluate_operator(wf, params, obs, config,
                               key=jax.random.key(4))
    assert abs(result.mean - exact) < 5 * max(result.error, 1e-4)


def test_structure_factor_at_pi_equals_n_times_staggered_m2():
    """S(q=π) on a chain = N · m_s² config-by-config (cos(π·i) is the
    staggered sign, sin term vanishes on integer positions)."""
    e0, v0 = ed.ground_state(N, BONDS)
    wf = FullVector.for_sector(N, v0.astype(np.float32))
    params = wf.init(jax.random.key(0))
    states = jnp.asarray(basis.enumerate_sz_basis(N))

    sq = SpinStructureFactor([np.pi], chain_positions(N))
    m2 = StaggeredMagnetizationSquared(lattice.marshall_sublattice(N))
    np.testing.assert_allclose(
        np.asarray(sq.local_value(wf, params, states)),
        N * np.asarray(m2.local_value(wf, params, states)),
        rtol=1e-5, atol=1e-6)


def test_structure_factor_sum_rule_and_ed():
    """Σ_q S(q) / N = ⟨(Sᶻ)²⟩ = 1/4 per config (sum rule over the full
    Brillouin zone), and the q=π/2 MC estimate matches the ED value."""
    e0, v0 = ed.ground_state(N, BONDS)
    wf = FullVector.for_sector(N, v0.astype(np.float32))
    params = wf.init(jax.random.key(0))
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    weights = v0 ** 2 / np.sum(v0 ** 2)

    qs = 2 * np.pi * np.arange(N) / N
    pos = chain_positions(N)
    totals = np.zeros(states.shape[0])
    for q in qs:
        totals += np.asarray(
            SpinStructureFactor([q], pos).local_value(wf, params, states))
    np.testing.assert_allclose(totals / N, 0.25, rtol=1e-5)

    obs = SpinStructureFactor([np.pi / 2], pos)
    exact = float(np.sum(
        weights * np.asarray(obs.local_value(wf, params, states))))
    config = Config(num_sites=N, batch_size=256,
                    num_equilibration_sweeps=20, num_monte_carlo_sweeps=2,
                    num_evaluation_samples=60)
    result = evaluate_operator(wf, params, obs, config,
                               key=jax.random.key(6))
    assert abs(result.mean - exact) < 5 * max(result.error, 1e-4)


def test_structure_factor_pipi_staggered_identity_2d():
    """S(q=(π,π)) on the square lattice = N·(m_s^z)² config-by-config —
    the identity examples/staggered_flagship.py's m_s extraction rests on
    (cos(π(x+y)) is the checkerboard sign; the sin term vanishes)."""
    L = 4
    n = L * L
    pos = square_positions(L, L)
    sub = lattice.marshall_sublattice(n, L, L)
    # Random Sz=0 configurations via the standard initializer.
    from cgs_vmc_jax.sampler import metropolis
    from cgs_vmc_jax.models.feedforward import RestrictedBoltzmannNetwork
    wf = RestrictedBoltzmannNetwork(n, 1, 4)
    states = metropolis.init_sampler(
        jax.random.key(3), wf, wf.init(jax.random.key(4)), n, 64).configs

    sq = SpinStructureFactor([np.pi, np.pi], pos)
    got = np.asarray(sq.local_value(None, None, states))
    m_sz = np.asarray(states) @ (0.5 * sub) / n     # per-config m_s^z
    np.testing.assert_allclose(got, n * m_sz ** 2, rtol=1e-5, atol=1e-6)


def test_transverse_correlation_su2_identity():
    """Isotropic Heisenberg ground state: ⟨SˣSˣ+SʸSʸ⟩ = 2⟨SᶻSᶻ⟩ by SU(2)
    symmetry — checks the off-diagonal (exchange) local value exactly."""
    e0, v0 = ed.ground_state(N, BONDS)
    wf = FullVector.for_sector(N, v0.astype(np.float32))
    params = wf.init(jax.random.key(0))
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    weights = v0 ** 2 / np.sum(v0 ** 2)

    for d in (1, 2, 3):
        pairs = [(i, (i + d) % N) for i in range(N)]
        perp = TransverseCorrelation(pairs)
        zz = SzSzCorrelation(pairs)
        perp_exact = float(np.sum(weights * np.asarray(
            perp.local_value(wf, params, states))))
        zz_exact = float(np.sum(weights * np.asarray(
            zz.local_value(wf, params, states))))
        np.testing.assert_allclose(perp_exact, 2.0 * zz_exact,
                                   rtol=1e-3, atol=1e-6)

    # MC estimate agrees with the exact value.
    pairs = [(i, (i + 1) % N) for i in range(N)]
    perp = TransverseCorrelation(pairs)
    exact = float(np.sum(weights * np.asarray(
        perp.local_value(wf, params, states))))
    config = Config(num_sites=N, batch_size=256,
                    num_equilibration_sweeps=20, num_monte_carlo_sweeps=2,
                    num_evaluation_samples=60)
    result = evaluate_operator(wf, params, perp, config,
                               key=jax.random.key(7))
    assert abs(result.mean - exact) < 5 * max(result.error, 1e-3)


def test_square_positions_layout():
    pos = square_positions(2, 3)
    # Row-major: site index = x * size_y + y.
    np.testing.assert_array_equal(
        pos, [[0, 0], [0, 1], [0, 2], [1, 0], [1, 1], [1, 2]])


def test_staggered_magnetization():
    e0, v0 = ed.ground_state(N, BONDS)
    wf = FullVector.for_sector(N, v0.astype(np.float32))
    params = wf.init(jax.random.key(0))
    states = basis.enumerate_sz_basis(N)
    sub = lattice.marshall_sublattice(N)
    obs = StaggeredMagnetizationSquared(sub)
    local = np.asarray(obs.local_value(wf, params, jnp.asarray(states)))
    weights = v0 ** 2 / np.sum(v0 ** 2)
    exact = float(np.sum(weights * local))
    assert 0.0 < exact < 0.25  # AFM order parameter in a sane range

    config = Config(num_sites=N, batch_size=256,
                    num_equilibration_sweeps=20, num_monte_carlo_sweeps=2,
                    num_evaluation_samples=60)
    result = evaluate_operator(wf, params, obs, config,
                               key=jax.random.key(5))
    assert abs(result.mean - exact) < 5 * max(result.error, 1e-4)


def test_transverse_pair_signs_mixed_gauge():
    """pair_signs applies a ±1 weight PER PAIR inside the fused exchange
    kernel: with mixed signs the value equals the signed average of the
    single-pair correlators (the Marshall-gauge correction for pair sets
    mixing same- and cross-sublattice displacements)."""
    e0, v0 = ed.ground_state(N, BONDS)
    wf = FullVector.for_sector(N, v0.astype(np.float32))
    params = wf.init(jax.random.key(0))
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    weights = v0 ** 2 / np.sum(v0 ** 2)

    pairs = [(i, (i + 1) % N) for i in range(N)]
    signs = np.asarray([1 if i % 2 == 0 else -1 for i in range(N)],
                       np.float64)
    weighted = TransverseCorrelation(pairs, pair_signs=signs)
    got = float(np.sum(weights * np.asarray(
        weighted.local_value(wf, params, states))))

    singles = []
    for p in pairs:
        op = TransverseCorrelation([p])
        singles.append(float(np.sum(weights * np.asarray(
            op.local_value(wf, params, states)))))
    expected = float(np.mean(signs * np.asarray(singles)))
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-7)


def test_total_spin_squared_singlet_and_gauge():
    """The AFM chain ground state is an SU(2) singlet: <S^2> = 0 exactly
    — in the bare basis AND for the Marshall-gauged state with the
    per-pair exchange-sign correction.  A random sector state gives the
    dense-matrix value."""
    from cgs_vmc_jax.evaluate import exact_expectation
    from cgs_vmc_jax.ops.observables import TotalSpinSquared

    # Bare basis (jx = +1): singlet.
    e0, v0 = ed.ground_state(N, BONDS, j_x=1.0, j_z=1.0)
    wf = FullVector.for_sector(N, v0.astype(np.float32))
    params = wf.init(jax.random.key(0))
    s2 = TotalSpinSquared(N)
    val = exact_expectation(wf, params, s2, N)
    assert abs(val) < 5e-4, val

    # Marshall-gauged state (trained with jx = -1) + gauge correction.
    e0g, v0g = ed.ground_state(N, BONDS, j_x=-1.0, j_z=1.0)
    wfg = FullVector.for_sector(N, v0g.astype(np.float32))
    paramsg = wfg.init(jax.random.key(0))
    s2g = TotalSpinSquared(N, sublattice=lattice.marshall_sublattice(N))
    valg = exact_expectation(wfg, paramsg, s2g, N)
    assert abs(valg) < 5e-4, valg
    # WITHOUT the correction the gauged state is NOT a singlet of the
    # bare S^2 — the correction is load-bearing.
    val_wrong = exact_expectation(wfg, paramsg, s2, N)
    assert abs(val_wrong) > 0.5

    # Random state: matches the dense all-pairs matrix + constant.
    rng = np.random.default_rng(3)
    states = basis.enumerate_sz_basis(N)
    vec = (rng.normal(size=states.shape[0]) + 1.5).astype(np.float32)
    wfr = FullVector.for_sector(N, vec)
    paramsr = wfr.init(jax.random.key(0))
    pairs = np.asarray([(i, j) for i in range(N) for j in range(i + 1, N)],
                       np.int32)
    dense = ed.heisenberg_matrix(N, pairs, 1.0, 1.0, sparse=False)
    v64 = vec.astype(np.float64)
    want = 0.75 * N + 2.0 * float(v64 @ (dense @ v64) / (v64 @ v64))
    got = exact_expectation(wfr, paramsr, TotalSpinSquared(N), N)
    np.testing.assert_allclose(got, want, rtol=2e-4)
