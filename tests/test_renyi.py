"""Renyi-2 swap-operator estimator vs exact diagonalization."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import FullVector
from cgs_vmc_jax.ops import renyi
from cgs_vmc_jax.utils import ed

N = 8
BONDS = lattice.chain_bonds(N)


def test_exact_renyi2_product_state():
    """A single-configuration (product) state has S2 = 0 for any cut."""
    states = basis.enumerate_sz_basis(N)
    v = np.zeros(states.shape[0])
    v[7] = 1.0
    for region in ([0], [0, 1], [0, 1, 2, 3]):
        assert abs(renyi.exact_renyi2(v, states, region)) < 1e-12


def test_swap_values_exact_mean():
    """Full-basis double sum: Σ_{x,y} p(x)p(y)·swap(x,y) == tr(rho_A²)."""
    e0, v0 = ed.ground_state(N, BONDS)
    wf = FullVector.for_sector(N, v0.astype(np.float32))
    params = wf.init(jax.random.key(0))
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    dim = states.shape[0]
    p = v0 ** 2 / np.sum(v0 ** 2)

    region = [0, 1, 2]
    mask = renyi.region_mask(N, region)
    # All (x, y) pairs in one batch.
    xs = jnp.repeat(states, dim, axis=0)
    ys = jnp.tile(states, (dim, 1))
    values = np.asarray(renyi.swap_values(wf, params, xs, ys, mask))
    swap_mean = float(np.sum(
        (p[:, None] * p[None, :]).reshape(-1) * values))

    exact = np.exp(-renyi.exact_renyi2(
        v0, np.asarray(states), region))  # tr(rho_A^2)
    np.testing.assert_allclose(swap_mean, exact, rtol=1e-4)


def test_swap_values_complex_state():
    """The swap estimator is phase-correct: a complex state's exact
    double-sum still equals tr(rho_A²)."""
    from cgs_vmc_jax.models.complex_phase import ComplexPhaseWavefunction
    rng = np.random.default_rng(2)
    states_np = basis.enumerate_sz_basis(N)
    dim = states_np.shape[0]
    modulus = rng.uniform(0.2, 1.0, size=dim)
    phi = rng.uniform(-2.0, 2.0, size=dim)
    psi = modulus * np.exp(1j * phi)
    wf = ComplexPhaseWavefunction(
        FullVector.for_sector(N, modulus.astype(np.float32)),
        FullVector.for_sector(N, np.exp(phi).astype(np.float32)))
    params = wf.init(jax.random.key(0))
    states = jnp.asarray(states_np)
    p = np.abs(psi) ** 2 / np.sum(np.abs(psi) ** 2)

    region = [0, 1]
    mask = renyi.region_mask(N, region)
    xs = jnp.repeat(states, dim, axis=0)
    ys = jnp.tile(states, (dim, 1))
    values = np.asarray(renyi.swap_values(wf, params, xs, ys, mask))
    swap_mean = float(np.sum(
        (p[:, None] * p[None, :]).reshape(-1) * values))
    exact = np.exp(-renyi.exact_renyi2(psi, states_np, region))
    np.testing.assert_allclose(swap_mean, exact, rtol=2e-4)


@pytest.mark.slow
def test_renyi2_mc_matches_ed():
    e0, v0 = ed.ground_state(N, BONDS)
    wf = FullVector.for_sector(N, v0.astype(np.float32))
    params = wf.init(jax.random.key(0))
    states = basis.enumerate_sz_basis(N)

    config = Config(num_sites=N, batch_size=512,
                    num_equilibration_sweeps=20, num_monte_carlo_sweeps=2,
                    num_evaluation_samples=80)
    for region in ([0, 1], [0, 1, 2, 3]):
        exact = renyi.exact_renyi2(v0, states, region)
        s2, err = renyi.evaluate_renyi2(wf, params, region, config,
                                        key=jax.random.key(13))
        assert abs(s2 - exact) < 6 * max(err, 5e-3), \
            f'region {region}: S2={s2} vs ED {exact} (err {err})'
