"""Lanczos-step evaluator oracles (ops/lanczos.py).

The physics gives exact checks: for small chains the dense sector
Hamiltonian (utils/ed.py) yields h_p = psi^T H^p psi / psi^T psi in
closed form; the estimator moments, the closed-form optimal alpha, the
variational ordering E0_exact <= E(alpha*) <= E(0), and the eigenstate
degenerate case are all pinned against it.  NEW capability beyond the
reference (it measures only <H>, cgs_vmc/evaluation.py:74-152).
"""

import numpy as np
import jax
import pytest

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import FullVector, build_wavefunction
from cgs_vmc_jax.ops import lanczos
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.utils import ed

N = 8


def _dense_setup(jx=-1.0):
    bonds = lattice.chain_bonds(N)
    ham = HeisenbergHamiltonian(bonds, jx, 1.0)
    h_dense = np.asarray(ed.heisenberg_matrix(N, bonds, jx, 1.0,
                                              sparse=False), np.float64)
    return ham, h_dense


def _dense_moments(h_dense, psi):
    psi = np.asarray(psi, np.float64)
    hp = psi
    out = []
    norm = psi @ psi
    for _ in range(4):
        hp = h_dense @ hp
        out.append(float(psi @ hp / norm))
    return tuple(out)


@pytest.mark.slow
def test_exact_moments_match_dense_ed():
    # A generic (non-eigenstate) vector exercises every estimator term.
    ham, h_dense = _dense_setup()
    rng = np.random.default_rng(3)
    dim = h_dense.shape[0]
    vec = rng.normal(size=dim) + 0.5
    wf = FullVector.for_sector(N, vec.astype(np.float32))
    params = wf.init(jax.random.key(0))
    res = lanczos.exact_lanczos(wf, params, ham, N)
    want = _dense_moments(h_dense, vec)
    np.testing.assert_allclose(res.moments, want, rtol=2e-4)


def test_lanczos_energy_matches_dense_rayleigh():
    # E(alpha) from the moments must equal the dense Rayleigh quotient of
    # (1 + alpha H) psi, for several alphas.
    ham, h_dense = _dense_setup()
    rng = np.random.default_rng(5)
    vec = rng.normal(size=h_dense.shape[0]) + 0.4
    wf = FullVector.for_sector(N, vec.astype(np.float32))
    params = wf.init(jax.random.key(0))
    res = lanczos.exact_lanczos(wf, params, ham, N)
    for alpha in (-0.3, -0.05, 0.02, 0.2):
        psi_a = vec + alpha * (h_dense @ vec)
        want = float(psi_a @ h_dense @ psi_a / (psi_a @ psi_a))
        got = lanczos.lanczos_energy(alpha, res.moments)
        np.testing.assert_allclose(got, want, rtol=5e-4)


def test_step_improves_perturbed_ground_state():
    ham, h_dense = _dense_setup()
    e_exact, v0 = ed.ground_state(N, lattice.chain_bonds(N), -1.0, 1.0)
    rng = np.random.default_rng(7)
    vec = v0 + 0.08 * rng.normal(size=v0.shape)
    wf = FullVector.for_sector(N, vec.astype(np.float32))
    params = wf.init(jax.random.key(0))
    res = lanczos.exact_lanczos(wf, params, ham, N)
    # Strict variational ordering, and a real improvement on this state.
    assert res.energy <= res.e0 - 1e-6
    assert res.energy >= e_exact - 1e-6
    assert res.variance_alpha < res.variance0
    # Dense cross-check of the optimal-alpha energy.
    psi_a = vec + res.alpha * (h_dense @ vec)
    want = float(psi_a @ h_dense @ psi_a / (psi_a @ psi_a))
    np.testing.assert_allclose(res.energy, want, rtol=5e-4)
    # The extrapolated estimate sits at or below the step energy (toward
    # the exact value from above).
    assert e_exact - 5e-3 <= res.extrapolated <= res.energy + 1e-9


def test_eigenstate_is_a_fixed_point():
    ham, _ = _dense_setup()
    e_exact, v0 = ed.ground_state(N, lattice.chain_bonds(N), -1.0, 1.0)
    wf = FullVector.for_sector(N, v0.astype(np.float32))
    params = wf.init(jax.random.key(0))
    res = lanczos.exact_lanczos(wf, params, ham, N)
    assert res.alpha == 0.0
    np.testing.assert_allclose(res.energy, e_exact, rtol=1e-5)
    assert abs(res.variance0) < 1e-3


def test_mc_evaluate_matches_exact():
    ham, _ = _dense_setup()
    e_exact, v0 = ed.ground_state(N, lattice.chain_bonds(N), -1.0, 1.0)
    rng = np.random.default_rng(11)
    vec = v0 + 0.1 * rng.normal(size=v0.shape)
    wf = FullVector.for_sector(N, vec.astype(np.float32))
    params = wf.init(jax.random.key(0))
    exact = lanczos.exact_lanczos(wf, params, ham, N)
    cfg = Config(num_sites=N, batch_size=256,
                 num_equilibration_sweeps=20, num_monte_carlo_sweeps=2,
                 num_evaluation_samples=64, seed=2)
    res = lanczos.evaluate_lanczos(wf, params, ham, cfg, sample_chunk=64)
    assert 0.0 < res.acceptance_rate <= 1.0
    # MC estimates agree with the deterministic moments within a few
    # jackknife sigma (and an absolute floor for tiny errors).
    assert abs(res.e0 - exact.e0) < max(5 * res.e0_err, 0.02)
    assert abs(res.energy - exact.energy) < max(5 * res.energy_err, 0.02)
    assert res.energy <= res.e0


@pytest.mark.slow
def test_trained_rbm_improves_on_chain():
    # End-to-end: a short SR-trained RBM's measured energy improves under
    # the Lanczos step and stays variational.
    from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
    cfg = Config(num_sites=N, wavefunction_type='rbm', num_fc_layers=0,
                 fc_layer_size=16, wavefunction_optimizer_type='SR',
                 batch_size=128, num_batches_per_epoch=2,
                 num_equilibration_sweeps=4, num_monte_carlo_sweeps=1,
                 learning_rates=[0.05], learning_rate_stops=[],
                 optimizer='gradient', heisenberg_jx=-1.0,
                 sr_solver='dense', sr_diag_shift=1e-2,
                 sr_delta_clip=1.0, seed=4)
    wf = build_wavefunction(cfg)
    ham = HeisenbergHamiltonian(lattice.chain_bonds(N), -1.0, 1.0)
    opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
    state = opt.init_state(jax.random.key(cfg.seed))
    epoch = jax.jit(opt.epoch)
    for _ in range(60):
        state, _ = epoch(state)
    e_exact, _ = ed.ground_state(N, lattice.chain_bonds(N), -1.0, 1.0)
    res = lanczos.exact_lanczos(wf, state.params, ham, N)
    assert res.energy <= res.e0
    assert res.energy >= e_exact - 1e-5
    # The step closes a real fraction of the remaining gap.
    gap0 = res.e0 - e_exact
    gap1 = res.energy - e_exact
    assert gap0 > 0
    assert gap1 < 0.8 * gap0


def test_energy_shift_invariance():
    # Moments of H - s give the same physics (same Krylov subspace):
    # reported e0/energy/extrapolated/variances must match the unshifted
    # run after the internal shift-back.
    ham, _ = _dense_setup()
    e_exact, v0 = ed.ground_state(N, lattice.chain_bonds(N), -1.0, 1.0)
    rng = np.random.default_rng(13)
    vec = v0 + 0.05 * rng.normal(size=v0.shape)
    wf = FullVector.for_sector(N, vec.astype(np.float32))
    params = wf.init(jax.random.key(0))
    a = lanczos.exact_lanczos(wf, params, ham, N)
    b = lanczos.exact_lanczos(wf, params, ham, N, energy_shift=a.e0)
    np.testing.assert_allclose(b.e0, a.e0, rtol=1e-5)
    np.testing.assert_allclose(b.energy, a.energy, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(b.variance0, a.variance0, rtol=1e-3)
    np.testing.assert_allclose(b.extrapolated, a.extrapolated,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.slow
def test_tfim_moments_and_step():
    # The evaluator is operator-generic (any LocalOperator): TFIM moments
    # over the FULL 2^N basis match the dense Pauli matrix, and the step
    # improves a perturbed critical-point ground state.
    from cgs_vmc_jax.ops.ising import TransverseFieldIsingHamiltonian
    n = 8
    bonds = lattice.chain_bonds(n)
    ham = TransverseFieldIsingHamiltonian(bonds, h_x=1.0, j_zz=1.0)
    h_dense = np.asarray(ed.ising_matrix(n, bonds, 1.0, 1.0, sparse=False))
    e_exact, v0 = np.linalg.eigh(h_dense)[0][0], None
    w, vs = np.linalg.eigh(h_dense)
    v0 = vs[:, 0]
    rng = np.random.default_rng(17)
    vec = v0 + 0.05 * rng.normal(size=v0.shape)
    full = basis.enumerate_full_basis(n)
    # FullVector indexes the Sz sector; use a dense lookup over the full
    # basis instead: a tiny wavefunction wrapping the vector directly.
    from cgs_vmc_jax.models.base import Wavefunction as WF
    from cgs_vmc_jax.ops.logamp import LogAmp as LA
    import jax.numpy as jnp

    class DenseVector(WF):
        name = 'dense_vector'
        def __init__(self, v):
            self.v = np.asarray(v, np.float32)
        def init(self, key):
            return {'v': jnp.asarray(self.v)}
        def apply(self, params, configs):
            bits = (configs > 0).astype(jnp.int32)
            idx = jnp.sum(bits * (2 ** jnp.arange(configs.shape[-1],
                                                  dtype=jnp.int32)), axis=-1)
            amp = params['v'][idx]
            return LA(jnp.sign(amp),
                      jnp.log(jnp.maximum(jnp.abs(amp), 1e-30)))

    wf = DenseVector(vec)
    params = wf.init(jax.random.key(0))
    res = lanczos.exact_lanczos(wf, params, ham, n, basis_states=full)
    want = _dense_moments(h_dense, vec)
    np.testing.assert_allclose(res.moments, want, rtol=3e-4)
    assert res.energy <= res.e0 - 1e-6
    assert res.energy >= w[0] - 1e-6
