"""Evaluator tests: MC operator estimates with binned errors, basis dumps."""

import numpy as np
import jax
import pytest

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.evaluate import (
    binned_error,
    evaluate_operator,
    evaluate_vector,
    overlap_with_vector,
)
from cgs_vmc_jax.models import FullVector
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.utils import ed

N = 8
BONDS = lattice.chain_bonds(N)
E0, V0 = ed.ground_state(N, BONDS)


def _exact_wf():
    wf = FullVector.for_sector(N, V0.astype(np.float32))
    return wf, wf.init(jax.random.key(0))


@pytest.mark.slow
def test_mc_energy_evaluation_matches_ed():
    wf, params = _exact_wf()
    config = Config(num_sites=N, batch_size=128,
                    num_equilibration_sweeps=20, num_monte_carlo_sweeps=2,
                    num_evaluation_samples=50)
    ham = HeisenbergHamiltonian(BONDS)
    result = evaluate_operator(wf, params, ham, config,
                               key=jax.random.key(9))
    # Exact wavefunction: zero-variance estimator, error ~ float noise.
    np.testing.assert_allclose(result.mean, E0, rtol=1e-4)
    assert result.error < 1e-3
    assert 0.0 < result.acceptance_rate < 1.0


def test_binned_error_iid():
    rng = np.random.RandomState(0)
    values = rng.randn(4096)
    mean, err = binned_error(values)
    # For iid samples the binned error matches the naive SEM.
    naive = values.std(ddof=1) / np.sqrt(len(values))
    assert abs(mean - values.mean()) < 1e-12
    assert naive <= err < 2.5 * naive


def test_binned_error_catches_autocorrelation():
    rng = np.random.RandomState(1)
    # AR(1) with strong autocorrelation: naive SEM underestimates badly.
    n, rho = 8192, 0.95
    noise = rng.randn(n)
    values = np.zeros(n)
    for i in range(1, n):
        values[i] = rho * values[i - 1] + noise[i]
    _, err = binned_error(values)
    naive = values.std(ddof=1) / np.sqrt(n)
    assert err > 3 * naive  # binning must inflate the error estimate


def test_evaluate_vector_and_overlap(tmp_path):
    wf, params = _exact_wf()
    config = Config(num_sites=N, batch_size=32)
    out_path = str(tmp_path / 'wavefunction_epoch_0.txt')
    psi = evaluate_vector(wf, params, config,
                          basis_array=basis.enumerate_sz_basis(N),
                          output_path=out_path)
    assert psi.shape == (V0.shape[0],)
    assert overlap_with_vector(psi, V0) > 0.999999
    # Reference-format file: one "(re,im)" line per basis state
    # (cgs_vmc/evaluation.py:240).
    lines = open(out_path).read().strip().split('\n')
    assert len(lines) == V0.shape[0]
    assert lines[0].startswith('(') and lines[0].endswith(')')


@pytest.mark.slow
def test_exact_expectation_matches_ed():
    from cgs_vmc_jax.evaluate import exact_expectation
    wf, params = _exact_wf()
    ham = HeisenbergHamiltonian(BONDS)
    value = exact_expectation(wf, params, ham, N, batch=16)
    np.testing.assert_allclose(value, E0, rtol=1e-5)


@pytest.mark.slow
def test_split_eval_matches_monolithic():
    """split_eval=True runs sweeps/estimator as separate small programs
    (the mode the headline artifact evals used); with the same seed it
    must reproduce the monolithic scan's estimate within MC agreement,
    and on an exact wavefunction both are zero-variance at E0."""
    wf, params = _exact_wf()
    config = Config(num_sites=N, batch_size=64,
                    num_equilibration_sweeps=10, num_monte_carlo_sweeps=1,
                    num_evaluation_samples=20)
    ham = HeisenbergHamiltonian(BONDS)
    mono = evaluate_operator(wf, params, ham, config,
                             key=jax.random.key(4))
    split = evaluate_operator(wf, params, ham,
                              config.replace(split_eval=True),
                              key=jax.random.key(4))
    np.testing.assert_allclose(split.mean, E0, rtol=1e-4)
    np.testing.assert_allclose(mono.mean, split.mean, rtol=1e-4)
    assert split.values.shape == (20,)
    assert 0.0 < split.acceptance_rate <= 1.0
