"""Symmetry-projection tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import basis
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.models.symmetry import (
    SymmetrizedWavefunction,
    square_point_group,
)
from cgs_vmc_jax.ops import logamp


def test_square_point_group_is_a_group():
    perms = square_point_group(4, 4)
    assert perms.shape == (8, 16)
    rows = {tuple(p) for p in perms}
    # Closed under composition: p∘q must be in the set.
    for p in perms:
        for q in perms:
            assert tuple(p[q]) in rows
        assert sorted(p.tolist()) == list(range(16))  # valid permutation


def test_rectangular_group():
    perms = square_point_group(4, 2)
    assert perms.shape[0] == 4
    for p in perms:
        assert sorted(p.tolist()) == list(range(8))


def _symmetrized(spin_flip):
    config = Config(num_sites=16, size_x=4, size_y=4,
                    wavefunction_type='conv_2d', num_conv_layers=2,
                    num_conv_filters=4, kernel_size=3)
    inner = build_wavefunction(config)
    perms = square_point_group(4, 4)
    wf = SymmetrizedWavefunction(inner, perms, spin_flip=spin_flip)
    return inner, wf, perms


def test_projection_is_invariant():
    """ψ_sym(g·R) == ψ_sym(R) for every g in the group."""
    inner, wf, perms = _symmetrized(spin_flip=True)
    params = wf.init(jax.random.key(0))
    configs = basis.random_configurations(jax.random.key(1), 16, 8)
    base = wf.apply(params, configs)
    for g in range(perms.shape[0]):
        transformed = configs[:, perms[g]]
        amp = wf.apply(params, transformed)
        np.testing.assert_allclose(np.asarray(amp.log),
                                   np.asarray(base.log), rtol=1e-5)
    flipped = wf.apply(params, -configs)
    np.testing.assert_allclose(np.asarray(flipped.log),
                               np.asarray(base.log), rtol=1e-5)


def test_projection_matches_manual_average():
    inner, wf, perms = _symmetrized(spin_flip=False)
    params = wf.init(jax.random.key(2))
    configs = basis.random_configurations(jax.random.key(3), 16, 4)
    amp = wf.apply(params, configs)
    values = []
    for g in range(perms.shape[0]):
        inner_amp = inner.apply(params, configs[:, perms[g]])
        values.append(np.asarray(logamp.to_value(inner_amp), np.float64))
    expected = np.mean(values, axis=0)
    np.testing.assert_allclose(np.asarray(logamp.to_value(amp)), expected,
                               rtol=1e-4)


def test_build_wavefunction_symmetrize_flag():
    config = Config(num_sites=16, size_x=4, size_y=4,
                    wavefunction_type='conv_2d', num_conv_layers=2,
                    num_conv_filters=4, kernel_size=3, symmetrize=True)
    wf = build_wavefunction(config)
    assert isinstance(wf, SymmetrizedWavefunction)
    params = wf.init(jax.random.key(0))
    configs = basis.random_configurations(jax.random.key(1), 16, 4)
    amp = wf.apply(params, configs)
    assert np.isfinite(np.asarray(amp.log)).all()


def test_symmetrize_requires_2d():
    config = Config(num_sites=8, wavefunction_type='rbm', symmetrize=True)
    with pytest.raises(ValueError, match='2-D lattice'):
        build_wavefunction(config)


def test_composite_symmetrize_and_default_activation():
    """symmetrize=True applies to 'sum'/'prod' composites too, and unset
    composite activations default to 'exp' instead of a KeyError
    (round-1 ADVICE)."""
    config = Config(num_sites=16, size_x=4, size_y=4,
                    wavefunction_type='prod',
                    composite_wavefunction_types=('conv_2d', 'conv_2d'),
                    num_conv_layers=1, num_conv_filters=2, kernel_size=3,
                    symmetrize=True)
    wf = build_wavefunction(config)
    assert isinstance(wf, SymmetrizedWavefunction)
    params = wf.init(jax.random.key(0))
    configs = basis.random_configurations(jax.random.key(1), 16, 4)
    amp = wf.apply(params, configs)
    assert np.isfinite(np.asarray(amp.log)).all()
