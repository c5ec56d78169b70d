"""Ansatz tests: registry coverage, shapes, algebra, and exactness oracles."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import (
    FullVector,
    WAVEFUNCTION_TYPES,
    build_wavefunction,
)
from cgs_vmc_jax.ops import logamp

N = 8
BATCH = 4


def _config(wf_type: str, **kwargs) -> Config:
    defaults = dict(
        num_sites=N, wavefunction_type=wf_type,
        num_fc_layers=2, fc_layer_size=10,
        num_conv_layers=2, num_conv_filters=4, kernel_size=3,
        num_resnet_blocks=1, bond_dimension=3,
        size_x=1, size_y=1,
    )
    defaults.update(kwargs)
    return Config(**defaults)


def _configs_batch(key=0):
    return basis.random_configurations(jax.random.key(key), N, BATCH)


ALL_TYPES = sorted(set(WAVEFUNCTION_TYPES) - {'ed_vector'})


@pytest.mark.parametrize('wf_type', ALL_TYPES)
def test_every_registered_ansatz_applies(wf_type):
    kwargs = {}
    if wf_type in ('conv_2d', 'res_net_2d', 'pixelcnn'):
        kwargs = dict(size_x=4, size_y=2)
    config = _config(wf_type, **kwargs)
    wf = build_wavefunction(config)
    params = wf.init(jax.random.key(0))
    amp = wf.apply(params, _configs_batch())
    assert amp.sign.shape == (BATCH,)
    assert amp.log.shape == (BATCH,)
    assert np.isfinite(np.asarray(amp.log)).all()
    assert set(np.unique(np.asarray(amp.sign))) <= {-1.0, 0.0, 1.0}


def test_ed_vector_ansatz():
    dim = basis.enumerate_sz_basis(N).shape[0]
    vec = np.random.RandomState(0).randn(dim).astype(np.float32)
    wf = FullVector.for_sector(N, vec)
    params = wf.init(jax.random.key(0))
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    amp = wf.apply(params, states)
    np.testing.assert_allclose(
        np.asarray(logamp.to_value(amp)), vec, rtol=1e-5, atol=1e-6)


def test_composite_sum_diff_prod():
    base = dict(
        composite_wavefunction_types=('fully_connected', 'rbm'),
        composite_output_activations=('exp', 'exp'),
    )
    configs = _configs_batch()
    for kind in ('sum', 'diff', 'prod'):
        wf = build_wavefunction(_config(kind, **base))
        params = wf.init(jax.random.key(1))
        amp_ab = wf.apply(params, configs)
        amp_a = wf._wf_a.apply(params['a'], configs)
        amp_b = wf._wf_b.apply(params['b'], configs)
        va = np.asarray(logamp.to_value(amp_a), np.float64)
        vb = np.asarray(logamp.to_value(amp_b), np.float64)
        expected = {'sum': va + vb, 'diff': va - vb, 'prod': va * vb}[kind]
        np.testing.assert_allclose(
            np.asarray(logamp.to_value(amp_ab)), expected, rtol=1e-4)


def test_scalar_multiply():
    wf = build_wavefunction(_config('fully_connected'))
    scaled = wf * (-2.0)
    params = scaled.init(jax.random.key(0))
    configs = _configs_batch()
    base_values = logamp.to_value(wf.apply(params, configs))
    scaled_values = logamp.to_value(scaled.apply(params, configs))
    np.testing.assert_allclose(
        np.asarray(scaled_values), -2.0 * np.asarray(base_values), rtol=1e-5)


def test_conv_periodic_translation_invariance():
    """Periodic conv ansatz log-amps are invariant under lattice translation."""
    config = _config('conv_1d')
    wf = build_wavefunction(config)
    params = wf.init(jax.random.key(0))
    configs = _configs_batch()
    rolled = jnp.roll(configs, shift=3, axis=1)
    amp = wf.apply(params, configs)
    amp_rolled = wf.apply(params, rolled)
    np.testing.assert_allclose(np.asarray(amp.log),
                               np.asarray(amp_rolled.log), rtol=1e-5)


def test_conv2d_periodic_translation_invariance():
    config = _config('conv_2d', size_x=4, size_y=2)
    wf = build_wavefunction(config)
    params = wf.init(jax.random.key(0))
    configs = _configs_batch()
    grid = configs.reshape(BATCH, 4, 2)
    rolled = jnp.roll(grid, shift=(1, 1), axis=(1, 2)).reshape(BATCH, N)
    amp = wf.apply(params, configs)
    amp_rolled = wf.apply(params, rolled)
    np.testing.assert_allclose(np.asarray(amp.log),
                               np.asarray(amp_rolled.log), rtol=1e-5)


def test_determinant_ansatz_matches_dense_det():
    """pbdg amplitude == det of the (up-rows, down-cols) submatrix."""
    from cgs_vmc_jax.models.determinant import ProjectedBDG
    wf = ProjectedBDG(N)
    params = wf.init(jax.random.key(0))
    configs = np.asarray(_configs_batch())
    amp = wf.apply(params, jnp.asarray(configs))
    pairing = np.asarray(params['pairing'], np.float64)
    for b in range(BATCH):
        ups = np.where(configs[b] > 0)[0]
        downs = np.where(configs[b] < 0)[0]
        expected = np.linalg.det(pairing[np.ix_(ups, downs)])
        got = float(amp.sign[b]) * np.exp(float(amp.log[b]))
        np.testing.assert_allclose(got, expected, rtol=1e-4)


def test_mps_matches_dense_contraction():
    from cgs_vmc_jax.models.mps import MatrixProductState
    wf = MatrixProductState(num_sites=N, bond_dimension=3)
    params = wf.init(jax.random.key(2))
    configs = np.asarray(_configs_batch())
    amp = wf.apply(params, jnp.asarray(configs))
    first = np.asarray(params['first'], np.float64)
    mid = np.asarray(params['mid'], np.float64)
    last = np.asarray(params['last'], np.float64)
    for b in range(BATCH):
        spins = ((configs[b] + 1) / 2).astype(int)
        vec = first[spins[0]]
        for t in range(N - 2):
            vec = vec @ mid[t, spins[t + 1]]
        expected = vec @ last[spins[-1]]
        got = float(amp.sign[b]) * np.exp(float(amp.log[b]))
        np.testing.assert_allclose(got, expected, rtol=1e-4)


def test_unknown_type_raises():
    with pytest.raises(ValueError, match='not registered'):
        build_wavefunction(_config('nope'))


def test_composite_mixed_output_activations():
    """Per-part output activations (reference composite_output_activations,
    cgs_vmc/wavefunctions.py:1178-1194): exp + cos sum carries signs."""
    config = _config('sum',
                     composite_wavefunction_types=('fully_connected', 'rbm'),
                     composite_output_activations=('cos', 'exp'))
    wf = build_wavefunction(config)
    assert wf._wf_a.output_activation == 'cos'
    params = wf.init(jax.random.key(3))
    configs = _configs_batch()
    amp = wf.apply(params, configs)
    va = logamp.to_value(wf._wf_a.apply(params['a'], configs))
    vb = logamp.to_value(wf._wf_b.apply(params['b'], configs))
    np.testing.assert_allclose(
        np.asarray(logamp.to_value(amp)),
        np.asarray(va, np.float64) + np.asarray(vb, np.float64), rtol=1e-4)


def test_conv_bfloat16_compute_path():
    """bf16 conv compute (f32 accumulate) stays close to the f32 path."""
    base = _config('conv_2d', size_x=4, size_y=2)
    wf32 = build_wavefunction(base)
    wf16 = build_wavefunction(base.replace(compute_dtype='bfloat16'))
    params = wf32.init(jax.random.key(7))
    configs = _configs_batch()
    log32 = np.asarray(wf32.apply(params, configs).log, np.float64)
    log16 = np.asarray(wf16.apply(params, configs).log, np.float64)
    np.testing.assert_allclose(log16, log32, atol=0.05)
    assert not np.allclose(log16, log32, atol=1e-9)  # genuinely bf16
