"""fast_jacobian oracle: batched-GEMM rows == vmap(grad) rows.

The fast path reformulates the conv forward as im2col GEMMs with
per-sample weight copies (optim/fast_jacobian.py); these tests pin it
to the generic `_jacobian_rows` bit-for-bit computation to f32
tolerance across the supported surface (base conv, symmetrized orbit,
spin flip, even kernels, chunk padding) and end-to-end through an SR
epoch.
"""

import numpy as np
import jax
import jax.flatten_util
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import basis
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.optim import fast_jacobian
from cgs_vmc_jax.optim.sr import StochasticReconfiguration, _jacobian_rows
from cgs_vmc_jax.train import build_hamiltonian


def _reference_rows(wf, params, configs, chunk):
    flat, unravel = jax.flatten_util.ravel_pytree(params)

    def single_log(p_flat, config):
        return wf.apply(unravel(p_flat), config[None, :]).log[0]

    return np.asarray(_jacobian_rows(single_log, flat, configs, chunk))


def _check(cfg, batch=24, chunk=0, seed=0, kink_frac=0.0):
    wf = build_wavefunction(cfg)
    params = wf.init(jax.random.key(seed))
    configs = basis.random_configurations(jax.random.key(seed + 1),
                                          cfg.num_sites, batch)
    fast = fast_jacobian.rows_fn_for(wf)
    assert fast is not None
    got = np.asarray(fast(params, configs, chunk))
    want = _reference_rows(wf, params, configs, chunk)
    assert got.shape == want.shape
    scale = np.abs(want).max() + 1e-12
    if kink_frac:
        # selu/relu derivative kinks (the ResNet blocks): f32 roundoff
        # between the conv lowering and the im2col GEMM can flip the
        # activation branch for pre-activations within eps of zero, so
        # O(1) relative differences on the touched entries are
        # legitimate subgradient disagreements, not bugs.  Require all
        # but a tiny fraction of entries to match, plus global L2
        # agreement.
        tol = 3e-5 * scale + 2e-4 * np.abs(want)
        frac = float((np.abs(got - want) > tol).mean())
        assert frac <= kink_frac, f'violating fraction {frac}'
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < 2e-3, f'global L2 rel diff {rel}'
    else:
        np.testing.assert_allclose(got, want, atol=3e-5 * scale, rtol=2e-4)


@pytest.mark.slow
def test_base_conv_rows_match():
    _check(Config(num_sites=16, size_x=4, size_y=4,
                  wavefunction_type='conv_2d', num_conv_layers=2,
                  num_conv_filters=8, kernel_size=3, symmetrize=False))


@pytest.mark.slow
def test_symmetrized_rows_match():
    # C4v x spin flip: the 16-element flagship orbit at 4x4.
    _check(Config(num_sites=16, size_x=4, size_y=4,
                  wavefunction_type='conv_2d', num_conv_layers=3,
                  num_conv_filters=8, kernel_size=3, symmetrize=True))


@pytest.mark.slow
def test_even_kernel_pad_asymmetry():
    # Even kernels pad asymmetrically (nn._periodic_pad_2d); the im2col
    # path reuses the same helper, so rows must still agree.
    _check(Config(num_sites=16, size_x=4, size_y=4,
                  wavefunction_type='conv_2d', num_conv_layers=2,
                  num_conv_filters=6, kernel_size=2, symmetrize=True))


@pytest.mark.slow
def test_rectangular_lattice_and_selu():
    _check(Config(num_sites=12, size_x=4, size_y=3,
                  wavefunction_type='conv_2d', num_conv_layers=2,
                  num_conv_filters=5, kernel_size=3, symmetrize=True,
                  nonlinearity='selu'))


def test_chunk_padding_path():
    # batch=20 with chunk=8 -> 3 chunks with 4 padded rows dropped.
    _check(Config(num_sites=16, size_x=4, size_y=4,
                  wavefunction_type='conv_2d', num_conv_layers=2,
                  num_conv_filters=8, kernel_size=3, symmetrize=True),
           batch=20, chunk=8)


def test_unsupported_returns_none():
    wf = build_wavefunction(Config(num_sites=8,
                                   wavefunction_type='fully_connected'))
    assert fast_jacobian.rows_fn_for(wf) is None
    wf = build_wavefunction(Config(
        num_sites=8, wavefunction_type='complex',
        composite_wavefunction_types=('fully_connected',
                                      'fully_connected')))
    assert fast_jacobian.rows_fn_for(wf) is None


@pytest.mark.parametrize('symmetrize,solver', [
    (False, 'dense'), (True, 'dense'), (True, 'sample_cg')])
@pytest.mark.slow
def test_sr_epoch_equivalent(symmetrize, solver):
    """One SR epoch with the fast path == with vmap(grad), for both the
    dense Cholesky solver and the sharded-Jacobian sample_cg solver."""
    base = dict(num_sites=16, size_x=4, size_y=4,
                wavefunction_type='conv_2d', num_conv_layers=2,
                num_conv_filters=6, kernel_size=3, symmetrize=symmetrize,
                wavefunction_optimizer_type='SR', batch_size=32,
                num_batches_per_epoch=2, num_equilibration_sweeps=2,
                num_monte_carlo_sweeps=1, optimizer='gradient',
                learning_rates=[0.02], learning_rate_stops=[],
                heisenberg_jx=-1.0, sr_solver=solver,
                sr_cg_tol=1e-9, sr_cg_maxiter=400,
                sr_diag_shift=1e-2, sr_delta_clip=1.0, seed=3)

    outs = []
    for fast in (True, False):
        cfg = Config(sr_fast_jacobian=fast, **base)
        wf = build_wavefunction(cfg)
        ham = build_hamiltonian(cfg)
        opt = StochasticReconfiguration(wf, ham, cfg)
        state = opt.init_state(jax.random.key(cfg.seed))
        state, metrics = jax.jit(opt.epoch)(state)
        outs.append((jax.flatten_util.ravel_pytree(state.params)[0],
                     metrics['energy']))
    np.testing.assert_allclose(np.asarray(outs[0][0]),
                               np.asarray(outs[1][0]),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(float(outs[0][1]), float(outs[1][1]),
                               rtol=1e-5)


@pytest.mark.slow
def test_deep_seven_layer_rows_match():
    # The 12x12 deep recipe's shape class (7 conv layers, symmetrized,
    # sample_cg) at test size: rows must match vmap(grad) and the chunked
    # path must agree with the unchunked one.
    cfg = Config(num_sites=16, size_x=4, size_y=4,
                 wavefunction_type='conv_2d', num_conv_layers=7,
                 num_conv_filters=6, kernel_size=3, symmetrize=True)
    _check(cfg, batch=20, chunk=8)
    _check(cfg, batch=20, chunk=0)


@pytest.mark.slow
def test_pixelcnn_rows_match():
    # Masked-conv autoregressive family: zero-pad im2col + the
    # sector-projected chain-rule head.
    cfg = Config(num_sites=16, size_x=4, size_y=4,
                 wavefunction_type='pixelcnn', num_conv_layers=3,
                 num_conv_filters=6, kernel_size=3)
    _check(cfg, batch=24, chunk=0)
    _check(cfg, batch=20, chunk=8)


@pytest.mark.slow
def test_pixelcnn_sr_epoch_equivalent():
    """One dense-SR epoch on the AR ansatz: fast rows == vmap(grad)."""
    base = dict(num_sites=16, size_x=4, size_y=4,
                wavefunction_type='pixelcnn', num_conv_layers=2,
                num_conv_filters=6, kernel_size=3,
                wavefunction_optimizer_type='SR', batch_size=32,
                num_batches_per_epoch=2, num_equilibration_sweeps=1,
                num_monte_carlo_sweeps=1, optimizer='gradient',
                learning_rates=[0.02], learning_rate_stops=[],
                heisenberg_jx=-1.0, sr_solver='dense',
                sr_diag_shift=1e-2, sr_delta_clip=1.0, seed=3)
    outs = []
    for fast in (True, False):
        cfg = Config(sr_fast_jacobian=fast, **base)
        wf = build_wavefunction(cfg)
        ham = build_hamiltonian(cfg)
        opt = StochasticReconfiguration(wf, ham, cfg)
        state = opt.init_state(jax.random.key(cfg.seed))
        state, metrics = jax.jit(opt.epoch)(state)
        outs.append((jax.flatten_util.ravel_pytree(state.params)[0],
                     metrics['energy']))
    np.testing.assert_allclose(np.asarray(outs[0][0]),
                               np.asarray(outs[1][0]),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(float(outs[0][1]), float(outs[1][1]),
                               rtol=1e-5)


@pytest.mark.slow
def test_conv1d_rows_match():
    _check(Config(num_sites=12, wavefunction_type='conv_1d',
                  num_conv_layers=3, num_conv_filters=6, kernel_size=3))


def test_conv1d_even_kernel_rows_match():
    # 1-D even kernels pad left k/2, right k/2-1 (MIRRORED vs 2-D);
    # _patches_1d reuses nn._periodic_pad_1d so rows must agree.
    _check(Config(num_sites=12, wavefunction_type='conv_1d',
                  num_conv_layers=2, num_conv_filters=5, kernel_size=4),
           batch=20, chunk=8)


@pytest.mark.slow
def test_resnet1d_rows_match():
    _check(Config(num_sites=12, wavefunction_type='res_net_1d',
                  num_resnet_blocks=2, num_conv_filters=6, kernel_size=3),
           kink_frac=0.005)


@pytest.mark.slow
def test_resnet1d_bottleneck_rows_match():
    _check(Config(num_sites=12, wavefunction_type='res_net_1d',
                  num_resnet_blocks=2, num_conv_filters=6, kernel_size=3,
                  resnet_bottleneck=True), kink_frac=0.005)


def test_resnet2d_symmetrized_rows_match():
    _check(Config(num_sites=16, size_x=4, size_y=4,
                  wavefunction_type='res_net_2d', num_resnet_blocks=2,
                  num_conv_filters=6, kernel_size=3, symmetrize=True),
           batch=20, chunk=8, kink_frac=0.005)


@pytest.mark.slow
def test_resnet2d_bottleneck_rows_match():
    _check(Config(num_sites=16, size_x=4, size_y=4,
                  wavefunction_type='res_net_2d', num_resnet_blocks=2,
                  num_conv_filters=8, kernel_size=3,
                  resnet_bottleneck=True), kink_frac=0.005)


def test_strided_resnet_falls_back():
    # Strided shortcuts change the spatial shape mid-stack; the im2col
    # path only supports stride 1 and must defer to vmap(grad).
    wf = build_wavefunction(Config(
        num_sites=16, size_x=4, size_y=4, wavefunction_type='res_net_2d',
        num_resnet_blocks=1, num_conv_filters=4, kernel_size=3,
        conv_strides=2))
    assert fast_jacobian.rows_fn_for(wf) is None
