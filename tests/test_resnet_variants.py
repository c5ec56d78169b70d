"""Coverage for ResNet bottleneck variants and stride plumbing."""

import numpy as np
import jax

from cgs_vmc_jax import basis
from cgs_vmc_jax.models.conv import ResNet1D, ResNet2D

N = 8


def test_bottleneck_resnet1d():
    """The reference's BottleneckResBlock1d crashed when used
    (cgs_vmc/layers.py:348 reads an attribute that is never set); ours
    must run and produce finite signed-log amplitudes."""
    wf = ResNet1D(num_blocks=2, num_filters=4, kernel_size=3,
                  bottleneck=True)
    params = wf.init(jax.random.key(0))
    configs = basis.random_configurations(jax.random.key(1), N, 4)
    amp = wf.apply(params, configs)
    assert np.isfinite(np.asarray(amp.log)).all()
    # Bottleneck params have the reduce/conv/expand structure.
    assert set(params['block_0']) == {'reduce', 'conv', 'expand'}


def test_bottleneck_resnet2d():
    wf = ResNet2D(num_blocks=2, num_filters=4, kernel_size=3,
                  size_x=4, size_y=2, bottleneck=True)
    params = wf.init(jax.random.key(2))
    configs = basis.random_configurations(jax.random.key(3), N, 4)
    amp = wf.apply(params, configs)
    assert np.isfinite(np.asarray(amp.log)).all()


def test_resnet_config_knobs_reachable():
    """conv_strides and resnet_bottleneck must be live from Config — round-1
    review found them plumbed into __init__ but dead in apply."""
    from cgs_vmc_jax.config import Config
    from cgs_vmc_jax.models import build_wavefunction
    cfg = Config(num_sites=N, wavefunction_type='res_net_1d',
                 num_resnet_blocks=2, num_conv_filters=4, kernel_size=3,
                 conv_strides=2, resnet_bottleneck=True)
    wf = build_wavefunction(cfg)
    assert wf.bottleneck and wf.conv_stride == 2
    params = wf.init(jax.random.key(6))
    configs = basis.random_configurations(jax.random.key(7), N, 4)
    amp = wf.apply(params, configs)
    assert np.isfinite(np.asarray(amp.log)).all()


def test_resnet2d_stride_shrinks_lattice():
    """stride=2 halves each spatial dim per block (strided shortcut)."""
    wf = ResNet2D(num_blocks=1, num_filters=4, kernel_size=3,
                  size_x=4, size_y=4, conv_stride=2)
    params = wf.init(jax.random.key(8))
    configs = basis.random_configurations(jax.random.key(9), 16, 4)
    amp = wf.apply(params, configs)
    assert amp.log.shape == (4,)
    assert np.isfinite(np.asarray(amp.log)).all()


def test_resnet_nonexp_activation():
    """Signed output activations flow through the residual stack."""
    wf = ResNet1D(num_blocks=1, num_filters=4, kernel_size=3,
                  output_activation='cos')
    params = wf.init(jax.random.key(4))
    configs = basis.random_configurations(jax.random.key(5), N, 8)
    amp = wf.apply(params, configs)
    signs = set(np.unique(np.asarray(amp.sign)))
    assert signs <= {-1.0, 0.0, 1.0}
    assert np.isfinite(np.asarray(amp.log)).all()
