"""Convolutional and residual wavefunction ansatzes (1-D and 2-D, PBC).

Log-domain re-designs of Conv1DNetwork / Conv2DNetwork
(cgs_vmc/wavefunctions.py:454-615) and ResNet1D / ResNet2D
(cgs_vmc/wavefunctions.py:617-809).  Translation-invariant periodic convs
feed a site+channel reduce-sum; with 'exp' output activation that sum IS
log(psi).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cgs_vmc_jax.models import nn
from cgs_vmc_jax.models.base import Params, Wavefunction, register
from cgs_vmc_jax.ops import logamp
from cgs_vmc_jax.ops.logamp import LogAmp


@register('conv_1d')
class Conv1DNetwork(Wavefunction):
    """Stacked periodic 1-D convolutions; last layer linear (no nonlin),
    reduce-sum over sites and channels (reference wavefunctions.py:483-493)."""

    def __init__(self, num_layers: int, num_filters: int, kernel_size: int,
                 nonlinearity: str = 'relu', output_activation: str = 'exp',
                 compute_dtype: str = 'float32',
                 name: str = 'conv_1d_network'):
        self.name = name
        self.num_layers = num_layers
        self.num_filters = num_filters
        self.kernel_size = kernel_size
        self.nonlinearity = nonlinearity
        self.output_activation = output_activation
        self.compute_dtype = jnp.dtype(compute_dtype)

    def init(self, key: jax.Array) -> Params:
        keys = jax.random.split(key, self.num_layers)
        params = {}
        in_ch = 1
        head_scale = 0.1 if self.output_activation == 'exp' else 1.0
        for i in range(self.num_layers):
            scale = head_scale if i + 1 == self.num_layers else 1.0
            params[f'conv_{i}'] = nn.conv1d_init(
                keys[i], in_ch, self.num_filters, self.kernel_size,
                scale=scale)
            in_ch = self.num_filters
        return params

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        act = logamp.ACTIVATIONS[self.nonlinearity]
        # Convs run in compute_dtype (bf16 doubles the tensor-core rate)
        # with f32 accumulation inside the conv and f32 reduction.
        h = configs[..., None].astype(self.compute_dtype)
        for i in range(self.num_layers):
            layer = nn.cast_params(params[f'conv_{i}'], self.compute_dtype)
            h = nn.conv1d_periodic_apply(layer, h)
            if i + 1 != self.num_layers:
                h = act(h).astype(self.compute_dtype)
        pre = jnp.sum(h.astype(jnp.float32), axis=(1, 2))
        return logamp.apply_activation(pre, self.output_activation)

    @classmethod
    def from_config(cls, config, name: str = '') -> 'Conv1DNetwork':
        kwargs = dict(
            num_layers=config.num_conv_layers,
            num_filters=config.num_conv_filters,
            kernel_size=config.kernel_size,
            nonlinearity=config.nonlinearity,
            output_activation=config.output_activation,
            compute_dtype=config.compute_dtype,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)


@register('conv_2d')
class Conv2DNetwork(Wavefunction):
    """2-D periodic conv stack over the size_x × size_y torus
    (reference wavefunctions.py:531-615)."""

    def __init__(self, num_layers: int, num_filters: int, kernel_size: int,
                 size_x: int, size_y: int, nonlinearity: str = 'relu',
                 output_activation: str = 'exp',
                 compute_dtype: str = 'float32',
                 name: str = 'conv_2d_network'):
        self.name = name
        self.num_layers = num_layers
        self.num_filters = num_filters
        self.kernel_size = kernel_size
        self.size_x = size_x
        self.size_y = size_y
        self.nonlinearity = nonlinearity
        self.output_activation = output_activation
        self.compute_dtype = jnp.dtype(compute_dtype)

    def init(self, key: jax.Array) -> Params:
        keys = jax.random.split(key, self.num_layers)
        params = {}
        in_ch = 1
        head_scale = 0.1 if self.output_activation == 'exp' else 1.0
        for i in range(self.num_layers):
            scale = head_scale if i + 1 == self.num_layers else 1.0
            params[f'conv_{i}'] = nn.conv2d_init(
                keys[i], in_ch, self.num_filters, self.kernel_size,
                scale=scale)
            in_ch = self.num_filters
        return params

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        act = logamp.ACTIVATIONS[self.nonlinearity]
        h = configs.reshape(-1, self.size_x, self.size_y, 1)
        h = h.astype(self.compute_dtype)
        for i in range(self.num_layers):
            layer = nn.cast_params(params[f'conv_{i}'], self.compute_dtype)
            h = nn.conv2d_periodic_apply(layer, h)
            if i + 1 != self.num_layers:
                h = act(h).astype(self.compute_dtype)
        pre = jnp.sum(h.astype(jnp.float32), axis=(1, 2, 3))
        return logamp.apply_activation(pre, self.output_activation)

    @classmethod
    def from_config(cls, config, name: str = '') -> 'Conv2DNetwork':
        kwargs = dict(
            num_layers=config.num_conv_layers,
            num_filters=config.num_conv_filters,
            kernel_size=config.kernel_size,
            size_x=config.size_x,
            size_y=config.size_y,
            nonlinearity=config.nonlinearity,
            output_activation=config.output_activation,
            compute_dtype=config.compute_dtype,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)


@register('res_net_1d')
class ResNet1D(Wavefunction):
    """Initial periodic conv + N residual (or bottleneck) blocks
    (reference wavefunctions.py:617-707; blocks from layers.py:231-361)."""

    def __init__(self, num_blocks: int, num_filters: int, kernel_size: int,
                 conv_stride: int = 1, bottleneck: bool = False,
                 output_activation: str = 'exp', name: str = 'res_net_1d'):
        self.name = name
        self.num_blocks = num_blocks
        self.num_filters = num_filters
        self.kernel_size = kernel_size
        self.conv_stride = conv_stride
        self.bottleneck = bottleneck
        self.output_activation = output_activation

    def init(self, key: jax.Array) -> Params:
        keys = jax.random.split(key, self.num_blocks + 1)
        stem_scale = 0.1 if self.output_activation == 'exp' else 1.0
        params = {'stem': nn.conv1d_init(
            keys[0], 1, self.num_filters, self.kernel_size,
            scale=stem_scale)}
        block_init = (nn.bottleneck1d_init if self.bottleneck
                      else nn.resblock1d_init)
        for i in range(self.num_blocks):
            params[f'block_{i}'] = block_init(
                keys[i + 1], self.num_filters, self.kernel_size)
        return params

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        h = nn.conv1d_periodic_apply(params['stem'], configs[..., None])
        block_apply = (nn.bottleneck1d_apply if self.bottleneck
                       else nn.resblock1d_apply)
        for i in range(self.num_blocks):
            h = block_apply(params[f'block_{i}'], h, self.conv_stride)
        pre = jnp.sum(h, axis=(1, 2))
        return logamp.apply_activation(pre, self.output_activation)

    @classmethod
    def from_config(cls, config, name: str = '') -> 'ResNet1D':
        kwargs = dict(
            num_blocks=config.num_resnet_blocks,
            num_filters=config.num_conv_filters,
            kernel_size=config.kernel_size,
            conv_stride=config.conv_strides,
            bottleneck=config.resnet_bottleneck,
            output_activation=config.output_activation,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)


@register('res_net_2d')
class ResNet2D(Wavefunction):
    """2-D residual ansatz (reference wavefunctions.py:709-809)."""

    def __init__(self, num_blocks: int, num_filters: int, kernel_size: int,
                 size_x: int, size_y: int, conv_stride: int = 1,
                 bottleneck: bool = False, output_activation: str = 'exp',
                 name: str = 'res_net_2d'):
        self.name = name
        self.num_blocks = num_blocks
        self.num_filters = num_filters
        self.kernel_size = kernel_size
        self.size_x = size_x
        self.size_y = size_y
        self.conv_stride = conv_stride
        self.bottleneck = bottleneck
        self.output_activation = output_activation

    def init(self, key: jax.Array) -> Params:
        keys = jax.random.split(key, self.num_blocks + 1)
        stem_scale = 0.1 if self.output_activation == 'exp' else 1.0
        params = {'stem': nn.conv2d_init(
            keys[0], 1, self.num_filters, self.kernel_size,
            scale=stem_scale)}
        block_init = (nn.bottleneck2d_init if self.bottleneck
                      else nn.resblock2d_init)
        for i in range(self.num_blocks):
            params[f'block_{i}'] = block_init(
                keys[i + 1], self.num_filters, self.kernel_size)
        return params

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        h = configs.reshape(-1, self.size_x, self.size_y, 1)
        h = nn.conv2d_periodic_apply(params['stem'], h)
        block_apply = (nn.bottleneck2d_apply if self.bottleneck
                       else nn.resblock2d_apply)
        for i in range(self.num_blocks):
            h = block_apply(params[f'block_{i}'], h, self.conv_stride)
        pre = jnp.sum(h, axis=(1, 2, 3))
        return logamp.apply_activation(pre, self.output_activation)

    @classmethod
    def from_config(cls, config, name: str = '') -> 'ResNet2D':
        kwargs = dict(
            num_blocks=config.num_resnet_blocks,
            num_filters=config.num_conv_filters,
            kernel_size=config.kernel_size,
            conv_stride=config.conv_strides,
            bottleneck=config.resnet_bottleneck,
            size_x=config.size_x,
            size_y=config.size_y,
            output_activation=config.output_activation,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
