"""Functional NN layer primitives used by the wavefunction ansatzes.

Functional replacements for the reference's Sonnet layer modules
(cgs_vmc/layers.py): parameters are plain pytrees (nested dicts of arrays),
layers are pure apply functions, and periodic boundary conditions are
implemented with wrap padding feeding `lax.conv_general_dilated`, which XLA
hands to cuDNN on the GPU.
"""

from __future__ import annotations

import math
from typing import Sequence

import jax
import jax.numpy as jnp
from jax import lax


def _trunc_normal(key: jax.Array, shape: Sequence[int], stddev: float
                  ) -> jax.Array:
    return stddev * jax.random.truncated_normal(
        key, -2.0, 2.0, shape, dtype=jnp.float32)


# ----------------------------------------------------------------------
# Dense.
# ----------------------------------------------------------------------

def linear_init(key: jax.Array, in_dim: int, out_dim: int,
                scale: float = 1.0) -> dict:
    """Dense layer params; fan-in truncated-normal init (Sonnet's default
    for snt.Linear, which the reference relied on throughout).

    `scale` shrinks the init for log-amplitude OUTPUT heads: a log-domain
    wavefunction must start nearly flat (logψ ≈ const across configs) or
    the initial |ψ|² is already near-deterministic, Metropolis acceptance
    starts at zero and the chains freeze before training begins.  (The
    reference's raw-ψ networks had the same pathology hidden behind the
    exp-norm-shift machinery.)
    """
    w_key, _ = jax.random.split(key)
    stddev = scale / math.sqrt(max(in_dim, 1))
    return {
        'w': _trunc_normal(w_key, (in_dim, out_dim), stddev),
        'b': jnp.zeros((out_dim,), jnp.float32),
    }


def linear_apply(params: dict, x: jax.Array) -> jax.Array:
    return jnp.dot(x, params['w'],
                   preferred_element_type=jnp.float32) + params['b']


# ----------------------------------------------------------------------
# Periodic convolutions.
#
# Padding conventions copied from the reference behaviour:
#  * 1-D (cgs_vmc/layers.py:51-74): odd k -> (k-1)/2 both sides;
#    even k -> left k/2, right k/2-1.
#  # * 2-D (cgs_vmc/layers.py:117-148): odd k -> symmetric; even k ->
#    left/bottom k/2-1, right/top k/2 (note: mirrored vs 1-D).
# ----------------------------------------------------------------------

def _periodic_pad_1d(x: jax.Array, kernel: int) -> jax.Array:
    """x: [batch, width, channels]."""
    if kernel % 2 == 1:
        left = right = (kernel - 1) // 2
    else:
        left, right = kernel // 2, kernel // 2 - 1
    return jnp.concatenate(
        [x[:, x.shape[1] - left:, :], x, x[:, :right, :]], axis=1)


def _periodic_pad_2d(x: jax.Array, kernel: int) -> jax.Array:
    """x: [batch, height, width, channels]."""
    if kernel % 2 == 1:
        lo = hi = (kernel - 1) // 2
    else:
        lo, hi = kernel // 2 - 1, kernel // 2
    x = jnp.concatenate(
        [x[:, :, x.shape[2] - lo:, :], x, x[:, :, :hi, :]], axis=2)
    x = jnp.concatenate(
        [x[:, x.shape[1] - lo:, :, :], x, x[:, :hi, :, :]], axis=1)
    return x


def conv1d_init(key: jax.Array, in_channels: int, out_channels: int,
                kernel: int, scale: float = 1.0) -> dict:
    w_key, _ = jax.random.split(key)
    fan_in = in_channels * kernel
    stddev = scale / math.sqrt(max(fan_in, 1))
    return {
        'w': _trunc_normal(w_key, (kernel, in_channels, out_channels), stddev),
        'b': jnp.zeros((out_channels,), jnp.float32),
    }


def conv1d_periodic_apply(params: dict, x: jax.Array, stride: int = 1
                          ) -> jax.Array:
    """Periodic 1-D conv; x: [batch, width, in_ch] -> [batch, width, out_ch]."""
    kernel = params['w'].shape[0]
    padded = _periodic_pad_1d(x, kernel)
    # Output dtype follows the input dtype: the convolution still
    # accumulates in f32 internally, and forcing preferred_element_type=f32 on bf16
    # inputs makes the conv TRANSPOSE rule pair an f32 cotangent with the
    # bf16 kernel (dtype-mismatch error under grad) — one output rounding
    # per layer is the standard bf16 trade.
    out = lax.conv_general_dilated(
        padded, params['w'],
        window_strides=(stride,),
        padding='VALID',
        dimension_numbers=('NWC', 'WIO', 'NWC'),
        preferred_element_type=x.dtype,
    )
    return out + params['b']


def conv2d_init(key: jax.Array, in_channels: int, out_channels: int,
                kernel: int, scale: float = 1.0) -> dict:
    w_key, _ = jax.random.split(key)
    fan_in = in_channels * kernel * kernel
    stddev = scale / math.sqrt(max(fan_in, 1))
    return {
        'w': _trunc_normal(
            w_key, (kernel, kernel, in_channels, out_channels), stddev),
        'b': jnp.zeros((out_channels,), jnp.float32),
    }


def conv2d_periodic_apply(params: dict, x: jax.Array, stride: int = 1
                          ) -> jax.Array:
    """Periodic 2-D conv; x: [batch, h, w, in_ch] -> [batch, h, w, out_ch]."""
    kernel = params['w'].shape[0]
    padded = _periodic_pad_2d(x, kernel)
    # See conv1d_periodic_apply on the dtype choice (bf16 grad support).
    out = lax.conv_general_dilated(
        padded, params['w'],
        window_strides=(stride, stride),
        padding='VALID',
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        preferred_element_type=x.dtype,
    )
    return out + params['b']


# ----------------------------------------------------------------------
# Residual blocks (reference cgs_vmc/layers.py:163-361; batch-norm-free,
# selu between the two convs, identity shortcut).  The reference's
# BottleneckResBlock1d carried a latent crash (`_output_channels` never
# set, layers.py:348) — implemented correctly here: 1x1 reduce -> kxk ->
# 1x1 expand back to the block's channel count.
# ----------------------------------------------------------------------

def resblock1d_init(key: jax.Array, channels: int, kernel: int) -> dict:
    k1, k2 = jax.random.split(key)
    return {
        'conv1': conv1d_init(k1, channels, channels, kernel),
        'conv2': conv1d_init(k2, channels, channels, kernel),
    }


def resblock1d_apply(params: dict, x: jax.Array, stride: int = 1) -> jax.Array:
    """selu-activated two-conv residual block (reference layers.py:231-295).

    stride > 1 strides the FIRST conv and subsamples the identity shortcut
    to match (the reference passed its conv_stride to both convs but any
    stride != 1 crashed on the residual shape mismatch — here the knob
    actually works, ResNet-v1 style)."""
    h = conv1d_periodic_apply(params['conv1'], x, stride)
    h = jax.nn.selu(h)
    h = conv1d_periodic_apply(params['conv2'], h)
    shortcut = x if stride == 1 else x[:, ::stride, :]
    return h + shortcut


def resblock2d_init(key: jax.Array, channels: int, kernel: int) -> dict:
    k1, k2 = jax.random.split(key)
    return {
        'conv1': conv2d_init(k1, channels, channels, kernel),
        'conv2': conv2d_init(k2, channels, channels, kernel),
    }


def resblock2d_apply(params: dict, x: jax.Array, stride: int = 1) -> jax.Array:
    """2-D twin of `resblock1d_apply` (reference layers.py:163-228)."""
    h = conv2d_periodic_apply(params['conv1'], x, stride)
    h = jax.nn.selu(h)
    h = conv2d_periodic_apply(params['conv2'], h)
    shortcut = x if stride == 1 else x[:, ::stride, ::stride, :]
    return h + shortcut


def bottleneck1d_init(key: jax.Array, channels: int, kernel: int,
                      bottleneck_ratio: int = 2) -> dict:
    k1, k2, k3 = jax.random.split(key, 3)
    narrow = max(channels // bottleneck_ratio, 1)
    return {
        'reduce': conv1d_init(k1, channels, narrow, 1),
        'conv': conv1d_init(k2, narrow, narrow, kernel),
        'expand': conv1d_init(k3, narrow, channels, 1),
    }


def bottleneck1d_apply(params: dict, x: jax.Array, stride: int = 1
                       ) -> jax.Array:
    h = conv1d_periodic_apply(params['reduce'], x)
    h = jax.nn.relu(h)
    h = conv1d_periodic_apply(params['conv'], h, stride)
    h = jax.nn.relu(h)
    h = conv1d_periodic_apply(params['expand'], h)
    shortcut = x if stride == 1 else x[:, ::stride, :]
    return h + shortcut


def bottleneck2d_init(key: jax.Array, channels: int, kernel: int,
                      bottleneck_ratio: int = 2) -> dict:
    k1, k2, k3 = jax.random.split(key, 3)
    narrow = max(channels // bottleneck_ratio, 1)
    return {
        'reduce': conv2d_init(k1, channels, narrow, 1),
        'conv': conv2d_init(k2, narrow, narrow, kernel),
        'expand': conv2d_init(k3, narrow, channels, 1),
    }


def bottleneck2d_apply(params: dict, x: jax.Array, stride: int = 1
                       ) -> jax.Array:
    h = conv2d_periodic_apply(params['reduce'], x)
    h = jax.nn.relu(h)
    h = conv2d_periodic_apply(params['conv'], h, stride)
    h = jax.nn.relu(h)
    h = conv2d_periodic_apply(params['expand'], h)
    shortcut = x if stride == 1 else x[:, ::stride, ::stride, :]
    return h + shortcut


# ----------------------------------------------------------------------
# Graph convolution (reference cgs_vmc/layers.py:415-451): gather neighbour
# features by adjacency list, contract with a [num_neighbors, in, out]
# kernel shared across sites.
# ----------------------------------------------------------------------

def graph_conv_init(key: jax.Array, in_channels: int, out_channels: int,
                    num_neighbors: int, scale: float = 1.0) -> dict:
    w_key, _ = jax.random.split(key)
    fan_in = in_channels * num_neighbors
    stddev = scale / math.sqrt(max(fan_in, 1))
    return {
        'w': _trunc_normal(
            w_key, (num_neighbors, in_channels, out_channels), stddev),
        'b': jnp.zeros((out_channels,), jnp.float32),
    }


def graph_conv_apply(params: dict, x: jax.Array, adj: jax.Array) -> jax.Array:
    """x: [batch, n_sites, in_ch]; adj: [n_sites, num_neighbors] int."""
    gathered = x[:, adj, :]  # [batch, n_sites, num_neighbors, in_ch]
    out = jnp.einsum('bsnc,nco->bso', gathered, params['w'],
                     preferred_element_type=jnp.float32)
    return out + params['b']


def cast_params(params: dict, dtype) -> dict:
    """Casts a layer's params for reduced-precision compute (weights stay
    f32 in the train state; the cast happens at apply time so optimizer
    math and checkpoints remain full precision)."""
    if dtype == jnp.float32:
        return params
    return jax.tree.map(lambda x: x.astype(dtype), params)


def log_cosh(x: jax.Array) -> jax.Array:
    """Numerically stable log(cosh(x)) (RBM hidden-unit free energy)."""
    ax = jnp.abs(x)
    return ax + jnp.log1p(jnp.exp(-2.0 * ax)) - jnp.log(2.0)
