"""2-D masked-convolution autoregressive ansatz (PixelCNN-style).

The MADE ansatz (models/autoregressive.py) is permutation-blind; on 2-D
lattices the natural conditional model is a stack of CAUSALLY MASKED
convolutions in raster order — translation-adjacent weight sharing with
the same exact properties: |psi|^2 exactly normalized on the Sz=0
sector, i.i.d. ancestral sampling, one parallel forward for evaluation.

Raster order matches the framework's site convention site = x*size_y + y
(models/conv.py reshape): "past" means (x' < x) or (x' == x, y' < y).  A
kernel tap at offset (dx, dy) is allowed iff it points to the past;
the first layer additionally masks the center tap (mask 'A': logit_i
must exclude s_i itself), later layers may use the center FEATURE
(mask 'B': that feature already excludes the site's own spin).  Padding
is zero (causal) — periodic wrap would leak future sites, so this
ansatz is intentionally not periodic; translation symmetry, if wanted,
comes from the physics being learned, not the architecture.

The known PixelCNN blind spot (taps strictly above-left) only shrinks
the visible context; it cannot violate causality, so all exactness
guarantees (normalization, i.i.d. draws) are unaffected.

Everything except the logits network — sector-projected conditionals,
apply, ancestral sample, the exact-draw sampler registry entry — is
inherited from AutoregressiveSpinModel.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

from cgs_vmc_jax.models.autoregressive import AutoregressiveSpinModel
from cgs_vmc_jax.models.base import Params, register
from cgs_vmc_jax.ops import logamp


def _causal_mask(kernel: int, c_in: int, c_out: int,
                 include_center: bool) -> np.ndarray:
    """[k, k, c_in, c_out] 0/1 mask; tap (dx, dy) allowed iff it reads a
    raster-past site (dx<0, or dx==0 and dy<0), plus the center for
    mask 'B'."""
    half = kernel // 2
    mask = np.zeros((kernel, kernel, 1, 1), np.float32)
    for kx in range(kernel):
        for ky in range(kernel):
            dx, dy = kx - half, ky - half
            past = (dx < 0) or (dx == 0 and dy < 0)
            if past or (include_center and dx == 0 and dy == 0):
                mask[kx, ky] = 1.0
    return np.broadcast_to(mask, (kernel, kernel, c_in, c_out)).copy()


@register('pixelcnn')
class MaskedConv2DAutoregressive(AutoregressiveSpinModel):
    """Causal masked-conv conditionals over a size_x × size_y lattice."""

    def __init__(self, size_x: int, size_y: int, num_layers: int = 3,
                 num_filters: int = 16, kernel_size: int = 3,
                 nonlinearity: str = 'relu', name: str = 'pixelcnn'):
        num_sites = size_x * size_y
        if num_sites % 2:
            raise ValueError('Sz=0 sector requires even num_sites')
        if kernel_size % 2 == 0:
            raise ValueError('causal masking needs an odd kernel')
        self.name = name
        self.num_sites = num_sites
        self.size_x = size_x
        self.size_y = size_y
        self.num_layers = max(1, num_layers)
        self.num_filters = num_filters
        self.kernel_size = kernel_size
        self.nonlinearity = nonlinearity
        # Host numpy masks (lowered as constants, see models/symmetry.py).
        f = num_filters
        self.masks = [_causal_mask(kernel_size, 1, f, False)]
        for _ in range(self.num_layers - 1):
            self.masks.append(_causal_mask(kernel_size, f, f, True))
        self.masks.append(_causal_mask(1, f, 1, True))  # 1x1 head

    def init(self, key: jax.Array) -> Params:
        keys = jax.random.split(key, len(self.masks))
        params = {}
        for i, mask in enumerate(self.masks):
            fan_in = max(float(mask[..., 0].sum()), 1.0)
            w = jax.random.normal(keys[i], mask.shape, jnp.float32)
            params[f'conv_{i}'] = {
                'w': w / jnp.sqrt(fan_in),
                'b': jnp.zeros((mask.shape[-1],), jnp.float32),
            }
        return params

    def _logits(self, params: Params, configs: jax.Array) -> jax.Array:
        act = logamp.ACTIVATIONS[self.nonlinearity]
        h = configs.astype(jnp.float32).reshape(
            -1, self.size_x, self.size_y, 1)
        last = len(self.masks) - 1
        for i, mask in enumerate(self.masks):
            layer = params[f'conv_{i}']
            h = lax.conv_general_dilated(
                h, layer['w'] * mask, window_strides=(1, 1),
                padding='SAME',       # zero padding: causal, NOT periodic
                dimension_numbers=('NHWC', 'HWIO', 'NHWC'))
            h = h + layer['b']
            if i != last:
                h = act(h)
        return h.reshape(-1, self.num_sites)

    @classmethod
    def from_config(cls, config, name: str = ''
                    ) -> 'MaskedConv2DAutoregressive':
        if config.size_x <= 1 or config.size_y <= 1 or (
                config.size_x * config.size_y != config.num_sites):
            raise ValueError('pixelcnn requires a 2-D lattice with '
                             'size_x*size_y == num_sites')
        kwargs = dict(
            size_x=config.size_x, size_y=config.size_y,
            num_layers=config.num_conv_layers,
            num_filters=config.num_conv_filters,
            kernel_size=config.kernel_size,
            nonlinearity=config.nonlinearity,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
