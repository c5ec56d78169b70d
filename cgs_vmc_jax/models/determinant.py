"""Determinant-based ansatzes: projected BDG pairing and neural-net backflow.

Log-domain re-designs of ProjectedBDG (cgs_vmc/wavefunctions.py:876-928) and
FullyConnectedNNB (cgs_vmc/wavefunctions.py:931-998).  The reference
extracted the (up-row, down-column) pairing submatrix with a boolean mask +
reshape; here the same submatrix is built with static-shape sorted gathers
(XLA-friendly), and both ansatzes use slogdet so the amplitude is natively
(sign, log) — the reference's raw `tf.linalg.det` in NNB overflowed by
construction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cgs_vmc_jax.models import nn
from cgs_vmc_jax.models.base import Params, Wavefunction, register
from cgs_vmc_jax.ops.logamp import ACTIVATIONS, LogAmp


def pairing_submatrix(pairing: jax.Array, configs: jax.Array) -> jax.Array:
    """Selects rows at up-spin sites and columns at down-spin sites.

    pairing: [batch, n, n] (or broadcastable), configs: [batch, n] ±1 with
    exactly n/2 up spins.  Row/column order is ascending site index, matching
    the reference's boolean_mask+reshape semantics
    (cgs_vmc/wavefunctions.py:906-910).
    """
    n = configs.shape[-1]
    half = n // 2
    # Stable argsort: up (+1) sites first in ascending order.
    up_idx = jnp.argsort(-configs, axis=-1, stable=True)[:, :half]
    down_idx = jnp.argsort(configs, axis=-1, stable=True)[:, :half]
    rows = jnp.take_along_axis(pairing, up_idx[:, :, None], axis=1)
    sub = jnp.take_along_axis(rows, down_idx[:, None, :], axis=2)
    return sub  # [batch, n/2, n/2]


@register('pbdg')
class ProjectedBDG(Wavefunction):
    """Pairing wavefunction: trainable [n, n] pairing matrix, amplitude =
    det of the (up, down) submatrix."""

    def __init__(self, num_sites: int, name: str = 'projected_bdg'):
        if num_sites % 2:
            raise ValueError('ProjectedBDG requires an even number of sites.')
        self.name = name
        self.num_sites = num_sites

    def init(self, key: jax.Array) -> Params:
        n = self.num_sites
        # Glorot-uniform (the reference used tf.get_variable's default).
        limit = jnp.sqrt(6.0 / (n + n))
        return {'pairing': jax.random.uniform(
            key, (n, n), jnp.float32, -limit, limit)}

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        batch = configs.shape[0]
        pairing = jnp.broadcast_to(
            params['pairing'], (batch,) + params['pairing'].shape)
        sub = pairing_submatrix(pairing, configs)
        sign, logdet = jnp.linalg.slogdet(sub)
        return LogAmp(sign, logdet)

    @classmethod
    def from_config(cls, config, name: str = '') -> 'ProjectedBDG':
        kwargs = dict(num_sites=config.num_sites)
        if name:
            kwargs['name'] = name
        return cls(**kwargs)


@register('fully_connected_nnb')
class FullyConnectedNNB(Wavefunction):
    """Neural-net backflow: an MLP emits a configuration-dependent [n, n]
    pairing matrix; amplitude = det of its (up, down) submatrix."""

    def __init__(self, num_sites: int, num_layers: int, layer_size: int,
                 nonlinearity: str = 'relu', name: str = 'fully_connected_nnb'):
        if num_sites % 2:
            raise ValueError('NNB requires an even number of sites.')
        self.name = name
        self.num_sites = num_sites
        self.num_layers = num_layers
        self.layer_size = layer_size
        self.nonlinearity = nonlinearity

    def init(self, key: jax.Array) -> Params:
        keys = jax.random.split(key, self.num_layers + 1)
        params = {}
        in_dim = self.num_sites
        for i in range(self.num_layers):
            params[f'dense_{i}'] = nn.linear_init(keys[i], in_dim,
                                                  self.layer_size)
            in_dim = self.layer_size
        params['pairing_head'] = nn.linear_init(
            keys[-1], in_dim, self.num_sites * self.num_sites)
        return params

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        act = ACTIVATIONS[self.nonlinearity]
        h = configs
        for i in range(self.num_layers):
            h = act(nn.linear_apply(params[f'dense_{i}'], h))
        pairing = nn.linear_apply(params['pairing_head'], h)
        pairing = pairing.reshape(-1, self.num_sites, self.num_sites)
        sub = pairing_submatrix(pairing, configs)
        sign, logdet = jnp.linalg.slogdet(sub)
        return LogAmp(sign, logdet)

    @classmethod
    def from_config(cls, config, name: str = '') -> 'FullyConnectedNNB':
        kwargs = dict(
            num_sites=config.num_sites,
            num_layers=config.num_fc_layers,
            layer_size=config.fc_layer_size,
            nonlinearity=config.nonlinearity,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
