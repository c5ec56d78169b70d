"""Fully-connected and RBM wavefunction ansatzes.

Log-domain re-designs of the reference's FullyConnectedNetwork
(cgs_vmc/wavefunctions.py:328-388) and RestrictedBoltzmannNetwork
(cgs_vmc/wavefunctions.py:391-452).  With output activation 'exp' the
network's pre-activation IS log(psi) — no exponentiation ever happens,
which is what deletes the reference's overflow machinery.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cgs_vmc_jax.models import nn
from cgs_vmc_jax.models.base import Params, Wavefunction, register
from cgs_vmc_jax.ops import logamp
from cgs_vmc_jax.ops.logamp import LogAmp


@register('fully_connected')
class FullyConnectedNetwork(Wavefunction):
    """MLP ansatz: num_layers x (Linear + nonlinearity) -> Linear(1).

    output_activation 'exp': logpsi = final scalar, sign = +1.
    Other activations f: psi = f(final scalar), carried as (sign, log|.|).
    """

    def __init__(self, num_sites: int, num_layers: int, layer_size: int,
                 nonlinearity: str = 'relu', output_activation: str = 'exp',
                 name: str = 'fully_connected_network'):
        self.name = name
        self.num_sites = num_sites
        self.num_layers = num_layers
        self.layer_size = layer_size
        self.nonlinearity = nonlinearity
        self.output_activation = output_activation

    def init(self, key: jax.Array) -> Params:
        keys = jax.random.split(key, self.num_layers + 1)
        params = {}
        in_dim = self.num_sites
        for i in range(self.num_layers):
            params[f'dense_{i}'] = nn.linear_init(keys[i], in_dim,
                                                  self.layer_size)
            in_dim = self.layer_size
        # Small head init keeps initial logψ nearly flat (see nn.linear_init).
        head_scale = 0.1 if self.output_activation == 'exp' else 1.0
        params['out'] = nn.linear_init(keys[-1], in_dim, 1, scale=head_scale)
        return params

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        act = logamp.ACTIVATIONS[self.nonlinearity]
        h = configs
        for i in range(self.num_layers):
            h = act(nn.linear_apply(params[f'dense_{i}'], h))
        pre = jnp.squeeze(nn.linear_apply(params['out'], h), axis=-1)
        return logamp.apply_activation(pre, self.output_activation)

    @classmethod
    def from_config(cls, config, name: str = '') -> 'FullyConnectedNetwork':
        kwargs = dict(
            num_sites=config.num_sites,
            num_layers=config.num_fc_layers,
            layer_size=config.fc_layer_size,
            nonlinearity=config.nonlinearity,
            output_activation=config.output_activation,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)


@register('rbm')
class RestrictedBoltzmannNetwork(Wavefunction):
    """Extended RBM: MLP feature stack -> log cosh hidden sum + on-site bias.

    logpsi = Linear_1(configs) + sum_h log cosh(Linear_h(features(configs))),
    sign = +1 (the reference exponentiates this same quantity,
    cgs_vmc/wavefunctions.py:434-436).
    """

    def __init__(self, num_sites: int, num_layers: int, layer_size: int,
                 nonlinearity: str = 'relu',
                 name: str = 'restricted_boltzmann_network'):
        self.name = name
        self.num_sites = num_sites
        self.num_layers = num_layers
        self.layer_size = layer_size
        self.nonlinearity = nonlinearity

    def init(self, key: jax.Array) -> Params:
        keys = jax.random.split(key, self.num_layers + 2)
        params = {}
        in_dim = self.num_sites
        for i in range(self.num_layers):
            params[f'dense_{i}'] = nn.linear_init(keys[i], in_dim,
                                                  self.layer_size)
            in_dim = self.layer_size
        # Small head init keeps initial logψ nearly flat (see nn.linear_init).
        params['hidden'] = nn.linear_init(keys[-2], in_dim, self.layer_size,
                                          scale=0.1)
        params['onsite'] = nn.linear_init(keys[-1], self.num_sites, 1,
                                          scale=0.1)
        return params

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        act = logamp.ACTIVATIONS[self.nonlinearity]
        h = configs
        for i in range(self.num_layers):
            h = act(nn.linear_apply(params[f'dense_{i}'], h))
        hidden = nn.log_cosh(nn.linear_apply(params['hidden'], h))
        onsite = jnp.squeeze(nn.linear_apply(params['onsite'], configs),
                             axis=-1)
        log_psi = onsite + jnp.sum(hidden, axis=-1)
        return LogAmp(jnp.ones_like(log_psi), log_psi)

    @classmethod
    def from_config(cls, config, name: str = ''
                    ) -> 'RestrictedBoltzmannNetwork':
        kwargs = dict(
            num_sites=config.num_sites,
            num_layers=config.num_fc_layers,
            layer_size=config.fc_layer_size,
            nonlinearity=config.nonlinearity,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
