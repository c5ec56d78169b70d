"""Graph-convolutional wavefunction ansatz for arbitrary lattices.

Log-domain re-design of the reference GraphConvNetwork
(cgs_vmc/wavefunctions.py:1083-1154) + GraphConvLayer
(cgs_vmc/layers.py:415-451): neighbour features are gathered by a static
[n_sites, num_neighbors] adjacency list and contracted with a shared
kernel via einsum (one dense contraction instead of a 1×k conv on a
gathered 4-D table).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cgs_vmc_jax import lattice
from cgs_vmc_jax.models import nn
from cgs_vmc_jax.models.base import Params, Wavefunction, register
from cgs_vmc_jax.ops import logamp
from cgs_vmc_jax.ops.logamp import LogAmp


@register('gnn')
class GraphConvNetwork(Wavefunction):

    def __init__(self, num_layers: int, num_filters: int, adj: np.ndarray,
                 nonlinearity: str = 'relu', output_activation: str = 'exp',
                 name: str = 'graph_conv_network'):
        self.name = name
        self.num_layers = num_layers
        self.num_filters = num_filters
        self.adj = np.asarray(adj, np.int32)  # host constant (see symmetry.py)
        self.nonlinearity = nonlinearity
        self.output_activation = output_activation

    def init(self, key: jax.Array) -> Params:
        keys = jax.random.split(key, self.num_layers)
        num_neighbors = self.adj.shape[1]
        params = {}
        in_ch = 1
        head_scale = 0.1 if self.output_activation == 'exp' else 1.0
        for i in range(self.num_layers):
            scale = head_scale if i + 1 == self.num_layers else 1.0
            params[f'gconv_{i}'] = nn.graph_conv_init(
                keys[i], in_ch, self.num_filters, num_neighbors, scale=scale)
            in_ch = self.num_filters
        return params

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        act = logamp.ACTIVATIONS[self.nonlinearity]
        h = configs[..., None]  # [batch, n_sites, 1]
        for i in range(self.num_layers):
            h = nn.graph_conv_apply(params[f'gconv_{i}'], h, self.adj)
            if i + 1 != self.num_layers:
                h = act(h)
        pre = jnp.sum(h, axis=(1, 2))
        return logamp.apply_activation(pre, self.output_activation)

    @classmethod
    def from_config(cls, config, name: str = '') -> 'GraphConvNetwork':
        if config.adjacency_list_path:
            adj = lattice.load_adjacency(config.adjacency_list_path)
        else:
            adj = lattice.adjacency_from_bonds(
                lattice.bonds_for_config(config), config.num_sites)
        kwargs = dict(
            num_layers=config.num_conv_layers,
            num_filters=config.num_conv_filters,
            adj=adj,
            nonlinearity=config.nonlinearity,
            output_activation=config.output_activation,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
