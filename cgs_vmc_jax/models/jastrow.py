"""Spin Jastrow pair-product ansatz.

The classic VMC baseline the reference does not ship (its simplest
ansatz is the fully-connected MLP, cgs_vmc/wavefunctions.py:328-388):

    log psi(s) = 1/2 s^T S s + b^T s,     S = (W + W^T)/2

with a trainable pair matrix W [n, n] and one-body field b [n]; sign is
+1 (composable to signful states through the wavefunction algebra or the
complex-phase wrapper, like every other positive ansatz here).

Two framework reasons to carry it beyond physics coverage:

 * it is the textbook incremental-sampler case — a pair exchange changes
   log psi by an O(n) expression in two rows of S (sampler/fast_jastrow.py),
   exercising the fast-path registry with an exact delta_logpsi;
 * as a product factor (``wavefunction_type='prod'`` with any network) it
   is the standard Jastrow x determinant / Jastrow x CNN construction.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cgs_vmc_jax.models.base import LogAmp, Params, Wavefunction, register
from cgs_vmc_jax.ops import logamp


@register('jastrow')
class JastrowWavefunction(Wavefunction):
    """Two-body spin Jastrow factor with a one-body field."""

    def __init__(self, num_sites: int, output_activation: str = 'exp',
                 name: str = 'jastrow'):
        self.name = name
        self.num_sites = num_sites
        self.output_activation = output_activation

    def init(self, key: jax.Array) -> Params:
        k_w, k_b = jax.random.split(key)
        n = self.num_sites
        # Small init keeps initial log psi nearly flat, matching the
        # linear_init(scale=0.1) convention of the other ansatzes.
        scale = 0.1 / jnp.sqrt(float(n))
        return {
            'pair': {'w': scale * jax.random.normal(k_w, (n, n),
                                                    jnp.float32)},
            'onsite': {'b': (0.1 * scale
                             * jax.random.normal(k_b, (n,), jnp.float32))},
        }

    @staticmethod
    def symmetric_pair(params: Params) -> jax.Array:
        """S = (W + W^T)/2 — the matrix log psi actually depends on."""
        w = params['pair']['w']
        return 0.5 * (w + w.T)

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        s = configs.astype(jnp.float32)
        sym = self.symmetric_pair(params)
        quad = 0.5 * jnp.einsum('bi,ij,bj->b', s, sym, s)
        pre = quad + s @ params['onsite']['b']
        return logamp.apply_activation(pre, self.output_activation)

    @classmethod
    def from_config(cls, config, name: str = '') -> 'JastrowWavefunction':
        kwargs = dict(num_sites=config.num_sites,
                      output_activation=config.output_activation)
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
