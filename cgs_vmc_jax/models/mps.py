"""Matrix product state ansatz as a rescaled lax.scan contraction.

Re-design of the reference MatrixProductState
(cgs_vmc/wavefunctions.py:812-873) which unstacked the batch into O(batch)
graph nodes and chained einsums on raw matrices (self-documented as
"extremely memory inefficient", wavefunctions.py:815-817).  Here:

 * per-site tensors live in one stacked [n_sites-2, 2, D, D] array, the
   spin-selected matrix is a take along the physical axis, and the chain
   contraction is a single `lax.scan` of batched [B,D]x[B,D,D] matvecs;
 * the running vector is renormalized by its max-abs each step with the
   log-scale accumulated separately, so the amplitude comes out directly
   in signed-log form — no overflow for any chain length.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from cgs_vmc_jax.models.base import Params, Wavefunction, register
from cgs_vmc_jax.ops.logamp import LogAmp


@register('mps')
class MatrixProductState(Wavefunction):

    def __init__(self, num_sites: int, bond_dimension: int,
                 name: str = 'matrix_product_state'):
        if num_sites < 3:
            raise ValueError('MPS requires at least 3 sites.')
        self.name = name
        self.num_sites = num_sites
        self.bond_dimension = bond_dimension

    def init(self, key: jax.Array) -> Params:
        d = self.bond_dimension
        k_first, k_mid, k_last = jax.random.split(key, 3)
        noise = 0.1
        eye = jnp.eye(d, dtype=jnp.float32)
        # Identity-plus-noise keeps the initial chain product O(1) so the
        # log-rescaled contraction starts well-conditioned.
        mid = eye[None, None] + noise * jax.random.normal(
            k_mid, (self.num_sites - 2, 2, d, d), jnp.float32)
        first = jnp.ones((2, d), jnp.float32) / d + noise * jax.random.normal(
            k_first, (2, d), jnp.float32)
        last = jnp.ones((2, d), jnp.float32) + noise * jax.random.normal(
            k_last, (2, d), jnp.float32)
        return {'first': first, 'mid': mid, 'last': last}

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        spin_idx = ((configs + 1.0) / 2.0).astype(jnp.int32)  # [B, N] in {0,1}
        vec = params['first'][spin_idx[:, 0]]  # [B, D]

        def step(carry, inputs):
            v, log_scale = carry
            mats = inputs['site_tensor'][inputs['idx']]  # [B, D, D]
            v = jnp.einsum('bd,bde->be', v, mats,
                           preferred_element_type=jnp.float32)
            norm = jnp.max(jnp.abs(v), axis=-1, keepdims=True)
            norm = jnp.where(norm > 0, norm, 1.0)
            return (v / norm, log_scale + jnp.log(norm[:, 0])), None

        xs = {
            'site_tensor': params['mid'],
            'idx': spin_idx[:, 1:-1].T,  # [N-2, B]
        }
        init = (vec, jnp.zeros(configs.shape[0], jnp.float32))
        (vec, log_scale), _ = lax.scan(step, init, xs)

        final = jnp.einsum('bd,bd->b', vec, params['last'][spin_idx[:, -1]],
                           preferred_element_type=jnp.float32)
        return LogAmp(jnp.sign(final),
                      log_scale + jnp.log(jnp.abs(final)))

    @classmethod
    def from_config(cls, config, name: str = '') -> 'MatrixProductState':
        kwargs = dict(
            num_sites=config.num_sites,
            bond_dimension=config.bond_dimension,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
