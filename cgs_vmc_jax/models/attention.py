"""Self-attention (transformer) wavefunction ansatz.

A model family beyond the reference (cgs_vmc/wavefunctions.py ships
MLP/RBM/conv/MPS/determinant ansatzes only): each lattice site is a
token — spin value times a learned embedding vector plus a learned
positional embedding — processed by pre-LayerNorm transformer blocks
(multi-head self-attention + GELU MLP), mean-pooled and projected to a
scalar that is logψ directly in the log-amplitude protocol
(models/base.py).

Accelerator-friendly by construction: the whole forward is a handful of
large batched GEMMs ([batch·n_sites, d] projections and [batch, heads, n,
n] attention contractions) with static shapes — no masking, no KV cache, no dynamic control flow.  Attention is
geometry-agnostic (the positional embedding carries the lattice), so the
same ansatz runs on chains, square/triangular/honeycomb/kagome lattices,
and arbitrary J-file graphs, and it composes with the symmetry
projection and the complex/composite wrappers like every other ansatz.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cgs_vmc_jax.models import nn
from cgs_vmc_jax.models.base import Params, Wavefunction, register
from cgs_vmc_jax.ops import logamp
from cgs_vmc_jax.ops.logamp import LogAmp


def _layernorm_init(dim: int) -> dict:
    return {'g': jnp.ones((dim,), jnp.float32),
            'b': jnp.zeros((dim,), jnp.float32)}


def _layernorm(p: dict, x: jax.Array, eps: float = 1e-5) -> jax.Array:
    mean = jnp.mean(x, axis=-1, keepdims=True)
    var = jnp.var(x, axis=-1, keepdims=True)
    return p['g'] * (x - mean) * jax.lax.rsqrt(var + eps) + p['b']


@register('transformer')
class SpinTransformer(Wavefunction):
    """Pre-LN transformer encoder over site tokens; mean-pool -> logψ."""

    def __init__(self, num_sites: int, num_layers: int = 2,
                 model_dim: int = 32, num_heads: int = 4,
                 output_activation: str = 'exp',
                 name: str = 'spin_transformer'):
        if model_dim % num_heads:
            raise ValueError(f'model_dim {model_dim} must be divisible by '
                             f'num_heads {num_heads}')
        self.name = name
        self.num_sites = num_sites
        self.num_layers = num_layers
        self.model_dim = model_dim
        self.num_heads = num_heads
        self.output_activation = output_activation

    def init(self, key: jax.Array) -> Params:
        d = self.model_dim
        keys = jax.random.split(key, 4 * self.num_layers + 3)
        params: Params = {
            'spin_embed': 0.5 * jax.random.normal(keys[0], (d,), jnp.float32),
            'pos_embed': 0.02 * jax.random.normal(
                keys[1], (self.num_sites, d), jnp.float32),
            'ln_f': _layernorm_init(d),
        }
        # Residual-branch output projections shrink with depth so the
        # initial residual stream stays O(1) (GPT-2-style 1/sqrt(2L)).
        # Host math, not jnp: init must stay traceable (eval_shape /
        # AOT shape probes trace it, and float(tracer) raises).
        resid_scale = (2.0 * self.num_layers) ** -0.5
        for i in range(self.num_layers):
            k = keys[2 + 4 * i: 6 + 4 * i]
            params[f'block_{i}'] = {
                'ln1': _layernorm_init(d),
                'qkv': nn.linear_init(k[0], d, 3 * d),
                'attn_out': nn.linear_init(k[1], d, d,
                                           scale=resid_scale),
                'ln2': _layernorm_init(d),
                'mlp_in': nn.linear_init(k[2], d, 4 * d),
                'mlp_out': nn.linear_init(k[3], 4 * d, d,
                                          scale=resid_scale),
            }
        # Small head init keeps initial logψ nearly flat (see nn.linear_init).
        head_scale = 0.1 if self.output_activation == 'exp' else 1.0
        params['head'] = nn.linear_init(keys[-1], d, 1, scale=head_scale)
        return params

    def _attention(self, block: Params, h: jax.Array) -> jax.Array:
        batch, n, d = h.shape
        nh, dh = self.num_heads, d // self.num_heads
        qkv = nn.linear_apply(block['qkv'], _layernorm(block['ln1'], h))
        q, k, v = jnp.split(qkv.reshape(batch, n, 3, nh, dh), 3, axis=2)
        q, k, v = (t.squeeze(2) for t in (q, k, v))       # [B, n, nh, dh]
        logits = jnp.einsum('bqhd,bkhd->bhqk', q, k,
                            preferred_element_type=jnp.float32)
        attn = jax.nn.softmax(logits / jnp.sqrt(jnp.asarray(dh, jnp.float32)),
                              axis=-1)
        out = jnp.einsum('bhqk,bkhd->bqhd', attn, v,
                         preferred_element_type=jnp.float32)
        return nn.linear_apply(block['attn_out'], out.reshape(batch, n, d))

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        x = configs.astype(jnp.float32)
        h = x[..., None] * params['spin_embed'] + params['pos_embed']
        for i in range(self.num_layers):
            block = params[f'block_{i}']
            h = h + self._attention(block, h)
            m = nn.linear_apply(block['mlp_in'], _layernorm(block['ln2'], h))
            h = h + nn.linear_apply(block['mlp_out'], jax.nn.gelu(m))
        pooled = jnp.mean(_layernorm(params['ln_f'], h), axis=-2)
        pre = jnp.squeeze(nn.linear_apply(params['head'], pooled), axis=-1)
        return logamp.apply_activation(pre, self.output_activation)

    @classmethod
    def from_config(cls, config, name: str = '') -> 'SpinTransformer':
        kwargs = dict(
            num_sites=config.num_sites,
            num_layers=config.num_attention_layers,
            model_dim=config.attention_dim,
            num_heads=config.num_attention_heads,
            output_activation=config.output_activation,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
