"""Autoregressive spin ansatz (MADE) with EXACT sector-projected sampling.

A capability class the reference (pure Metropolis, cgs_vmc/
graph_builders.py:38-89) does not have: the wavefunction parameterizes a
NORMALIZED distribution

    |psi(s)|^2 = prod_i p(s_i | s_<i),      log|psi| = 1/2 sum_i log p_i,

so configurations are drawn i.i.d. by ancestral sampling — no Markov
chain, no equilibration, no autocorrelation, and estimator error bars
are the plain i.i.d. ones.  The conditionals come from one MADE-masked
MLP forward (Germain et al. 2015-style masks): logit_i depends only on
s_<i, which makes *evaluation* a single parallel forward pass (one
batched matmul chain) while *sampling* runs one forward per site inside a `lax.scan`.

The Sz=0 sector is enforced exactly inside the conditionals: with u ups
placed before site i and r sites remaining, s_i=+1 is forced when
n/2 - u == r and blocked when u == n/2, and each conditional still sums
to one — so the distribution is exactly normalized ON the sector
(asserted against full enumeration in tests/test_autoregressive.py).

Sign structure: positive (sign = +1), like every modulus ansatz here —
Marshall-gauged bipartite models are its natural regime.  Dispatch into
the training loop goes through the sampler fast-path registry entry
'exact_autoregressive' (sampler/registry.py), which replaces Metropolis
sweeps with fresh exact draws.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from cgs_vmc_jax.models.base import LogAmp, Params, Wavefunction, register
from cgs_vmc_jax.ops import logamp


def _made_masks(n: int, hidden: int, num_hidden_layers: int
                ) -> list[np.ndarray]:
    """MADE masks for n inputs -> [hidden]*L -> n outputs.

    Input degrees d_j = j; hidden degrees cycle over 0..n-2; output i
    connects to hidden units of degree < i (strict), so logit_i sees
    inputs j <= m_k < i only.  Site 0's logit is a pure bias.
    """
    d_in = np.arange(n)
    m_hidden = np.arange(hidden) % max(n - 1, 1)
    masks = [(d_in[:, None] <= m_hidden[None, :]).astype(np.float32)]
    for _ in range(num_hidden_layers - 1):
        masks.append(
            (m_hidden[:, None] <= m_hidden[None, :]).astype(np.float32))
    masks.append((m_hidden[:, None] < d_in[None, :]).astype(np.float32))
    return masks


@register('made')
class AutoregressiveSpinModel(Wavefunction):
    """MADE over +-1 spins; |psi|^2 is an exactly normalized Sz=0 law."""

    def __init__(self, num_sites: int, hidden: int = 64,
                 num_hidden_layers: int = 1, nonlinearity: str = 'relu',
                 name: str = 'made'):
        if num_sites % 2:
            raise ValueError('Sz=0 sector requires even num_sites')
        self.name = name
        self.num_sites = num_sites
        self.hidden = hidden
        self.num_hidden_layers = max(1, num_hidden_layers)
        self.nonlinearity = nonlinearity
        # Host numpy masks: lowered as constants (see models/symmetry.py).
        self.masks = _made_masks(num_sites, hidden, self.num_hidden_layers)

    # ------------------------------------------------------------------

    def init(self, key: jax.Array) -> Params:
        keys = jax.random.split(key, len(self.masks))
        params = {}
        for i, mask in enumerate(self.masks):
            fan_in = max(float(mask.sum(0).mean()), 1.0)
            w = jax.random.normal(keys[i], mask.shape, jnp.float32)
            params[f'dense_{i}'] = {
                'w': w / jnp.sqrt(fan_in),
                'b': jnp.zeros((mask.shape[1],), jnp.float32),
            }
        return params

    def _logits(self, params: Params, configs: jax.Array) -> jax.Array:
        """[batch, n] logits; logit_i depends only on configs[:, :i]."""
        act = logamp.ACTIVATIONS[self.nonlinearity]
        h = configs.astype(jnp.float32)
        last = len(self.masks) - 1
        for i, mask in enumerate(self.masks):
            layer = params[f'dense_{i}']
            h = h @ (layer['w'] * mask) + layer['b']
            if i != last:
                h = act(h)
        return h

    def _conditional_log_p(self, params: Params, configs: jax.Array
                           ) -> jax.Array:
        """log p(s_i | s_<i) at the realized s_i, [batch, n], with the
        exact Sz=0 sector projection folded into each conditional."""
        return self.conditional_log_p_from_logits(
            self._logits(params, configs), configs)

    @staticmethod
    def conditional_log_p_from_logits(logits: jax.Array,
                                      configs: jax.Array) -> jax.Array:
        """Sector-projected conditional log-probs given precomputed
        logits (static: reusable by alternative logits computations,
        e.g. the per-sample-weights fast-Jacobian path)."""
        n = configs.shape[-1]
        s = configs.astype(jnp.float32)
        up = (s > 0).astype(jnp.float32)
        # ups placed strictly before site i.
        u_before = jnp.cumsum(up, axis=-1) - up
        remaining = jnp.asarray(n - np.arange(n), jnp.float32)  # incl. i
        ups_left = 0.5 * n - u_before
        forced_up = ups_left >= remaining          # all rest must be up
        blocked_up = ups_left <= 0.0               # up quota exhausted
        # Unconstrained Bernoulli log-probs (stable log-sigmoid).
        log_p_up = jax.nn.log_sigmoid(logits)
        log_p_down = jax.nn.log_sigmoid(-logits)
        zero = jnp.zeros_like(log_p_up)
        neg_inf = jnp.full_like(log_p_up, -jnp.inf)
        log_p_up = jnp.where(forced_up, zero,
                             jnp.where(blocked_up, neg_inf, log_p_up))
        log_p_down = jnp.where(forced_up, neg_inf,
                               jnp.where(blocked_up, zero, log_p_down))
        return jnp.where(up > 0, log_p_up, log_p_down)

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        log_prob = jnp.sum(self._conditional_log_p(params, configs),
                           axis=-1)
        log_psi = 0.5 * log_prob
        return LogAmp(jnp.ones_like(log_psi), log_psi)

    # ------------------------------------------------------------------

    def sample(self, params: Params, keys: jax.Array) -> jax.Array:
        """Exact ancestral draws, one per key: [batch, n] +-1 configs in
        the Sz=0 sector, distributed exactly as |psi|^2.

        Single-hidden-layer models take an incremental path: the
        first-layer preactivation is rank-1-updated as each spin lands
        (z += s_i * W1[i]) and only logit_i's output column is formed —
        O(hidden) per site instead of the O(n*hidden) full forward.  The
        conditionals (and therefore the draws, bitwise up to reduction
        order) are identical; tests/test_autoregressive.py pins the two
        paths against each other.
        """
        if (type(self) is AutoregressiveSpinModel
                and self.num_hidden_layers == 1):
            return self._sample_incremental(params, keys)
        return self._sample_generic(params, keys)

    def _sample_generic(self, params: Params, keys: jax.Array) -> jax.Array:
        """Reference ancestral path: one full `_logits` forward per site
        (works for any subclass — PixelCNN reuses it unchanged)."""
        n = self.num_sites

        def one(key):
            site_keys = jax.random.split(key, n)

            def step(carry, i):
                s, u = carry                     # s: [n] partial, u: ups
                logits = self._logits(params, s[None, :])[0]
                ups_left = 0.5 * n - u
                remaining = jnp.asarray(n, jnp.float32) - i
                p_up = jax.nn.sigmoid(logits[i])
                p_up = jnp.where(ups_left >= remaining, 1.0,
                                 jnp.where(ups_left <= 0.0, 0.0, p_up))
                spin = jnp.where(
                    jax.random.uniform(site_keys[i]) < p_up, 1.0, -1.0)
                s = s.at[i].set(spin)
                return (s, u + (spin > 0)), None

            init = (jnp.zeros((n,), jnp.float32), jnp.asarray(0.0))
            (s, _), _ = jax.lax.scan(step, init, jnp.arange(n))
            return s

        return jax.vmap(one)(keys)

    def _sample_incremental(self, params: Params, keys: jax.Array
                            ) -> jax.Array:
        """O(hidden)-per-site ancestral draws for 1-hidden-layer MADE."""
        n = self.num_sites
        act = logamp.ACTIVATIONS[self.nonlinearity]
        l0, l1 = params['dense_0'], params['dense_1']
        w1 = l0['w'] * self.masks[0]             # [n, H] masked
        w2 = l1['w'] * self.masks[1]             # [H, n] masked

        def one(key):
            site_keys = jax.random.split(key, n)

            def step(carry, i):
                z, u = carry                     # z: [H] preactivation
                logit_i = act(z) @ w2[:, i] + l1['b'][i]
                ups_left = 0.5 * n - u
                remaining = jnp.asarray(n, jnp.float32) - i
                p_up = jax.nn.sigmoid(logit_i)
                p_up = jnp.where(ups_left >= remaining, 1.0,
                                 jnp.where(ups_left <= 0.0, 0.0, p_up))
                spin = jnp.where(
                    jax.random.uniform(site_keys[i]) < p_up, 1.0, -1.0)
                z = z + spin * w1[i]
                return (z, u + (spin > 0)), spin

            init = (l0['b'].astype(jnp.float32), jnp.asarray(0.0))
            _, spins = jax.lax.scan(step, init, jnp.arange(n))
            return spins

        return jax.vmap(one)(keys)

    @classmethod
    def from_config(cls, config, name: str = ''
                    ) -> 'AutoregressiveSpinModel':
        kwargs = dict(
            num_sites=config.num_sites,
            hidden=config.fc_layer_size,
            num_hidden_layers=max(1, config.num_fc_layers),
            nonlinearity=config.nonlinearity,
        )
        if name:
            kwargs['name'] = name
        return cls(**kwargs)
