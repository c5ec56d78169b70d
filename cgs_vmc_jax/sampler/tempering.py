"""Parallel tempering (replica exchange) over |psi|^(2*beta) ladders.

BEYOND-REFERENCE capability: the reference has exactly one sampling
strategy (single-temperature Metropolis exchange,
cgs_vmc/graph_builders.py:38-89).  For rugged |psi|² landscapes —
frustrated models, near-degenerate sign sectors, peaked distilled
targets — single-temperature chains mix slowly; parallel tempering runs
K replicas of every chain at exponents 1 = beta_0 > ... > beta_{K-1}
(sampling |psi|^(2*beta_k)) and periodically proposes neighbour swaps,
letting flattened-landscape replicas ferry configurations across
probability barriers (Swendsen & Wang 1986; standard VMC practice).

Design:

* Replicas ride the BATCH axis: one tempered Metropolis step evaluates
  all K replicas of all chains in a single fused forward pass
  [chains*K, n_sites] — a bigger batch, not a Python loop.
* Every chain carries its own INDEPENDENT K-replica ladder, and all
  PTSamplerState leaves are chain-leading: swaps are chain-local
  (a [chains, K] permutation gather), so sharding over the 'chains'
  mesh axis needs NO cross-device communication and the existing
  `parallel.mesh.train_state_specs` (shard every sampler leaf on its
  leading axis) is already correct.
* The physical (beta=1) replica occupies the SamplerState-named fields
  (configs/log_amp/sign/keys/num_accepted/num_proposed), so every
  existing consumer — optimizers collecting `smp.configs`, acceptance
  statistics, evaluators — sees exactly the physical ensemble without
  modification; the tempered replicas live in `aux_*` fields.

Enable with ``config.pt_replicas = K`` (K >= 2); the ladder is geometric
down to ``config.pt_beta_min`` and swaps run after every sweep with
alternating even/odd neighbour pairings.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from cgs_vmc_jax import basis as basis_lib
from cgs_vmc_jax.models.base import Params, Wavefunction
from cgs_vmc_jax.sampler import metropolis


class PTSamplerState(NamedTuple):
    """Per-chain parallel-tempering state (all leaves chain-leading).

    Fields 1-6 are the PHYSICAL (beta=1) replica with SamplerState
    semantics; aux_* hold the R = K-1 tempered replicas of each chain.
    """
    configs: jax.Array        # [chains, n_sites] physical replica
    log_amp: jax.Array        # [chains]
    sign: jax.Array           # [chains]
    keys: jax.Array           # [chains] physical per-chain PRNG keys
    num_accepted: jax.Array   # [chains] physical-move acceptance counter
    num_proposed: jax.Array   # [chains]
    aux_configs: jax.Array    # [chains, R, n_sites] tempered replicas
    aux_log: jax.Array        # [chains, R]
    aux_sign: jax.Array       # [chains, R]
    aux_keys: jax.Array       # [chains, R]
    betas: jax.Array          # [chains, K] descending, betas[:, 0] = 1
    swap_keys: jax.Array      # [chains] PRNG keys for swap decisions
    swap_accepted: jax.Array  # [chains, R] per neighbour pair
    swap_proposed: jax.Array  # [chains, R]


def geometric_ladder(n_replicas: int, beta_min: float) -> jnp.ndarray:
    """[K] descending geometric exponents 1 ... beta_min."""
    if n_replicas < 2:
        raise ValueError('pt_replicas must be >= 2 for tempering')
    if not 0.0 < beta_min < 1.0:
        raise ValueError(f'pt_beta_min must be in (0, 1), got {beta_min}')
    steps = jnp.arange(n_replicas) / (n_replicas - 1)
    return jnp.asarray(beta_min, jnp.float32) ** steps


def init_pt_sampler(key: jax.Array, wf: Wavefunction, params: Params,
                    n_sites: int, n_chains: int, n_replicas: int,
                    beta_min: float,
                    full_space: bool = False,
                    n_down: int | None = None) -> PTSamplerState:
    init_key, chain_key, swap_key = jax.random.split(key, 3)
    total = n_chains * n_replicas
    if full_space:
        flat = basis_lib.random_spin_configurations(init_key, n_sites, total)
    else:
        flat = basis_lib.random_configurations(init_key, n_sites, total,
                                               n_down)
    amp = wf.apply(params, flat)
    configs = flat.reshape(n_chains, n_replicas, n_sites)
    logs = amp.log.reshape(n_chains, n_replicas)
    signs = amp.sign.reshape(n_chains, n_replicas)
    keys = jax.random.split(chain_key, total).reshape(
        (n_chains, n_replicas) + jax.random.split(chain_key, 2).shape[1:])
    r = n_replicas - 1
    return PTSamplerState(
        configs=configs[:, 0],
        log_amp=logs[:, 0],
        sign=signs[:, 0],
        keys=keys[:, 0],
        num_accepted=jnp.zeros(n_chains, jnp.float32),
        num_proposed=jnp.zeros(n_chains, jnp.float32),
        aux_configs=configs[:, 1:],
        aux_log=logs[:, 1:],
        aux_sign=signs[:, 1:],
        aux_keys=keys[:, 1:],
        betas=jnp.broadcast_to(geometric_ladder(n_replicas, beta_min),
                               (n_chains, n_replicas)),
        swap_keys=jax.random.split(swap_key, n_chains),
        swap_accepted=jnp.zeros((n_chains, r), jnp.float32),
        swap_proposed=jnp.zeros((n_chains, r), jnp.float32),
    )


def _stacked(state: PTSamplerState):
    """Full-ladder views [chains, K, ...] (physical at index 0)."""
    configs = jnp.concatenate([state.configs[:, None], state.aux_configs],
                              axis=1)
    logs = jnp.concatenate([state.log_amp[:, None], state.aux_log], axis=1)
    signs = jnp.concatenate([state.sign[:, None], state.aux_sign], axis=1)
    keys = jnp.concatenate([state.keys[:, None], state.aux_keys], axis=1)
    return configs, logs, signs, keys


def _unstacked(state: PTSamplerState, configs, logs, signs, keys
               ) -> PTSamplerState:
    return state._replace(
        configs=configs[:, 0], log_amp=logs[:, 0], sign=signs[:, 0],
        keys=keys[:, 0], aux_configs=configs[:, 1:], aux_log=logs[:, 1:],
        aux_sign=signs[:, 1:], aux_keys=keys[:, 1:])


def _swap_round(state: PTSamplerState, parity: jax.Array) -> PTSamplerState:
    """One neighbour-swap round at the given pairing parity (0 or 1).

    Pair i couples replicas (i, i+1); only pairs with i % 2 == parity
    propose this round, so proposed swaps are disjoint.  Acceptance is
    the standard replica-exchange rule for pi_k = |psi|^(2*beta_k):
      A = min(1, exp(2*(beta_i - beta_{i+1}) * (log|psi_{i+1}| - log|psi_i|)))
    — configurations and their cached amplitudes swap; the slot PRNG
    keys and the beta ladder stay put.
    """
    configs, logs, signs, keys = _stacked(state)
    n_chains, n_rep = logs.shape
    r = n_rep - 1

    def per_chain_uniforms(k):
        k_next, k_u = jax.random.split(k)
        return k_next, jax.random.uniform(k_u, (r,))

    new_swap_keys, u = jax.vmap(per_chain_uniforms)(state.swap_keys)

    real_logs = jnp.real(logs)                                # [chains, K]
    d_beta = state.betas[:, :-1] - state.betas[:, 1:]         # [chains, R]
    d_log = real_logs[:, 1:] - real_logs[:, :-1]              # [chains, R]
    pair_on = (jnp.arange(r) % 2) == parity                   # [R]
    accept = jnp.logical_and(pair_on[None, :],
                             2.0 * d_beta * d_log > jnp.log(u))

    # Chain-local permutation: row k swaps with k+1 where pair k accepted.
    swap_next = jnp.pad(accept, ((0, 0), (0, 1)))             # [chains, K]
    swap_prev = jnp.pad(accept, ((0, 0), (1, 0)))
    perm = (jnp.arange(n_rep)[None, :]
            + swap_next.astype(jnp.int32) - swap_prev.astype(jnp.int32))

    def permute(x):
        idx = perm.reshape(perm.shape + (1,) * (x.ndim - 2))
        return jnp.take_along_axis(x, jnp.broadcast_to(
            idx, x.shape[:2] + x.shape[2:]), axis=1)

    configs = permute(configs)
    logs = permute(logs)
    signs = permute(signs)

    state = _unstacked(state, configs, logs, signs, keys)
    return state._replace(
        swap_keys=new_swap_keys,
        swap_accepted=state.swap_accepted + accept.astype(jnp.float32),
        swap_proposed=(state.swap_proposed
                       + pair_on.astype(jnp.float32)[None, :]),
    )


def run_sweeps(wf: Wavefunction, params: Params, state: PTSamplerState,
               num_sweeps: int, move: str = 'exchange') -> PTSamplerState:
    """num_sweeps tempered sweeps, one swap round after each sweep.

    A sweep = n_sites tempered Metropolis proposals on every replica of
    every chain, executed as flattened [chains*K] SamplerState steps so
    each proposal is ONE fused forward pass over the whole ladder.
    """
    if num_sweeps <= 0:
        return state
    n_chains, n_sites = state.configs.shape
    n_rep = state.betas.shape[1]

    def one_sweep(i, s):
        configs, logs, signs, keys = _stacked(s)
        flat = metropolis.SamplerState(
            configs=configs.reshape(n_chains * n_rep, n_sites),
            log_amp=logs.reshape(n_chains * n_rep),
            sign=signs.reshape(n_chains * n_rep),
            keys=keys.reshape((n_chains * n_rep,) + keys.shape[2:]),
            num_accepted=jnp.zeros(n_chains * n_rep, jnp.float32),
            num_proposed=jnp.zeros(n_chains * n_rep, jnp.float32),
        )
        beta_flat = s.betas.reshape(n_chains * n_rep)
        flat = metropolis.run_steps(wf, params, flat, n_sites, move,
                                    beta=beta_flat)

        def unflat(x):
            return x.reshape((n_chains, n_rep) + x.shape[1:])

        s = _unstacked(s, unflat(flat.configs), unflat(flat.log_amp),
                       unflat(flat.sign), unflat(flat.keys))
        # Physical-move statistics only (replica 0), keeping the
        # SamplerState acceptance-rate semantics for consumers.
        acc = unflat(flat.num_accepted)[:, 0]
        prop = unflat(flat.num_proposed)[:, 0]
        s = s._replace(num_accepted=s.num_accepted + acc,
                       num_proposed=s.num_proposed + prop)
        return _swap_round(s, i % 2)

    return lax.fori_loop(0, num_sweeps, one_sweep, state)


def refresh_amplitudes(wf: Wavefunction, params: Params,
                       state: PTSamplerState) -> PTSamplerState:
    """Recompute cached amplitudes of ALL replicas (one fused forward).

    Stale aux amplitudes would corrupt both tempered acceptance ratios
    and swap decisions, so the ladder refreshes together.
    """
    configs, logs, signs, keys = _stacked(state)
    n_chains, n_rep, n_sites = configs.shape
    amp = wf.apply(params, configs.reshape(n_chains * n_rep, n_sites))
    return _unstacked(state, configs,
                      amp.log.reshape(n_chains, n_rep),
                      amp.sign.reshape(n_chains, n_rep), keys)


def reset_stats(state: PTSamplerState) -> PTSamplerState:
    return state._replace(
        num_accepted=jnp.zeros_like(state.num_accepted),
        num_proposed=jnp.zeros_like(state.num_proposed),
        swap_accepted=jnp.zeros_like(state.swap_accepted),
        swap_proposed=jnp.zeros_like(state.swap_proposed),
    )


def swap_rate(state: PTSamplerState) -> jax.Array:
    """Mean accepted/proposed swap fraction per neighbour pair, [R]."""
    acc = jnp.sum(state.swap_accepted, axis=0)
    prop = jnp.sum(state.swap_proposed, axis=0)
    return acc / jnp.maximum(prop, 1.0)
