"""Sz-conserving Metropolis exchange sampler, fully compiled.

Re-design of the reference's per-move session.run sampler
(cgs_vmc/graph_builders.py:38-89): the move semantics are identical —
pick one random down spin and one random up spin per chain via the
noise-weighted argmin/argmax trick, exchange them, accept with
|psi'/psi| > sqrt(u) (⇔ |psi|² sampling) — but whole sweeps
(n_sites proposals) and multi-sweep decorrelation runs execute inside a
single jitted `lax.fori_loop`, eliminating the reference's ~6,000
Python→device round-trips per epoch (SURVEY.md §3.1).

State is a pytree sharded along the chain axis: each chain carries its own
PRNG key, so sharding over a device mesh requires no cross-device RNG
coordination whatsoever.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from cgs_vmc_jax import basis as basis_lib
from cgs_vmc_jax.models.base import Params, Wavefunction


class SamplerState(NamedTuple):
    """Per-chain Markov state (all leaves lead with the chain axis)."""
    configs: jax.Array        # [chains, n_sites] ±1 float32
    log_amp: jax.Array        # [chains] log|psi(configs)|
    sign: jax.Array           # [chains] sign(psi(configs))
    keys: jax.Array           # [chains] per-chain PRNG keys (uint32[2])
    num_accepted: jax.Array   # [chains] float32 accepted-move counter
    num_proposed: jax.Array   # [chains] float32 proposal counter


def init_sampler(key: jax.Array, wf: Wavefunction, params: Params,
                 n_sites: int, n_chains: int,
                 full_space: bool = False,
                 n_down: int | None = None) -> SamplerState:
    """Random fixed-Sz chains + their amplitudes (reference utils.py:169-192
    for the initializer; amplitudes cached so each proposal needs only one
    new forward pass, vs the reference's two, graph_builders.py:54-55,74).

    full_space: initialize uniformly over the full 2^N space instead of
    a fixed-Sz sector — required with the non-conserving 'flip' move
    (non-Sz-conserving Hamiltonians, e.g. the transverse-field Ising
    model).
    n_down: Sz sector (default Sz=0); the exchange move conserves it, so
    the init alone pins the sampled sector."""
    init_key, chain_key = jax.random.split(key)
    if full_space:
        configs = basis_lib.random_spin_configurations(
            init_key, n_sites, n_chains)
    else:
        configs = basis_lib.random_configurations(init_key, n_sites,
                                                  n_chains, n_down)
    amp = wf.apply(params, configs)
    return SamplerState(
        configs=configs,
        log_amp=amp.log,
        sign=amp.sign,
        keys=jax.random.split(chain_key, n_chains),
        num_accepted=jnp.zeros(n_chains, jnp.float32),
        num_proposed=jnp.zeros(n_chains, jnp.float32),
    )


def _propose_exchange(keys: jax.Array, configs: jax.Array
                      ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """One exchange proposal per chain.

    Weighted argmin/argmax pick (reference graph_builders.py:59-65):
    multiply spins by per-site uniforms; the argmin is a uniformly random
    -1 site, the argmax a uniformly random +1 site.

    Returns (proposed_configs, accept_uniform, new_keys).
    """
    n_chains, n_sites = configs.shape

    def per_chain(k):
        k_next, k_sites, k_accept = jax.random.split(k, 3)
        u = jax.random.uniform(k_sites, (n_sites,))
        return k_next, u, jax.random.uniform(k_accept, ())

    new_keys, site_u, accept_u = jax.vmap(per_chain)(keys)
    swap_choice = configs * site_u
    down_site = jnp.argmin(swap_choice, axis=-1)  # a random -1 spin
    up_site = jnp.argmax(swap_choice, axis=-1)    # a random +1 spin
    rows = jnp.arange(n_chains)
    proposed = configs.at[rows, down_site].set(1.0)
    proposed = proposed.at[rows, up_site].set(-1.0)
    return proposed, accept_u, new_keys


def _propose_flip(keys: jax.Array, configs: jax.Array
                  ) -> tuple[jax.Array, jax.Array, jax.Array]:
    """One single-spin-flip proposal per chain (non-Sz-conserving).

    The move set for Hamiltonians that do not conserve Sz (e.g. the
    transverse-field Ising model, ops/ising.py): flip one uniformly random
    site.  The proposal is symmetric, so the plain |psi|² Metropolis
    acceptance applies unchanged.

    Returns (proposed_configs, accept_uniform, new_keys).
    """
    n_chains, n_sites = configs.shape

    def per_chain(k):
        k_next, k_site, k_accept = jax.random.split(k, 3)
        site = jax.random.randint(k_site, (), 0, n_sites)
        return k_next, site, jax.random.uniform(k_accept, ())

    new_keys, sites, accept_u = jax.vmap(per_chain)(keys)
    rows = jnp.arange(n_chains)
    proposed = configs.at[rows, sites].multiply(-1.0)
    return proposed, accept_u, new_keys


PROPOSALS = {
    'exchange': _propose_exchange,
    'flip': _propose_flip,
}


def mc_step(wf: Wavefunction, params: Params, state: SamplerState,
            move: str = 'exchange', beta=None) -> SamplerState:
    """One Metropolis move on every chain.

    Acceptance: |psi'|/|psi| > sqrt(u) ⇔ 2*(log' - log) > log(u), the
    |psi|²-sampling rule of the reference (graph_builders.py:75-79) —
    valid for every move in PROPOSALS (all are symmetric proposals).

    beta: optional per-chain tempering exponents — chains then sample
    |psi|^(2*beta) instead of |psi|² (parallel tempering,
    sampler/tempering.py; beta=1 everywhere is the physical default).
    """
    proposed, accept_u, new_keys = PROPOSALS[move](state.keys,
                                                   state.configs)
    amp_new = wf.apply(params, proposed)
    # .real: |psi| = exp(Re log) — no-op for real ansatzes, and the phase
    # of a complex-log ansatz correctly never enters |psi|² sampling.
    delta_log = jnp.real(amp_new.log - state.log_amp)
    if beta is not None:
        delta_log = beta * delta_log
    accept = 2.0 * delta_log > jnp.log(accept_u)
    return SamplerState(
        configs=jnp.where(accept[:, None], proposed, state.configs),
        log_amp=jnp.where(accept, amp_new.log, state.log_amp),
        sign=jnp.where(accept, amp_new.sign, state.sign),
        keys=new_keys,
        num_accepted=state.num_accepted + accept.astype(jnp.float32),
        num_proposed=state.num_proposed + 1.0,
    )


def run_steps(wf: Wavefunction, params: Params, state: SamplerState,
              num_steps: int, move: str = 'exchange',
              beta=None) -> SamplerState:
    """`num_steps` sequential moves inside one compiled loop."""
    if num_steps <= 0:
        return state
    return lax.fori_loop(
        0, num_steps, lambda _, s: mc_step(wf, params, s, move, beta),
        state)


def run_sweeps(wf: Wavefunction, params: Params, state: SamplerState,
               num_sweeps: int, move: str = 'exchange') -> SamplerState:
    """A sweep = n_sites proposals per chain (reference epoch loops ran
    `num_*_sweeps * num_sites` individual session.run calls,
    cgs_vmc/training.py:608-617)."""
    n_sites = state.configs.shape[-1]
    return run_steps(wf, params, state, num_sweeps * n_sites, move)


def move_type(config) -> str:
    """The configured Metropolis move ('exchange' | 'flip')."""
    return getattr(config, 'mc_move_type', 'exchange') or 'exchange'


def init_sampler_for(key: jax.Array, wf: Wavefunction, params: Params,
                     config, n_chains: int | None = None) -> SamplerState:
    """Config-aware init: full-space chains when the move is 'flip';
    a parallel-tempering ladder when config.pt_replicas >= 2; a
    non-default Sz sector when config.total_sz2 != 0."""
    full_space = move_type(config) == 'flip'
    total_sz2 = getattr(config, 'total_sz2', 0)
    if full_space and total_sz2:
        raise ValueError(
            "total_sz2 != 0 requires the Sz-conserving 'exchange' move: "
            "single-spin flips do not stay in a fixed-Sz sector")
    n_down = basis_lib.n_down_for(config.num_sites, total_sz2)
    n_replicas = getattr(config, 'pt_replicas', 0)
    if n_replicas and n_replicas >= 2:
        from cgs_vmc_jax.sampler import tempering
        return tempering.init_pt_sampler(
            key, wf, params, config.num_sites,
            n_chains or config.batch_size, n_replicas,
            getattr(config, 'pt_beta_min', 0.4),
            full_space=full_space, n_down=n_down)
    return init_sampler(key, wf, params, config.num_sites,
                        n_chains or config.batch_size,
                        full_space=full_space, n_down=n_down)


def refresh_amplitudes(wf: Wavefunction, params: Params,
                       state: SamplerState) -> SamplerState:
    """Recomputes the cached (sign, log) for the current configs.

    MUST be called whenever `params` changed since the cache was written
    (epoch start, or after an in-epoch update step): Metropolis ratios
    against a stale cache are not ratios of the current wavefunction and
    silently freeze or randomize the chains.
    """
    from cgs_vmc_jax.sampler import tempering
    if isinstance(state, tempering.PTSamplerState):
        return tempering.refresh_amplitudes(wf, params, state)
    amp = wf.apply(params, state.configs)
    return state._replace(log_amp=amp.log, sign=amp.sign)


def advance_chain_keys(keys: jax.Array, k0_next: jax.Array) -> jax.Array:
    """Advance every per-chain key one split step, substituting the fast
    path's continuation key for chain 0.

    RNG contract for the incremental fast-path samplers (fast_rbm,
    fast_pbdg, fast_mps): they draw ALL their streamed randomness from
    splits of ``keys[0]`` — per-chain independence comes from the shape of
    the drawn arrays, not from the per-chain key streams.  Advancing the
    remaining chains' keys here guarantees that a later switch to the
    generic per-chain sampler can never re-enter the streams those chains
    held before the fast-path call (round-2 review: stale-stream aliasing
    hazard), while chain 0 continues from the split the fast path already
    reserved.
    """
    advanced = jax.vmap(lambda k: jax.random.split(k, 1)[0])(keys)
    return advanced.at[0].set(k0_next)


def reset_stats(state: SamplerState) -> SamplerState:
    from cgs_vmc_jax.sampler import tempering
    if isinstance(state, tempering.PTSamplerState):
        return tempering.reset_stats(state)
    return state._replace(
        num_accepted=jnp.zeros_like(state.num_accepted),
        num_proposed=jnp.zeros_like(state.num_proposed),
    )


def acceptance_rate(state: SamplerState) -> jax.Array:
    """Fraction of accepted moves since the last reset, [] float32."""
    total = jnp.sum(state.num_proposed)
    return jnp.sum(state.num_accepted) / jnp.maximum(total, 1.0)


@functools.partial(jax.jit, static_argnums=(0, 3, 4))
def jitted_sweeps(wf: Wavefunction, params: Params, state: SamplerState,
                  num_sweeps: int, move: str = 'exchange') -> SamplerState:
    """Standalone jitted entry point (drivers embed run_sweeps in larger
    compiled epoch functions instead)."""
    return run_sweeps(wf, params, state, num_sweeps, move)
