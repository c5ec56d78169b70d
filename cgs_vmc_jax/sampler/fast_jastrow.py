"""Incremental Metropolis sweeps for the Jastrow ansatz: exact O(n) delta.

For log psi = 1/2 s^T S s + b^T s (models/jastrow.py) a pair exchange
(down site d: -1 -> +1, up site u: +1 -> -1, i.e. Delta_d = +2,
Delta_u = -2) changes the log-amplitude by the EXACT closed form

    delta = Delta^T S s + 1/2 Delta^T S Delta + b^T Delta
          = 2 S[d]·s - 2 S[u]·s + 2 S_dd + 2 S_uu - 4 S_du
          + 2 b_d - 2 b_u

— two row gathers and a dot per chain, O(n) against the generic
sampler's O(n²) full quadratic form per proposal.  This is the textbook
delta_logpsi fast path the registry exists for (sampler/registry.py):
move semantics (noise-weighted argmin/argmax pick, sqrt(u) acceptance)
and per-chain key discipline are bit-identical to metropolis.mc_step —
only the amplitude arithmetic changes, and the cached log_amp is
re-derived from one exact forward at the end of every call so
incremental f32 drift can never accumulate across calls.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from cgs_vmc_jax.models.base import Params
from cgs_vmc_jax.models.jastrow import JastrowWavefunction
from cgs_vmc_jax.sampler.metropolis import SamplerState


def supports(wf) -> bool:
    """True for a plain (unsymmetrized, log-output) Jastrow ansatz."""
    return (isinstance(wf, JastrowWavefunction)
            and wf.output_activation == 'exp')


def _step(sym: jax.Array, b: jax.Array, state: SamplerState) -> SamplerState:
    """One exchange move per chain with the incremental delta."""
    n_chains, n_sites = state.configs.shape

    def per_chain(k):
        # Identical split discipline to metropolis._propose_exchange so
        # the fast path walks the same per-chain random streams.
        k_next, k_sites, k_accept = jax.random.split(k, 3)
        u = jax.random.uniform(k_sites, (n_sites,))
        return k_next, u, jax.random.uniform(k_accept, ())

    new_keys, site_u, accept_u = jax.vmap(per_chain)(state.keys)
    s = state.configs
    swap_choice = s * site_u
    down = jnp.argmin(swap_choice, axis=-1)    # a random -1 spin
    up = jnp.argmax(swap_choice, axis=-1)      # a random +1 spin

    rows_d = jnp.take(sym, down, axis=0)       # [chains, n] = S[d, :]
    rows_u = jnp.take(sym, up, axis=0)         # [chains, n] = S[u, :]
    chains = jnp.arange(n_chains)
    delta = (2.0 * jnp.sum(rows_d * s, axis=-1)
             - 2.0 * jnp.sum(rows_u * s, axis=-1)
             + 2.0 * rows_d[chains, down]      # S_dd
             + 2.0 * rows_u[chains, up]        # S_uu
             - 4.0 * rows_d[chains, up]        # S_du
             + 2.0 * jnp.take(b, down) - 2.0 * jnp.take(b, up))

    accept = 2.0 * delta > jnp.log(accept_u)   # |psi'|/|psi| > sqrt(u)
    proposed = s.at[chains, down].set(1.0)
    proposed = proposed.at[chains, up].set(-1.0)
    return SamplerState(
        configs=jnp.where(accept[:, None], proposed, s),
        log_amp=jnp.where(accept, state.log_amp + delta, state.log_amp),
        sign=state.sign,                        # Jastrow is positive
        keys=new_keys,
        num_accepted=state.num_accepted + accept.astype(jnp.float32),
        num_proposed=state.num_proposed + 1.0,
    )


@functools.partial(jax.jit, static_argnums=(0, 3))
def _run(wf: JastrowWavefunction, params: Params, state: SamplerState,
         num_steps: int) -> SamplerState:
    sym = JastrowWavefunction.symmetric_pair(params)
    b = params['onsite']['b']
    out = lax.fori_loop(0, num_steps, lambda _, st: _step(sym, b, st),
                        state)
    # Exact refresh: one full forward per CALL (not per step) pins the
    # cached log_amp to the forward pass, so incremental rounding can
    # never leak into acceptance decisions beyond a single call.
    amp = wf.apply(params, out.configs)
    return out._replace(log_amp=amp.log, sign=amp.sign)


def run_sweeps(wf, params: Params, state: SamplerState,
               num_sweeps: int) -> SamplerState:
    """Drop-in replacement for metropolis.run_sweeps on Jastrow ansatzes."""
    if not supports(wf):
        raise ValueError('fast_jastrow requires a plain JastrowWavefunction '
                         "with output_activation='exp'")
    if num_sweeps <= 0:
        return state
    n_sites = state.configs.shape[-1]
    return _run(wf, params, state, num_sweeps * n_sites)
