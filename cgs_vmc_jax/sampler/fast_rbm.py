"""High-level adapter: fused exchange sweeps for pure-RBM wavefunctions.

Bridges the generic SamplerState world (sampler/metropolis.py) and the
incremental sweep implementations (sampler/kernels.py).  Applicable when
the ansatz is a RestrictedBoltzmannNetwork with num_layers == 0 (the
classic NQS RBM) — exactly the regime where the O(hidden) incremental
update beats the generic full-forward sampler by ~n_sites×.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cgs_vmc_jax.models.base import Params
from cgs_vmc_jax.models.feedforward import RestrictedBoltzmannNetwork
from cgs_vmc_jax.sampler import kernels
from cgs_vmc_jax.sampler.metropolis import advance_chain_keys, SamplerState


def supports(wf) -> bool:
    """True when `wf` admits the fused kernel (pure RBM, no feature MLP)."""
    return (isinstance(wf, RestrictedBoltzmannNetwork)
            and wf.num_layers == 0)


def _unpack(params: Params):
    w = params['hidden']['w']            # [n_sites, hidden]
    b = params['hidden']['b']            # [hidden]
    a = params['onsite']['w'][:, 0]      # [n_sites]
    return w, b, a


def run_sweeps(wf, params: Params, state: SamplerState, num_sweeps: int,
               sweeps_fn=kernels.rbm_sweeps) -> SamplerState:
    """Drop-in replacement for metropolis.run_sweeps on pure-RBM ansatzes.

    One sweep = n_sites independent per-chain exchange proposals with the
    reference's down×up pick semantics (see kernels.py).  The visible bias
    `b` of the onsite head contributes a configuration-independent constant
    (Sz is conserved) and is folded into log_amp exactly.

    sweeps_fn: one of kernels.rbm_sweeps (the compiled GPU kernel, the
    default), kernels.rbm_sweeps_xla, or the kernel under the Pallas
    interpreter (tests).
    """
    if not supports(wf):
        raise ValueError('fast_rbm sampler requires a pure RBM '
                         '(RestrictedBoltzmannNetwork with num_layers=0)')
    if num_sweeps <= 0:
        return state
    n_chains, n_sites = state.configs.shape
    # kernels.sample_picks draws down-spin ranks in [0, n_sites//2): the
    # proposal distribution is uniform ONLY in the half-filled Sz=0 sector
    # (off-sector use would silently bias detailed balance — down spins at
    # rank >= n_sites//2 would never be proposed).
    if n_sites % 2:
        raise ValueError(
            f'fast_rbm sampler requires the half-filled Sz=0 sector; '
            f'n_sites={n_sites} is odd')
    if not isinstance(state.configs, jax.core.Tracer):
        sz = jax.device_get(jnp.sum(state.configs, axis=1))
        if (sz != 0).any():
            raise ValueError(
                'fast_rbm sampler requires Sz=0 chains (half up, half '
                f'down); got per-chain Sz {sorted(set(sz.tolist()))}')
    w, b, a = _unpack(params)

    k_picks, k_accept, k_next = jax.random.split(state.keys[0], 3)
    picks = kernels.sample_picks(k_picks, num_sweeps * n_sites, n_sites,
                                 n_chains)
    out = sweeps_fn(w, b, a, state.configs, picks, k_accept)

    # The onsite head's scalar bias adds a constant to every logψ; the
    # kernel tracks configs@a + Σ logcosh, so add it back here so the
    # cache matches wf.apply exactly.
    onsite_bias = params['onsite']['b'][0]
    new_keys = advance_chain_keys(state.keys, k_next)
    return SamplerState(
        configs=out.configs,
        log_amp=out.log_amp + onsite_bias,
        sign=jnp.ones_like(out.log_amp),
        keys=new_keys,
        num_accepted=state.num_accepted + out.num_accepted,
        num_proposed=state.num_proposed + float(num_sweeps * n_sites),
    )
