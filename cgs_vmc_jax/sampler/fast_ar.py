"""Exact-draw 'sweeps' adapter for autoregressive ansatzes.

Replaces Metropolis sweeps with fresh ancestral samples: every call
draws one i.i.d. configuration per chain directly from |psi|^2
(models/autoregressive.py), so `num_sweeps` is irrelevant — there is no
chain to decorrelate — and the entire equilibration/decorrelation
machinery of the epoch loops degenerates to exact sampling for free.
Acceptance counters advance by one accepted "move" per call so the
acceptance-rate metric reads 1.0 (the exact-sampler signature).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cgs_vmc_jax.models.autoregressive import AutoregressiveSpinModel
from cgs_vmc_jax.models.base import Params
from cgs_vmc_jax.models.complex_phase import ComplexPhaseWavefunction
from cgs_vmc_jax.sampler.metropolis import SamplerState


def _ar_part(wf):
    """(ar_model, params_subtree_fn) when `wf` admits exact draws.

    Two shapes qualify: a bare AutoregressiveSpinModel, and a
    ComplexPhaseWavefunction whose MODULUS is autoregressive — since
    |psi|^2 = exp(2*Re log) = exp(2*log_modulus), ancestral draws from
    the modulus sample the full complex state exactly (MCMC-free
    frustrated VMC: the phase network never enters the sampler)."""
    if isinstance(wf, AutoregressiveSpinModel):
        return wf, lambda p: p
    if (isinstance(wf, ComplexPhaseWavefunction)
            and isinstance(wf._modulus, AutoregressiveSpinModel)):
        return wf._modulus, lambda p: p['modulus']
    return None, None


def supports(wf) -> bool:
    return _ar_part(wf)[0] is not None


def run_sweeps(wf, params: Params, state: SamplerState,
               num_sweeps: int) -> SamplerState:
    """One exact |psi|^2 draw per chain (num_sweeps ignored — i.i.d.)."""
    ar, sub = _ar_part(wf)
    if ar is None:
        raise ValueError('fast_ar requires an AutoregressiveSpinModel '
                         '(bare or as the modulus of a complex-phase '
                         'wavefunction)')
    # NOTE: no num_sweeps <= 0 shortcut — a fresh i.i.d. draw is always
    # correct and free, and the epoch loops call sweeps(...,
    # num_monte_carlo_sweeps) BETWEEN batch collections: returning the
    # state unchanged there would silently duplicate batches when a user
    # sets the (irrelevant-for-AR) sweep counts to zero.

    def split_one(k):
        nxt, draw = jax.random.split(k)
        return nxt, draw

    new_keys, draw_keys = jax.vmap(split_one)(state.keys)
    configs = ar.sample(sub(params), draw_keys)
    amp = wf.apply(params, configs)
    return SamplerState(
        configs=configs,
        log_amp=amp.log,
        sign=amp.sign,
        keys=new_keys,
        num_accepted=state.num_accepted + 1.0,
        num_proposed=state.num_proposed + 1.0,
    )
