"""Incremental determinant sampler: Sherman–Morrison exchange moves for
the projected-BDG pairing ansatz.

The generic sampler pays a full batched `slogdet` of the [B, n/2, n/2]
pairing submatrix per proposal (O(h³) LU per chain per move, a serial
row elimination).  An exchange move replaces
ONE row and ONE column of the submatrix, so with the inverse cached the
amplitude ratio is two rank-1 determinant-lemma evaluations and the cache
update two rank-1 Sherman–Morrison corrections — O(h²) of dense vector and
matrix work per move (SURVEY.md §7 hard-parts: "plan the ansatz API with an
optional delta fast path"; VERDICT round-1 item 4).

Bookkeeping: row slot r of the cached matrix M holds pairing[up_sites[r], ·]
and column slot c holds pairing[·, down_sites[c]] in ARBITRARY (insertion)
order — |det| is permutation-invariant, and Metropolis only needs |ratio|,
so no sorted-order maintenance (and no permutation signs) is required.
The exact signed amplitude is recomputed once at the end of the call with
the ansatz's full `apply` (sorted gathers + slogdet), which also removes
all accumulated f32 drift.  The inverse cache is rebuilt from scratch once
per sweep, bounding both rounding drift and the blast radius of a
near-singular intermediate update.

Move semantics match the reference exactly (cgs_vmc/graph_builders.py:59-65
via our metropolis._propose_exchange): one uniformly random up spin
exchanged with one uniformly random down spin per chain per step, accepted
with |ψ'/ψ|² > u.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from cgs_vmc_jax.models.base import Params
from cgs_vmc_jax.models.determinant import ProjectedBDG
from cgs_vmc_jax.sampler.metropolis import advance_chain_keys, SamplerState


def supports(wf) -> bool:
    """True when `wf` admits the incremental determinant fast path."""
    return isinstance(wf, ProjectedBDG)


def _build_cache(pairing: jax.Array, configs: jax.Array):
    """(up_sites, down_sites, inv) for the current configs.

    M[b, r, c] = pairing[up_sites[b, r], down_sites[b, c]]; inv = M^{-1}.
    """
    half = configs.shape[-1] // 2
    up_sites = jnp.argsort(-configs, axis=-1, stable=True)[:, :half]
    down_sites = jnp.argsort(configs, axis=-1, stable=True)[:, :half]
    rows = pairing[up_sites]                                   # [B, h, n]
    m = jnp.take_along_axis(rows, down_sites[:, None, :], axis=2)
    return up_sites, down_sites, jnp.linalg.inv(m)


def run_sweeps(wf, params: Params, state: SamplerState, num_sweeps: int
               ) -> SamplerState:
    """Drop-in replacement for metropolis.run_sweeps on ProjectedBDG."""
    if not supports(wf):
        raise ValueError('fast_pbdg sampler requires a ProjectedBDG ansatz')
    if num_sweeps <= 0:
        return state
    n_chains, n_sites = state.configs.shape
    half = n_sites // 2
    pairing = params['pairing']                                # [n, n]
    steps_per_sweep = n_sites

    key0 = state.keys[0]
    k_r, k_c, k_u, k_next = jax.random.split(key0, 4)
    shape = (num_sweeps, steps_per_sweep, n_chains)
    r_all = jax.random.randint(k_r, shape, 0, half)
    c_all = jax.random.randint(k_c, shape, 0, half)
    u_all = jax.random.uniform(k_u, shape, jnp.float32)

    slot_iota = jnp.arange(half)[None, :]                      # [1, h]
    site_iota = jnp.arange(n_sites)[None, :]                   # [1, n]
    chain_idx = jnp.arange(n_chains)

    def mc_step(carry, inputs):
        configs, up_sites, down_sites, inv, accepted = carry
        r, c, u = inputs                                       # [B] each
        i = up_sites[chain_idx, r]                             # up site out
        j = down_sites[chain_idx, c]                           # down site in

        # --- row replacement at slot r: new row u_r[k] = pairing[j, dn_k].
        new_row = jnp.take_along_axis(pairing[j], down_sites, axis=1)
        inv_col_r = inv[chain_idx, :, r]                       # A⁻¹ e_r
        ratio1 = jnp.sum(new_row * inv_col_r, axis=-1)         # uᵀA⁻¹e_r
        w = jnp.einsum('bk,bkm->bm', new_row, inv,
                       preferred_element_type=jnp.float32)
        w = w - (slot_iota == r[:, None])                      # uᵀA⁻¹ − e_rᵀ
        safe1 = jnp.where(jnp.abs(ratio1) > 1e-30, ratio1, 1.0)
        inv1 = inv - inv_col_r[:, :, None] * (w / safe1[:, None])[:, None, :]

        # --- column replacement at slot c: v[k] = pairing[up'_k, i] with
        # up' slot r already holding j.
        v = jnp.take_along_axis(pairing[:, i].T, up_sites, axis=1)
        v = jnp.where(slot_iota == r[:, None], pairing[j, i][:, None], v)
        inv1_v = jnp.einsum('brc,bc->br', inv1, v,
                            preferred_element_type=jnp.float32)
        ratio2 = inv1_v[chain_idx, c]                          # (A₁⁻¹v)_c
        z = inv1_v - (slot_iota == c[:, None])
        inv1_row_c = inv1[chain_idx, c, :]
        safe2 = jnp.where(jnp.abs(ratio2) > 1e-30, ratio2, 1.0)
        inv2 = inv1 - z[:, :, None] * (
            inv1_row_c / safe2[:, None])[:, None, :]

        ratio = ratio1 * ratio2                                # det M'/det M
        # |ψ'/ψ|² > u, guarded against a numerically singular intermediate
        # (treated as a rejection; the per-sweep cache rebuild re-syncs).
        # Known measure-zero bias (round-2 advisor): a move whose
        # intermediate row-replacement ratio underflows |ratio1| <= 1e-30
        # is rejected even if the full rank-2 ratio would pass — an
        # ordering artifact of the two sequential rank-1 updates.  At f32
        # the guarded set has effectively zero Born weight (the sampler's
        # Born-distribution test bounds any residual bias).
        acc = jnp.logical_and(ratio * ratio > u,
                              jnp.isfinite(ratio))
        acc = jnp.logical_and(acc, jnp.abs(ratio1) > 1e-30)
        accf = acc.astype(jnp.float32)

        inv = jnp.where(acc[:, None, None], inv2, inv)
        up_sites = jnp.where(
            acc[:, None] & (slot_iota == r[:, None]), j[:, None], up_sites)
        down_sites = jnp.where(
            acc[:, None] & (slot_iota == c[:, None]), i[:, None], down_sites)
        flip = (2.0 * (site_iota == j[:, None])
                - 2.0 * (site_iota == i[:, None])).astype(configs.dtype)
        configs = configs + accf[:, None] * flip
        return (configs, up_sites, down_sites, inv, accepted + accf), None

    def sweep(carry, inputs):
        configs, accepted = carry
        r_s, c_s, u_s = inputs                  # [steps, B] each
        # Fresh cache each sweep: one batched inverse amortized over
        # n_sites O(h²) incremental moves.
        up_sites, down_sites, inv = _build_cache(pairing, configs)
        (configs, _, _, _, accepted), _ = lax.scan(
            mc_step, (configs, up_sites, down_sites, inv, accepted),
            (r_s, c_s, u_s))
        return (configs, accepted), None

    (configs, accepted), _ = lax.scan(
        sweep, (state.configs, jnp.zeros(n_chains, jnp.float32)),
        (r_all, c_all, u_all))

    # Exact signed amplitudes from the ansatz's own forward (also clears
    # incremental-update drift before any estimator consumes the cache).
    amp = wf.apply(params, configs)
    new_keys = advance_chain_keys(state.keys, k_next)
    proposed = float(num_sweeps * steps_per_sweep)
    return SamplerState(
        configs=configs,
        log_amp=amp.log,
        sign=amp.sign,
        keys=new_keys,
        num_accepted=state.num_accepted + accepted,
        num_proposed=state.num_proposed + proposed,
    )
