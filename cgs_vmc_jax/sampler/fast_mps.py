"""Incremental MPS sampler: environment-cached adjacent-exchange sweeps.

The generic sampler pays a full O(N·D²) chain contraction per proposal;
for an MPS the standard fast move set is a SEQUENTIAL sweep of adjacent
exchanges with cached environments (the sampling analog of a DMRG sweep):

 * one right-to-left scan per sweep caches every suffix environment
   S_k = M_k(s_k)·…·last(s_{N-1})  (normalized per step; normalizations
   cancel in ratios),
 * a left-to-right march proposes exchanging (k, k+1) at each bond,
   evaluating BOTH the current and swapped local amplitude as
   L · M_k · M_{k+1} · S_{k+2} — O(D²) per proposal — and extends the
   prefix L with the (possibly updated) site matrix.

Per sweep: O(N·D²) total instead of the generic path's O(N²·D²)
(SURVEY.md §7 hard-parts "plan the delta fast path"; VERDICT round-1
item 4: MPS admits environment caching).

MOVE-SET NOTE: adjacent exchanges in a fixed order are Sz-conserving and
ergodic in the sector (adjacent transpositions generate S_N), and each
bond update is a valid Metropolis kernel for |ψ|² (symmetric proposal,
acceptance |ψ'/ψ|² > u), so the scan composition preserves the Born
distribution.  The MIXING profile differs from the reference's global
down×up exchange (local diffusion vs long-range swaps), so this sampler
is OPT-IN via ``config.mps_incremental_sweeps`` rather than an automatic
dispatch.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from cgs_vmc_jax.models.base import Params
from cgs_vmc_jax.models.mps import MatrixProductState
from cgs_vmc_jax.sampler.metropolis import advance_chain_keys, SamplerState


def supports(wf) -> bool:
    return isinstance(wf, MatrixProductState)


def _normalize(v: jax.Array) -> jax.Array:
    """Max-abs row normalization (scale cancels in same-bond ratios)."""
    norm = jnp.max(jnp.abs(v), axis=-1, keepdims=True)
    return v / jnp.where(norm > 0, norm, 1.0)


def _spin_idx(configs: jax.Array, k) -> jax.Array:
    s = lax.dynamic_slice_in_dim(configs, k, 1, axis=1)[:, 0]
    return ((s + 1.0) / 2.0).astype(jnp.int32)


def _suffix_envs(params: Params, configs: jax.Array) -> jax.Array:
    """S[k] for k = 2..N-1 packed as [N-2, B, D]: S[N-1] = last(s_{N-1}),
    S[k] = mid_{k}(s_k) · S[k+1] (normalized).  Index convention: the
    returned array at position k-2 holds S_k."""
    n = configs.shape[1]
    spin = ((configs + 1.0) / 2.0).astype(jnp.int32)      # [B, N]
    s_last = params['last'][spin[:, -1]]                  # [B, D]

    def step(s_env, inputs):
        site_tensor, idx = inputs
        mats = site_tensor[idx]                           # [B, D, D]
        s_env = _normalize(jnp.einsum(
            'bde,be->bd', mats, s_env,
            preferred_element_type=jnp.float32))
        return s_env, s_env

    # Middle sites k = N-2 .. 2 (mid tensor index k-1 = N-3 .. 1).
    xs = {'site_tensor': params['mid'][1:][::-1],
          'idx': spin[:, 2:-1].T[::-1]}
    _, envs_rev = lax.scan(step, _normalize(s_last),
                           (xs['site_tensor'], xs['idx']))
    # envs_rev[j] = S_{N-2-j} for j = 0..N-4; append S_{N-1} and reorder
    # to S_2..S_{N-1}.
    envs = jnp.concatenate(
        [envs_rev[::-1], _normalize(s_last)[None]], axis=0)
    return envs                                           # [N-2, B, D]


def run_sweeps(wf, params: Params, state: SamplerState, num_sweeps: int
               ) -> SamplerState:
    """Drop-in replacement for metropolis.run_sweeps on MPS ansatzes."""
    if not supports(wf):
        raise ValueError('fast_mps sampler requires a MatrixProductState')
    if num_sweeps <= 0:
        return state
    n_chains, n_sites = state.configs.shape
    first, mid, last = params['first'], params['mid'], params['last']

    key0 = state.keys[0]
    k_u, k_next = jax.random.split(key0)
    u_all = jax.random.uniform(
        k_u, (num_sweeps, n_sites - 1, n_chains), jnp.float32)

    def bond_update(carry, inputs):
        """Propose exchanging spins at (k, k+1); L is the prefix row
        vector BEFORE site k (for k = 0 the 'prefix' applies first[s])."""
        configs, left, accepted, proposed = carry
        k, s_env, u = inputs                # S_{k+2} ([B, D]) and uniforms
        idx_k = _spin_idx(configs, k)
        idx_k1 = _spin_idx(configs, k + 1)

        is_first = k == 0
        is_last_bond = k + 1 == n_sites - 1

        def site_k_apply(l_vec, spin_idx):
            # Applies site k's tensor to the running prefix (site 0 is the
            # boundary vector; mid index is clamped out of the dead branch).
            return jnp.where(
                is_first,
                first[spin_idx],
                jnp.einsum('bd,bde->be',
                           l_vec, mid[jnp.maximum(k - 1, 0)][spin_idx],
                           preferred_element_type=jnp.float32))

        def through(first_spin, second_spin):
            v = site_k_apply(left, first_spin)               # after site k
            v2 = jnp.where(
                is_last_bond,
                v * last[second_spin],
                jnp.einsum('bd,bde->be', v,
                           mid[jnp.minimum(k, mid.shape[0] - 1)][second_spin],
                           preferred_element_type=jnp.float32))
            # Contract with the suffix environment (S_{k+2}); at the last
            # bond `v2` already absorbed `last` elementwise and s_env is a
            # dummy of ones.
            return jnp.sum(v2 * s_env, axis=-1)              # [B]

        cur = through(idx_k, idx_k1)
        new = through(idx_k1, idx_k)
        active = (idx_k != idx_k1)
        accept = jnp.logical_and(active, new * new > u * cur * cur)

        s_k = lax.dynamic_slice_in_dim(configs, k, 1, axis=1)[:, 0]
        s_k1 = lax.dynamic_slice_in_dim(configs, k + 1, 1, axis=1)[:, 0]
        accf = accept.astype(configs.dtype)
        new_k = s_k + accf * (s_k1 - s_k)
        new_k1 = s_k1 + accf * (s_k - s_k1)
        configs = lax.dynamic_update_slice_in_dim(
            configs, new_k[:, None], k, axis=1)
        configs = lax.dynamic_update_slice_in_dim(
            configs, new_k1[:, None], k + 1, axis=1)

        # Extend the prefix through site k with its FINAL spin.
        left = _normalize(site_k_apply(left, _spin_idx(configs, k)))
        # Count only ACTIVE proposals (antiparallel bonds): parallel-spin
        # bonds are no-ops here, while the generic/fast_rbm samplers'
        # down×up proposals are always active — counting the no-ops would
        # make acceptance rates incomparable across samplers (round-2
        # advisor finding).
        return (configs, left, accepted + accf,
                proposed + active.astype(configs.dtype)), None

    def sweep(carry, u_sweep):
        configs, accepted, proposed = carry
        envs = _suffix_envs(params, configs)          # S_2..S_{N-1}
        # Bond k uses S_{k+2}: envs[k] for k = 0..N-3; the last bond
        # (k = N-2) contracts `last` elementwise, so feed ones.
        s_env_per_bond = jnp.concatenate(
            [envs, jnp.ones((1, n_chains, envs.shape[-1]), jnp.float32)],
            axis=0)
        ks = jnp.arange(n_sites - 1)
        left0 = jnp.ones((n_chains, first.shape[-1]), jnp.float32)
        (configs, _, accepted, proposed), _ = lax.scan(
            bond_update, (configs, left0, accepted, proposed),
            (ks, s_env_per_bond, u_sweep))
        return (configs, accepted, proposed), None

    (configs, accepted, proposed), _ = lax.scan(
        sweep, (state.configs, jnp.zeros(n_chains, jnp.float32),
                jnp.zeros(n_chains, jnp.float32)), u_all)

    amp = wf.apply(params, configs)
    new_keys = advance_chain_keys(state.keys, k_next)
    return SamplerState(
        configs=configs,
        log_amp=amp.log,
        sign=amp.sign,
        keys=new_keys,
        num_accepted=state.num_accepted + accepted,
        num_proposed=state.num_proposed + proposed,
    )
