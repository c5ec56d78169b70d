"""Fused RBM Metropolis exchange sweeps: a Pallas-Triton GPU kernel, the
same update as plain XLA, and the full-recompute oracle.

The hot-path sampler of SURVEY.md §7 stage 12.  For the classic RBM ansatz
(logψ(s) = a·s + Σ_h log cosh(s·W + b)_h — our RestrictedBoltzmannNetwork
with num_layers = 0) an exchange move of a down spin at site i with an up
spin at site j admits an O(H) incremental update:

    Δθ = 2 (W[i,:] − W[j,:]),
    Δlogψ = 2 (a_i − a_j) + Σ_h [logcosh(θ+Δθ) − logcosh(θ)]_h,

instead of the O(N·H) full forward pass the generic sampler pays per
proposal.

Proposal schedule: INDEPENDENT PER-CHAIN exchange moves with the
reference's pick semantics (cgs_vmc/graph_builders.py:59-65): each chain
independently exchanges one uniformly random −1 spin with one uniformly
random +1 spin each step (always Sz-conserving, always an active
proposal), accepted with |ψ'/ψ|² > u.  The picks are streamed as per-chain
RANKS (k-th down spin, k-th up spin, in site order) — configuration-
independent because exchange moves conserve the spin counts — and resolved
to sites with a carried cumulative down-spin count.  Chains share nothing,
so batch means carry no cross-chain covariance.

Randomness enters as explicit inputs (rank picks + acceptance uniforms
from `jax.random`), so every implementation here is a deterministic pure
function of the same inputs and bitwise comparable with the oracle.

Three implementations:
 * `rbm_sweeps`: the Pallas kernel (`backend='triton'`).  Each program
   owns a block of chains and runs every step of the call in registers:
   configs, cumulative counts, θ and logcosh(θ) never leave the program,
   and W's rows are gathered per chain (W is a few KB and stays in L1).
   The per-step cost is one dependent chain of a few hundred
   instructions, instead of several kernel launches per step.
 * `rbm_sweeps_xla`: the same update as `jnp` inside `lax.fori_loop`,
   left to XLA — the baseline the kernel is measured against (bench.py,
   chip_smoke.py); XLA pays several launches per dependent step.
 * `rbm_sweeps_reference`: full recompute per step (the test oracle).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# Chains per kernel program and warps per program, set by measurement on
# an H100 (PERF.md): each step is a latency-bound dependency chain, so
# few chains per warp and many programs in flight run fastest.
BLOCK_CHAINS = 1
NUM_WARPS = 1

_LOG2 = float(np.log(2.0))
_HIGHEST = lax.Precision.HIGHEST


def _log_cosh(x):
    ax = jnp.abs(x)
    return ax + jnp.log1p(jnp.exp(-2.0 * ax)) - _LOG2


class RbmSweepResult(NamedTuple):
    configs: jax.Array       # [chains, n_sites] updated spins
    theta: jax.Array         # [chains, hidden] θ = configs @ W + b
    log_amp: jax.Array       # [chains] logψ of the updated configs
    num_accepted: jax.Array  # [chains] accepted-move counts this call


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def _log_uniforms(key, n_steps, n_chains):
    return jnp.log(jax.random.uniform(key, (n_steps, n_chains), jnp.float32))


def _finish(w, b, a, configs, accepted) -> RbmSweepResult:
    """Caches recomputed from the final configs (one matmul per call)."""
    theta = jnp.matmul(configs, w, precision=_HIGHEST) + b
    log_amp = (jnp.matmul(configs, a, precision=_HIGHEST)
               + jnp.sum(_log_cosh(theta), axis=-1))
    return RbmSweepResult(configs, theta, log_amp, accepted)


def _exchange_step(carry, k_down, k_up, log_u, site, n_down, n_up,
                   gather_w, gather_a):
    """One per-chain exchange proposal + Metropolis accept on a block.

    carry = (cfg [c, s] ±1 (0 on padded sites), count [c, s] int32
    inclusive down-spin count along the sites, theta [c, h], lc =
    logcosh(theta), accepted [c]).  `gather_w(pos)` returns W[pos, :]
    ([c, h]) and `gather_a(pos)` returns a[pos] ([c]).
    """
    cfg, count, theta, lc, accepted = carry
    down = cfg < 0
    up = cfg > 0
    rank_down = count - down.astype(jnp.int32)    # exclusive down count
    rank_up = site - count                        # exclusive up count (ups)
    onehot_down = down & (rank_down == k_down[:, None])
    onehot_up = up & (rank_up == k_up[:, None])
    pos_down = jnp.sum(jnp.where(onehot_down, site, 0), axis=1)
    pos_up = jnp.sum(jnp.where(onehot_up, site, 0), axis=1)

    d_theta = 2.0 * (gather_w(pos_down) - gather_w(pos_up))
    theta_new = theta + d_theta
    lc_new = _log_cosh(theta_new)
    d_log = (2.0 * (gather_a(pos_down) - gather_a(pos_up))
             + jnp.sum(lc_new - lc, axis=1))
    # A rank beyond the chain's spin counts (another Sz sector, or a
    # padded chain) is a no-op instead of a single-spin flip.
    active = (k_down < n_down) & (k_up < n_up)
    acc = active & (2.0 * d_log > log_u)

    acc_col = acc[:, None]
    delta = 2.0 * (onehot_down.astype(jnp.float32)
                   - onehot_up.astype(jnp.float32))
    cfg = jnp.where(acc_col, cfg + delta, cfg)
    # A down spin moves from pos_down to pos_up: the inclusive count
    # shifts by +1 on sites >= pos_up and by -1 on sites >= pos_down.
    shift = ((site >= pos_up[:, None]).astype(jnp.int32)
             - (site >= pos_down[:, None]).astype(jnp.int32))
    count = jnp.where(acc_col, count + shift, count)
    theta = jnp.where(acc_col, theta_new, theta)
    lc = jnp.where(acc_col, lc_new, lc)
    accepted = accepted + acc.astype(jnp.float32)
    return cfg, count, theta, lc, accepted


def _spin_counts(cfg):
    down = cfg < 0
    n_down = jnp.sum(down.astype(jnp.int32), axis=1)
    n_up = jnp.sum((cfg > 0).astype(jnp.int32), axis=1)
    return jnp.cumsum(down.astype(jnp.int32), axis=1), n_down, n_up


def _sweep_kernel(cfg_ref, theta_ref, w_ref, a_ref, kd_ref, ku_ref,
                  logu_ref, out_cfg_ref, out_acc_ref):
    """One program = one block of chains, every step of the call.

    The next step's picks and uniforms are loaded at the top of each
    step, so their memory latency overlaps the step's arithmetic instead
    of heading its dependency chain.
    """
    n_steps = kd_ref.shape[0]
    cfg = cfg_ref[...]                           # [block, n_pad]
    theta = theta_ref[...]                       # [block, h_pad]
    site = lax.broadcasted_iota(jnp.int32, cfg.shape, 1)
    count, n_down, n_up = _spin_counts(cfg)

    def randomness(t):
        return kd_ref[t, :], ku_ref[t, :], logu_ref[t, :]

    def step(t, carry):
        state, (k_down, k_up, log_u) = carry
        upcoming = randomness(jnp.minimum(t + 1, n_steps - 1))
        state = _exchange_step(
            state, k_down, k_up, log_u, site, n_down, n_up,
            gather_w=lambda pos: w_ref[pos, :],
            gather_a=lambda pos: a_ref[pos])
        return state, upcoming

    init = ((cfg, count, theta, _log_cosh(theta),
             jnp.zeros(cfg.shape[:1], jnp.float32)), randomness(0))
    (cfg, _, _, _, accepted), _ = lax.fori_loop(0, n_steps, step, init)
    out_cfg_ref[...] = cfg
    out_acc_ref[...] = accepted


def _rbm_sweeps_pallas(w, b, a, configs, picks, key, *, block_chains,
                       interpret):
    n_chains, n_sites = configs.shape
    hidden = w.shape[1]
    n_steps = picks.shape[0]
    # Triton blocks are powers of two: pad sites and hidden units with
    # zeros (a 0 site is neither up nor down, a zero hidden unit adds
    # logcosh(0) − logcosh(0) = 0) and the chains to whole blocks
    # (all-zero chains have no spins, so every move is inactive).
    s_pad = _next_pow2(n_sites)
    h_pad = _next_pow2(hidden)
    c_pad = -(-n_chains // block_chains) * block_chains
    log_u = _log_uniforms(key, n_steps, n_chains)

    cfg_p = jnp.pad(configs.astype(jnp.float32),
                    ((0, c_pad - n_chains), (0, s_pad - n_sites)))
    w_p = jnp.pad(w, ((0, s_pad - n_sites), (0, h_pad - hidden)))
    b_p = jnp.pad(b, (0, h_pad - hidden))
    a_p = jnp.pad(a, (0, s_pad - n_sites))
    theta = jnp.matmul(cfg_p, w_p, precision=_HIGHEST) + b_p
    pad_c = ((0, 0), (0, c_pad - n_chains))
    kd = jnp.pad(picks[:, :, 0], pad_c)
    ku = jnp.pad(picks[:, :, 1], pad_c)
    log_u_p = jnp.pad(log_u, pad_c)

    chains = lambda i: (i, 0)
    steps = lambda i: (0, i)
    whole = lambda i: (0, 0)
    out_cfg, accepted = pl.pallas_call(
        _sweep_kernel,
        grid=(c_pad // block_chains,),
        in_specs=[
            pl.BlockSpec((block_chains, s_pad), chains),
            pl.BlockSpec((block_chains, h_pad), chains),
            pl.BlockSpec((s_pad, h_pad), whole),
            pl.BlockSpec((s_pad,), lambda i: (0,)),
            pl.BlockSpec((n_steps, block_chains), steps),
            pl.BlockSpec((n_steps, block_chains), steps),
            pl.BlockSpec((n_steps, block_chains), steps),
        ],
        out_specs=[
            pl.BlockSpec((block_chains, s_pad), chains),
            pl.BlockSpec((block_chains,), lambda i: (i,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((c_pad, s_pad), jnp.float32),
            jax.ShapeDtypeStruct((c_pad,), jnp.float32),
        ],
        backend='triton',
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name='rbm_exchange_sweeps',
    )(cfg_p, theta, w_p, a_p, kd, ku, log_u_p)
    return _finish(w, b, a, out_cfg[:n_chains, :n_sites],
                   accepted[:n_chains])


@functools.partial(jax.jit, static_argnames=('interpret',))
def rbm_sweeps(w: jax.Array, b: jax.Array, a: jax.Array,
               configs: jax.Array, picks: jax.Array, key: jax.Array,
               interpret: bool = False) -> RbmSweepResult:
    """Runs len(picks) fused per-chain exchange steps on all chains.

    Args:
      w: [n_sites, hidden] RBM kernel.
      b: [hidden] hidden bias.
      a: [n_sites] visible (on-site) bias.
      configs: [chains, n_sites] ±1 float32.
      picks: [n_steps, chains, 2] int32 per-chain (k_down, k_up) rank
        picks from `sample_picks` — chain c exchanges its k_down-th −1
        spin with its k_up-th +1 spin at each step.
      key: PRNG key for per-chain acceptance uniforms.
      interpret: run the kernel under the Pallas interpreter (CPU tests).

    Returns RbmSweepResult with updated state and per-chain accept counts.
    """
    return _rbm_sweeps_pallas(w, b, a, configs, picks, key,
                              block_chains=BLOCK_CHAINS, interpret=interpret)


@jax.jit
def rbm_sweeps_xla(w, b, a, configs, picks, key) -> RbmSweepResult:
    """`rbm_sweeps`' update as plain `jnp` in a `lax.fori_loop` (same
    arguments and result; the kernel's measured baseline)."""
    n_chains, n_sites = configs.shape
    n_steps = picks.shape[0]
    log_u = _log_uniforms(key, n_steps, n_chains)
    site = lax.broadcasted_iota(jnp.int32, configs.shape, 1)
    count, n_down, n_up = _spin_counts(configs)
    theta = jnp.matmul(configs, w, precision=_HIGHEST) + b

    def step(t, carry):
        return _exchange_step(
            carry, picks[t, :, 0], picks[t, :, 1], log_u[t], site,
            n_down, n_up,
            gather_w=lambda pos: jnp.take(w, pos, axis=0),
            gather_a=lambda pos: jnp.take(a, pos))

    init = (configs, count, theta, _log_cosh(theta),
            jnp.zeros((n_chains,), jnp.float32))
    cfg, _, _, _, accepted = lax.fori_loop(0, n_steps, step, init)
    return _finish(w, b, a, cfg, accepted)


def rbm_sweeps_reference(w, b, a, configs, picks, key) -> RbmSweepResult:
    """Pure-JAX implementation of the same per-chain rank-pick semantics
    (full recompute per step, every matmul at HIGHEST precision) — the
    correctness oracle for the incremental paths.  Consumes the SAME picks
    and uniforms, so results are bitwise comparable up to float
    associativity."""
    n_steps = picks.shape[0]
    n_chains, n_sites = configs.shape
    log_u = _log_uniforms(key, n_steps, n_chains)

    def log_psi(c):
        theta = jnp.matmul(c, w, precision=_HIGHEST) + b
        return (jnp.matmul(c, a, precision=_HIGHEST)
                + jnp.sum(_log_cosh(theta), axis=-1))

    def step(carry, inputs):
        configs, accepted = carry
        pick, log_u_t = inputs
        down = (configs < 0)
        rank_down = jnp.cumsum(down, axis=1) - down
        rank_up = jnp.cumsum(~down, axis=1) - ~down
        onehot_down = down & (rank_down == pick[:, 0][:, None])
        onehot_up = ~down & (rank_up == pick[:, 1][:, None])
        delta = 2.0 * (onehot_down.astype(jnp.float32)
                       - onehot_up.astype(jnp.float32))
        proposed = configs + delta
        d_log = log_psi(proposed) - log_psi(configs)
        active = onehot_down.any(axis=1) & onehot_up.any(axis=1)
        accept = active & (2.0 * d_log > log_u_t)
        configs = jnp.where(accept[:, None], proposed, configs)
        accepted = accepted + accept.astype(jnp.float32)
        return (configs, accepted), None

    init = (configs, jnp.zeros((n_chains,), jnp.float32))
    (configs, accepted), _ = lax.scan(step, init, (picks, log_u))
    return _finish(w, b, a, configs, accepted)


def sample_picks(key: jax.Array, num_steps: int, n_sites: int,
                 n_chains: int) -> jax.Array:
    """Per-chain (k_down, k_up) rank picks, [num_steps, n_chains, 2] i32.

    In the Sz = 0 sector every configuration has exactly n_sites//2 down
    and n_sites − n_sites//2 up spins (exchange moves conserve both), so
    a uniform rank is a uniform pick of a down/up SITE regardless of the
    configuration — the reference's noise-weighted argmin/argmax pick
    (cgs_vmc/graph_builders.py:59-65) in streamable form.
    """
    key_d, key_u = jax.random.split(key)
    n_down = n_sites // 2
    n_up = n_sites - n_down
    kd = jax.random.randint(key_d, (num_steps, n_chains), 0, n_down)
    ku = jax.random.randint(key_u, (num_steps, n_chains), 0, n_up)
    return jnp.stack([kd, ku], axis=-1).astype(jnp.int32)
