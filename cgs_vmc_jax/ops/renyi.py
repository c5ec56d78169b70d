"""Renyi-2 entanglement entropy via the swap-operator estimator.

NEW capability beyond the reference (which measures only the energy,
cgs_vmc/run_energy_evaluation.py): for a spatial region A,

    S2(A) = -log <SWAP_A>,
    <SWAP_A> = E_{x,y ~ |psi|^2} [ psi(y_A, x_B) psi(x_A, y_B)
                                   / (psi(x) psi(y)) ],

estimated over TWO independent replicas of the Markov chains (Hastings
et al., PRL 104, 157201 (2010)).  The amplitude ratio is evaluated in
log space (overflow-free) with one fused forward pass over both swapped
replicas.

Sector note: the framework samples in a fixed total-Sz sector; a swap
can move spin weight between A and B, producing configurations where
the true state has amplitude zero.  Those terms are zeroed explicitly
(`in_sector` mask) rather than trusting the ansatz to vanish off-sector.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from cgs_vmc_jax.models.base import Params, Wavefunction


def region_mask(num_sites: int, region: Sequence[int]) -> np.ndarray:
    # Host numpy, not device-resident (DEVELOPMENT.md constant rule).
    mask = np.zeros(num_sites, dtype=bool)
    mask[np.asarray(region, dtype=np.int64)] = True
    return mask


def swap_values(wf: Wavefunction, params: Params,
                configs_x: jax.Array, configs_y: jax.Array,
                mask: jax.Array) -> jax.Array:
    """Per-pair swap estimator values, [batch] (real)."""
    swapped_x = jnp.where(mask, configs_y, configs_x)  # (y_A, x_B)
    swapped_y = jnp.where(mask, configs_x, configs_y)  # (x_A, y_B)

    batch = configs_x.shape[0]
    amps = wf.apply(params, jnp.concatenate(
        [configs_x, configs_y, swapped_x, swapped_y], axis=0))
    a_x, a_y, a_sx, a_sy = (
        jax.tree.map(lambda v: v.reshape(4, batch)[i], amps)
        for i in range(4))

    log_ratio = a_sx.log + a_sy.log - a_x.log - a_y.log
    sign = a_sx.sign * a_sy.sign * a_x.sign * a_y.sign
    value = sign * jnp.exp(log_ratio)
    if jnp.iscomplexobj(value):
        # <SWAP> of a (generally complex) state is real and positive;
        # per-sample imaginary parts are estimator noise.
        value = jnp.real(value)

    # Swaps that change the region's total Sz leave the sampled sector:
    # the physical amplitude there is exactly zero.
    sz_ok = jnp.sum(jnp.where(mask, configs_x - configs_y, 0.0),
                    axis=-1) == 0
    return jnp.where(sz_ok, value, 0.0)


def evaluate_renyi2(
    wf: Wavefunction,
    params: Params,
    region: Sequence[int],
    config,
    key: Optional[jax.Array] = None,
) -> Tuple[float, float]:
    """MC estimate of (S2, standard error of <SWAP>-propagated error).

    Runs two independent replica samplers (different seeds), records
    `num_evaluation_samples` decorrelated batch means of the swap value.
    """
    from cgs_vmc_jax.evaluate import binned_error
    from cgs_vmc_jax.optim.common import make_sweeps_fn
    from cgs_vmc_jax.sampler import metropolis

    if key is None:
        key = jax.random.key(config.seed)
    key_x, key_y = jax.random.split(key)
    mask = region_mask(config.num_sites, region)
    sweeps_fn = make_sweeps_fn(wf, config)

    state_x = metropolis.init_sampler_for(key_x, wf, params, config)
    state_y = metropolis.init_sampler_for(key_y, wf, params, config)

    @jax.jit
    def run(sx, sy):
        sx = sweeps_fn(params, sx, config.num_equilibration_sweeps)
        sy = sweeps_fn(params, sy, config.num_equilibration_sweeps)

        def step(carry, _):
            sx, sy = carry
            value = jnp.mean(swap_values(wf, params, sx.configs,
                                         sy.configs, mask))
            sx = sweeps_fn(params, sx, config.num_monte_carlo_sweeps)
            sy = sweeps_fn(params, sy, config.num_monte_carlo_sweeps)
            return (sx, sy), value

        (sx, sy), values = jax.lax.scan(
            step, (sx, sy), None, length=config.num_evaluation_samples)
        return values

    values = np.asarray(run(state_x, state_y))
    swap_mean, swap_err = binned_error(values)
    s2 = -float(np.log(max(swap_mean, 1e-300)))
    # Error propagation: d(-log m) = dm / m.
    return s2, float(swap_err / max(swap_mean, 1e-300))


def exact_renyi2(vector: np.ndarray, states: np.ndarray,
                 region: Sequence[int]) -> float:
    """ED oracle: S2 = -log tr(rho_A^2) from a sector vector given in
    `states` (enumerate_sz_basis) order."""
    region = np.asarray(region, dtype=np.int64)
    n_sites = states.shape[1]
    rest = np.setdiff1d(np.arange(n_sites), region)

    def bits(cols):
        # spin +1 -> bit 1, spin -1 -> bit 0 packed over given columns.
        sub = (states[:, cols] > 0).astype(np.int64)
        return sub @ (1 << np.arange(len(cols))[::-1])

    idx_a, idx_b = bits(region), bits(rest)
    psi = np.zeros((2 ** len(region), 2 ** len(rest)), dtype=np.complex128)
    psi[idx_a, idx_b] = vector
    psi /= np.linalg.norm(psi)
    rho_a = psi @ psi.conj().T
    return -float(np.log(np.real(np.trace(rho_a @ rho_a))))
