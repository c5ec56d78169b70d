"""Time-dependent variational Monte Carlo (t-VMC / TDVP).

NEW capability beyond the reference (whose optimizer registry is purely
ground-state/supervised, cgs_vmc/training.py:913-925): evolves the
variational state under the time-dependent variational principle

    S(theta) theta_dot = f,     S = Re<O* O>_c   (the quantum metric),

with  O_k = d log psi / d theta_k  and the force

    imaginary time:  f = -Re<O* (E_loc - <E>)>      (energy descent ==
                                                     the SR flow),
    real time:       f = +Im<O* (E_loc - <E>)>      (unitary dynamics;
                                                     needs a complex-log
                                                     ansatz).

(Real-time sign fixed by the one-parameter oracle psi = e^{i*theta*g}psi0:
the optimal theta_dot<g^2> = -<g Re E_loc> = +Im<O* eps> with O = i*g.)

Solve: the same sample-space push-through as dense SR
(optim/sr.py) — with a complex log, stacking the real/imaginary Jacobian
halves J = [O_re; O_im] makes S = J^T W J, and BOTH forces are J^T
against a stacked residual:

    Re<O* eps>  -> J^T [w*eps_re; w*eps_im]
    Im<O* eps>  -> J^T [w*eps_im; -w*eps_re]   (O* flips O_im's sign)

so real- and imaginary-time steps share one [2M, 2M] Cholesky solve
structure.  `weights` generalizes the 1/M Monte Carlo measure to
arbitrary probabilities — used by the exactness tests to run TDVP on the
full basis, where a complete (modulus, phase) parameterization must
reproduce exact Schrodinger dynamics.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import jax
import jax.flatten_util
import jax.numpy as jnp
from jax import lax

from cgs_vmc_jax.models.base import Params, Wavefunction
from cgs_vmc_jax.ops.heisenberg import Operator
from cgs_vmc_jax.optim import common
from cgs_vmc_jax.sampler import metropolis


def tdvp_direction(
    wf: Wavefunction,
    params: Params,
    configs: jax.Array,
    e_loc: jax.Array,
    mode: str = 'real',
    diag_shift: float = 1e-4,
    weights: Optional[jax.Array] = None,
) -> Tuple[Params, jax.Array, jax.Array]:
    """Solves S theta_dot = f; returns (theta_dot pytree, <E_loc>, r2).

    mode: 'real' (unitary dynamics, complex-log ansatz required) or
    'imag' (normalized imaginary-time flow — the natural-gradient /
    SR descent direction, valid for real ansatzes too).

    r2 is the McLachlan residual distance ||sum_k theta_dot_k O_k psi -
    psi_dot_exact||^2 / ||psi||^2 = <|eps|^2> - theta_dot·f at the
    solution — the per-unit-time rate at which the variational manifold
    fails to capture the exact flow (0 for a complete parameterization).
    """
    if mode not in ('real', 'imag'):
        raise ValueError(f"mode must be 'real' or 'imag', got {mode!r}")
    m = configs.shape[0]
    if weights is None:
        weights = jnp.full(m, 1.0 / m, jnp.float32)
    flat_params, unravel = jax.flatten_util.ravel_pytree(params)
    is_complex = jnp.iscomplexobj(e_loc)
    if mode == 'real' and not is_complex:
        raise ValueError(
            'Real-time TDVP needs a complex-log ansatz: a real '
            'wavefunction cannot acquire the phases unitary dynamics '
            "produces (use wavefunction_type='complex').")

    def single_log(p_flat, config):
        return wf.apply(unravel(p_flat), config[None, :]).log[0]

    def weighted_center(rows):
        return rows - jnp.sum(weights[:, None] * rows, axis=0,
                              keepdims=True)

    sqrt_w = jnp.sqrt(weights)
    e_mean = jnp.sum(weights * e_loc)
    eps = e_loc - e_mean
    if is_complex:
        jac_re = jax.vmap(jax.grad(lambda p, c: single_log(p, c).real),
                          in_axes=(None, 0))(flat_params, configs)
        jac_im = jax.vmap(jax.grad(lambda p, c: single_log(p, c).imag),
                          in_axes=(None, 0))(flat_params, configs)
        jac = jnp.concatenate([sqrt_w[:, None] * weighted_center(jac_re),
                               sqrt_w[:, None] * weighted_center(jac_im)],
                              axis=0)                        # [2M, P]
        if mode == 'real':
            # f = +Im<O* eps> = <O_re eps_im> - <O_im eps_re>.
            resid = jnp.concatenate([sqrt_w * jnp.imag(eps),
                                     -sqrt_w * jnp.real(eps)])
        else:
            # f = -Re<O* eps> = -(<O_re eps_re> + <O_im eps_im>).
            resid = jnp.concatenate([-sqrt_w * jnp.real(eps),
                                     -sqrt_w * jnp.imag(eps)])
    else:
        rows = jax.vmap(jax.grad(single_log), in_axes=(None, 0))(
            flat_params, configs)
        jac = sqrt_w[:, None] * weighted_center(rows)        # [M, P]
        resid = -sqrt_w * eps                                # imag mode

    # Push-through sample-space solve (see optim/sr.py::_dense_solve):
    # theta_dot = (J^T J + eps I_P)^-1 J^T r = J^T (J J^T + eps I)^-1 r.
    n_rows = jac.shape[0]
    with jax.default_matmul_precision('highest'):
        t_matrix = jac @ jac.T
        diag_scale = jnp.mean(jnp.diagonal(t_matrix)) + 1e-30
        t_matrix = t_matrix + (diag_shift * diag_scale) * jnp.eye(
            n_rows, dtype=t_matrix.dtype)
        y = jax.scipy.linalg.solve(t_matrix, resid, assume_a='pos')
        theta_dot_flat = jac.T @ y
        # McLachlan distance: <|eps|^2> - theta_dot·f  (f = J^T resid).
        eps2 = jnp.sum(weights * jnp.abs(eps) ** 2)
        r2 = eps2 - theta_dot_flat @ (jac.T @ resid)
    return unravel(theta_dot_flat), e_mean, jnp.maximum(r2, 0.0)


class TimeEvolution:
    """Drives t-VMC: sample, solve the TDVP system, integrate.

    Integrators: 'euler' (one direction solve per step) and 'heun'
    (midpoint correction reusing the same sample set — second-order in
    dt at one extra solve, the standard t-VMC compromise).
    """

    name = 'TVMC'

    def __init__(self, wf: Wavefunction, hamiltonian: Operator, config,
                 dt: float, mode: str = 'real',
                 integrator: str = 'heun',
                 adaptive_tol: float = 0.0):
        """adaptive_tol > 0 enables step-size control: the Heun embedded
        error ||k2 - k1||·dt/2 (relative to ||k1||·dt) is driven toward
        the tolerance, dt rescaled by clip(sqrt(tol/err), 0.5, 1.5) per
        step.  dt is a traced argument of the compiled step, so
        adaptation never recompiles."""
        if integrator not in ('euler', 'heun'):
            raise ValueError(f'Unknown integrator {integrator!r}')
        if adaptive_tol and integrator != 'heun':
            raise ValueError('adaptive_tol requires the heun integrator '
                             '(the embedded error estimate)')
        self.wf = wf
        self.hamiltonian = hamiltonian
        self.config = config
        self.dt = float(dt)
        self.mode = mode
        self.integrator = integrator
        self.adaptive_tol = float(adaptive_tol)
        self.sweeps = common.make_sweeps_fn(wf, config)

    def init_state(self, key: jax.Array, params: Params
                   ) -> metropolis.SamplerState:
        return metropolis.init_sampler_for(
            key, self.wf, params, self.config)

    def step(self, params: Params, sampler: metropolis.SamplerState,
             dt: Optional[jax.Array] = None
             ) -> Tuple[Params, metropolis.SamplerState,
                        Dict[str, jax.Array]]:
        """One dt of evolution: decorrelate, solve, integrate."""
        cfg = self.config
        wf, ham = self.wf, self.hamiltonian
        if dt is None:
            dt = jnp.asarray(self.dt, jnp.float32)
        sampler = metropolis.refresh_amplitudes(wf, params, sampler)
        sampler = self.sweeps(params, sampler, cfg.num_monte_carlo_sweeps)
        configs = sampler.configs

        def direction(p):
            amp = wf.apply(p, configs)
            e_loc = lax.stop_gradient(
                ham.local_value(wf, p, configs, amp))
            return tdvp_direction(wf, p, configs, e_loc, self.mode,
                                  cfg.sr_diag_shift)

        k1, e_mean, r2 = direction(params)
        if self.integrator == 'heun':
            mid = jax.tree.map(lambda p, d: p + 0.5 * dt * d,
                               params, k1)
            k2, _, _ = direction(mid)
            new_params = jax.tree.map(lambda p, d: p + dt * d,
                                      params, k2)
            # Embedded (Euler vs Heun) error, relative to the step size.
            diff = jax.tree.map(jnp.subtract, k2, k1)
            err = 0.5 * common.grad_global_norm(diff) / (
                common.grad_global_norm(k1) + 1e-30)
        else:
            new_params = jax.tree.map(lambda p, d: p + dt * d,
                                      params, k1)
            err = jnp.zeros(())
        metrics = {'energy': jnp.real(e_mean),
                   'energy_imag': jnp.imag(e_mean)
                   if jnp.iscomplexobj(e_mean) else jnp.zeros(()),
                   'tdvp_r2': r2,
                   'integrator_rel_error': err,
                   'dt': dt}
        return new_params, sampler, metrics

    def evolve(self, params: Params, sampler: metropolis.SamplerState,
               n_steps: int,
               observe: Optional[Callable[[Params], Dict]] = None,
               ) -> Tuple[Params, metropolis.SamplerState, list]:
        """Integrates n_steps of dt; `observe(params)` is recorded per
        step alongside the energy (host loop — each step jits inside).
        With adaptive_tol set, dt is rescaled between steps from the
        embedded error estimate (no recompiles — dt is traced)."""
        step = jax.jit(self.step)
        records = []
        dt = self.dt
        for _ in range(n_steps):
            params, sampler, metrics = step(
                params, sampler, jnp.asarray(dt, jnp.float32))
            rec = {k: float(v) for k, v in metrics.items()}
            if observe is not None:
                rec.update(observe(params))
            records.append(rec)
            if self.adaptive_tol:
                err = max(rec['integrator_rel_error'], 1e-12)
                dt *= float(np.clip(
                    np.sqrt(self.adaptive_tol / err), 0.5, 1.5))
        return params, sampler, records
