"""Dynamical structure factor S(q, omega) via linear-response t-VMC.

NEW capability beyond the reference (which has no dynamics at all; its
optimizer registry is purely ground-state/supervised,
cgs_vmc/training.py:913-925).  Standard linear-response protocol on top
of the TDVP machinery (optim/tvmc.py):

1. **Quench**: |psi_eps> = e^{eps O_q}|0> projected onto the variational
   manifold — one imaginary-"time" TDVP direction under the PROBE
   operator O_q integrated for -eps (the tangent-space projection of
   multiplying by (1 + eps O_q); exact on a complete parameterization).
2. **Evolve** |psi_eps> under H in real time (complex-log ansatz),
   recording A(t) = <O_q>(t).
3. **Response**: for a Hermitian probe and real eps,
       (A(t) - <O_q>_0) / (2 eps) = Re <0| O_q(t) O_q |0>_connected
   to first order in eps — the symmetric dynamical correlator C(t).
4. **Spectrum**: S(q, omega) = 2 * int_0^T dt cos(omega t) e^{-eta t} C(t)
   has peaks at the excitation energies E_n - E_0 carrying the spectral
   weights |<n|O_q|0>|^2 (cosine transform of
   C(t) = sum_n |<n|O_q|0>|^2 cos((E_n - E_0) t)).

The probe O_q = N^{-1/2} sum_i cos(q . r_i) Sz_i is DIAGONAL, so its
local value needs no extra wavefunction evaluations, the quenched state
stays in the sampled Sz sector, and <O_q> is a plain sampled mean.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from cgs_vmc_jax.models.base import Params, Wavefunction
from cgs_vmc_jax.ops.heisenberg import Operator
from cgs_vmc_jax.ops.logamp import LogAmp
from cgs_vmc_jax.optim.tvmc import tdvp_direction


class FourierSz(Operator):
    """O_q = N^{-1/2} sum_i cos(q . r_i) Sz_i — the (cosine) momentum-q
    longitudinal spin probe; diagonal in the computational basis."""

    def __init__(self, q: Sequence[float], positions: np.ndarray):
        q = np.asarray(q, np.float64).reshape(-1)
        positions = np.asarray(positions, np.float64)
        if positions.ndim != 2 or positions.shape[1] != q.shape[0]:
            raise ValueError(
                f'positions must be [n_sites, {q.shape[0]}], '
                f'got {positions.shape}')
        n = positions.shape[0]
        # Host numpy constant (DEVELOPMENT.md rule).
        self.coeff = (np.cos(positions @ q) / np.sqrt(n)).astype(np.float32)

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: jax.Array, amp: Optional[LogAmp] = None
                    ) -> jax.Array:
        del wf, params, amp  # diagonal
        return jnp.sum(0.5 * configs * self.coeff, axis=-1)


def quench_params(wf: Wavefunction, params: Params, configs: jax.Array,
                  probe: Operator, eps: float,
                  diag_shift: float = 1e-6,
                  weights: Optional[jax.Array] = None) -> Params:
    """Tangent-space projection of |psi> -> e^{eps O}|psi>.

    One 'imag'-mode TDVP direction under the probe (the imaginary-time
    flow generator of O) integrated for -eps: theta' = theta - eps *
    theta_dot, since the imag direction tracks e^{-tau O}.
    """
    o_loc = probe.local_value(wf, params, configs)
    if jnp.iscomplexobj(wf.apply(params, configs[:1]).log):
        o_loc = o_loc.astype(jnp.complex64)
    theta_dot, _, _ = tdvp_direction(wf, params, configs, o_loc,
                                     mode='imag', diag_shift=diag_shift,
                                     weights=weights)
    return jax.tree.map(lambda p, d: p - eps * d, params, theta_dot)


def exact_linear_response(
    wf: Wavefunction, params: Params, hamiltonian: Operator,
    probe: Operator, states: jax.Array, eps: float, dt: float,
    n_steps: int, diag_shift: float = 1e-6,
) -> Tuple[np.ndarray, np.ndarray, Dict[str, list]]:
    """C(t) on the FULL enumerated basis (deterministic |psi|^2 weights,
    Heun integration) — the oracle/small-system path.

    Returns (times [n_steps+1], C [n_steps+1], diagnostics) with
    C(t) = (<O>(t) - <O>_0) / (2 eps) ~= Re <O(t) O>_c.
    """
    @jax.jit
    def weights_of(p):
        amp = wf.apply(p, states)
        return jax.nn.softmax(2.0 * jnp.real(amp.log))

    @jax.jit
    def observe(p):
        w = weights_of(p)
        return jnp.sum(w * jnp.real(
            probe.local_value(wf, p, states)))

    @jax.jit
    def direction(p):
        amp = wf.apply(p, states)
        w = jax.nn.softmax(2.0 * jnp.real(amp.log))
        e_loc = hamiltonian.local_value(wf, p, states, amp)
        return tdvp_direction(wf, p, states, e_loc, mode='real',
                              diag_shift=diag_shift, weights=w)

    o_base = float(observe(params))
    p = quench_params(wf, params, states, probe, eps,
                      diag_shift=diag_shift, weights=weights_of(params))
    values = [float(observe(p))]
    diagnostics = {'energy': [], 'tdvp_r2': []}
    for _ in range(n_steps):
        k1, e, r2 = direction(p)
        mid = jax.tree.map(lambda a, d: a + 0.5 * dt * d, p, k1)
        k2, _, _ = direction(mid)
        p = jax.tree.map(lambda a, d: a + dt * d, p, k2)
        values.append(float(observe(p)))
        diagnostics['energy'].append(complex(e))
        diagnostics['tdvp_r2'].append(float(r2))
    times = dt * np.arange(n_steps + 1)
    corr = (np.asarray(values) - o_base) / (2.0 * eps)
    return times, corr, diagnostics


def sampled_linear_response(
    wf: Wavefunction, params: Params, hamiltonian: Operator,
    probe: Operator, config, eps: float, dt: float, n_steps: int,
    key: Optional[jax.Array] = None,
) -> Tuple[np.ndarray, np.ndarray, list]:
    """MC version with ANTITHETIC coupled chains: quench to +eps and
    -eps from the same equilibrated chains, evolve both trajectories
    with identical RNG streams, and take

        C(t) = (<O>_{+eps}(t) - <O>_{-eps}(t)) / (4 eps).

    The symmetric difference cancels the even-order quench bias AND the
    (strongly correlated, since the trajectories differ by O(eps))
    chain-sampling noise — far lower variance than a single-quench run
    against a baseline.  For the diagonal probe each trajectory's
    measurement is a plain mean over its own chains, which re-equilibrate
    under the quenched amplitudes before t=0 is recorded.

    Returns (times, C, per-step records of the +eps trajectory).
    """
    from cgs_vmc_jax.optim.tvmc import TimeEvolution
    from cgs_vmc_jax.sampler import metropolis

    if key is None:
        key = jax.random.key(config.seed)
    evo = TimeEvolution(wf, hamiltonian, config, dt=dt, mode='real',
                        integrator='heun')
    sampler = evo.init_state(key, params)
    sampler = metropolis.refresh_amplitudes(wf, params, sampler)
    sampler = evo.sweeps(params, sampler, config.num_equilibration_sweeps)

    probe_mean = jax.jit(lambda c: jnp.mean(jnp.real(
        probe.local_value(wf, None, c))))
    p_pos = quench_params(wf, params, sampler.configs, probe, eps,
                          diag_shift=config.sr_diag_shift)
    p_neg = quench_params(wf, params, sampler.configs, probe, -eps,
                          diag_shift=config.sr_diag_shift)

    @jax.jit
    def equilibrate(p, smp):
        smp = metropolis.refresh_amplitudes(wf, p, smp)
        return evo.sweeps(p, smp, config.num_equilibration_sweeps)

    s_pos = equilibrate(p_pos, sampler)
    s_neg = equilibrate(p_neg, sampler)   # same start, same key stream

    values = [(float(probe_mean(s_pos.configs)),
               float(probe_mean(s_neg.configs)))]
    records = []
    step = jax.jit(evo.step)
    for _ in range(n_steps):
        p_pos, s_pos, metrics = step(p_pos, s_pos)
        p_neg, s_neg, _ = step(p_neg, s_neg)
        values.append((float(probe_mean(s_pos.configs)),
                       float(probe_mean(s_neg.configs))))
        records.append({k: float(v) for k, v in metrics.items()})
    times = dt * np.arange(n_steps + 1)
    values = np.asarray(values)
    corr = (values[:, 0] - values[:, 1]) / (4.0 * eps)
    return times, corr, records


def spectral_function(times: np.ndarray, corr: np.ndarray,
                      omegas: np.ndarray, eta: float = 0.2) -> np.ndarray:
    """S(omega) = 2 * int_0^T dt cos(omega t) e^{-eta t} C(t), trapezoid.

    eta damps the finite-T cutoff (Lorentzian broadening ~eta around
    each excitation peak).
    """
    times = np.asarray(times, np.float64)
    corr = np.asarray(corr, np.float64)
    omegas = np.asarray(omegas, np.float64)
    damped = corr * np.exp(-eta * times)
    integrand = np.cos(np.outer(omegas, times)) * damped[None, :]
    return 2.0 * np.trapezoid(integrand, times, axis=1)
