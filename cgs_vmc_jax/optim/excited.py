"""Excited-state VMC by penalty orthogonalization.

A capability beyond the reference (which only does ground-state search and
supervised fits, cgs_vmc/training.py:913-925): minimize

    L(theta) = <H>_psi + lambda * sum_k F_k,
    F_k = |<psi_k|psi>|^2 / (<psi_k|psi_k> <psi|psi>)

over a variational state psi orthogonalized against a list of FROZEN lower
states psi_k (typically the trained ground state), so the minimizer is the
lowest state orthogonal to span{psi_k} — the standard penalty route to
excitation gaps in NQS VMC.  For lambda > E_k_max − E_0 the penalized
minimum sits at the first state outside the spanned set with L = E_excited.

Estimators (all normalization-free).  With samples X ~ |psi|^2 and
Y_k ~ |psi_k|^2 and ratios r_k = psi_k(X)/psi(X), s_k = psi(Y_k)/psi_k(Y_k):

    F_k     = <r_k>_X * <s_k>_Y           (A_k * B_k; each factor is a
                                           plain MC mean — no sign problem
                                           beyond the ansatz's own)
    dF_k    = 2 Re[ conj(A_k) * <s_k O>_Y − F_k * <O_r>_X ]

with O = d(log psi)/d(theta) (O_r its real part, d log|psi|).  The product
form A_k * <s_k O>_Y avoids dividing by small overlaps: the gradient of F
(not log F) vanishes smoothly as the states decouple.  Both factors are
independent MC estimates, so the product is consistent; moments accumulate
over `num_batches_per_epoch` decorrelated batches exactly like the
energy-gradient optimizer, and every moment is pmean'd over the 'chains'
mesh axis so chips hold identical updates.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from cgs_vmc_jax.models.base import Params, Wavefunction
from cgs_vmc_jax.ops.heisenberg import Operator
from cgs_vmc_jax.optim import common
from cgs_vmc_jax.optim.common import TrainState
from cgs_vmc_jax.optim.sr import StochasticReconfiguration
from cgs_vmc_jax.sampler import metropolis


def load_frozen_states(config) -> List[Tuple[Wavefunction, Params]]:
    """Resolves ``config.orthogonal_to`` paths into frozen (wf, params).

    Each entry is either a RUN DIRECTORY (its own config.json defines the
    architecture; params restored from the latest checkpoint — the same
    params-only restore `cgs eval` uses on any run dir) or a standalone
    ``.msgpack`` params artifact (architecture taken from the CURRENT
    config, which must therefore match the artifact's ansatz).
    """
    from cgs_vmc_jax import models
    from cgs_vmc_jax.config import Config
    from cgs_vmc_jax.utils import checkpoint as ckpt_lib

    out: List[Tuple[Wavefunction, Params]] = []
    for path in config.orthogonal_to:
        if os.path.isdir(path):
            sub = Config.load(os.path.join(path, 'config.json'))
            wf_k = models.build_wavefunction(sub)
            template = wf_k.init(jax.random.key(sub.seed))
            latest = ckpt_lib.latest_checkpoint(path)
            if latest is None:
                raise FileNotFoundError(f'No checkpoint in {path!r}')
            params = ckpt_lib.restore_params_from_checkpoint(latest, template)
        else:
            wf_k = models.build_wavefunction(config)
            template = wf_k.init(jax.random.key(config.seed))
            params = ckpt_lib.restore_params_only(path, template)
        out.append((wf_k, params))
    return out


class PenaltyExcitedOptimizer:
    """Ground-state-optimizer-shaped 'ExcitedPenalty' entry.

    Registry construction signature (wf, hamiltonian, config) with the
    frozen lower states resolved from ``config.orthogonal_to``; tests and
    in-process callers may pass ``lower_states=[(wf_k, params_k), ...]``
    directly.
    """

    name = 'ExcitedPenalty'

    def __init__(self, wf: Wavefunction, hamiltonian: Operator, config,
                 lower_states: Optional[
                     Sequence[Tuple[Wavefunction, Params]]] = None):
        self.wf = wf
        self.hamiltonian = hamiltonian
        self.config = config
        if lower_states is None:
            if not getattr(config, 'orthogonal_to', ()):
                raise ValueError(
                    "ExcitedPenalty needs frozen lower states: set "
                    "config.orthogonal_to (run dirs or params artifacts) "
                    "or pass lower_states=[(wf, params), ...]")
            lower_states = load_frozen_states(config)
        self.lower_wfs = [wf_k for wf_k, _ in lower_states]
        self.lower_params = [p_k for _, p_k in lower_states]
        self.penalty = float(getattr(config, 'orthogonality_penalty', 10.0))
        if self.penalty <= 0.0:
            raise ValueError(
                f'orthogonality_penalty must be > 0 (got {self.penalty}); '
                'it must exceed the target gap for the penalized minimum '
                'to be the excited state')
        self.optax_opt = common.make_optax_optimizer(config)
        self.sweeps = common.make_sweeps_fn(wf, config)
        self.lower_sweeps = [common.make_sweeps_fn(wf_k, config)
                             for wf_k in self.lower_wfs]

    def init_state(self, key: jax.Array, n_local_chains: Optional[int] = None
                   ) -> TrainState:
        cfg = self.config
        keys = jax.random.split(key, 2 + len(self.lower_wfs))
        params = self.wf.init(keys[0])
        sampler = metropolis.init_sampler_for(
            keys[1], self.wf, params, cfg, n_local_chains)
        lower_samplers = []
        for i, (wf_k, p_k) in enumerate(zip(self.lower_wfs,
                                            self.lower_params)):
            smp = metropolis.init_sampler_for(
                keys[2 + i], wf_k, p_k, cfg, n_local_chains)
            # The lower states are frozen, so their chains equilibrate ONCE
            # here (eagerly) and only decorrelate inside epochs.
            smp = self.lower_sweeps[i](p_k, smp,
                                       cfg.num_equilibration_sweeps)
            lower_samplers.append(smp)
        return TrainState(
            params=params,
            opt_state=self.optax_opt.init(params),
            sampler=sampler,
            epoch=jnp.zeros((), jnp.int32),
            extra={'lower_samplers': lower_samplers},
        )

    def epoch(self, state: TrainState, axis_name: Optional[str] = None
              ) -> Tuple[TrainState, Dict[str, jax.Array]]:
        cfg = self.config
        wf, ham = self.wf, self.hamiltonian
        params = state.params
        n_lower = len(self.lower_wfs)
        is_complex = jnp.iscomplexobj(state.sampler.log_amp)

        sampler = metropolis.reset_stats(state.sampler)
        sampler = metropolis.refresh_amplitudes(wf, params, sampler)
        sampler = self.sweeps(params, sampler, cfg.num_equilibration_sweeps)
        lower_samplers = [metropolis.reset_stats(s)
                          for s in state.extra['lower_samplers']]
        if not is_complex and any(
                jnp.iscomplexobj(s.log_amp) for s in lower_samplers):
            raise NotImplementedError(
                'complex frozen lower states require a complex-log '
                'variational ansatz (the overlap moments would silently '
                'drop their imaginary parts under a real-log psi)')

        n_batches = cfg.num_batches_per_epoch
        zero_grads = jax.tree.map(jnp.zeros_like, params)
        cdtype = jnp.complex64 if is_complex else jnp.float32

        def batch_step(carry, _):
            smp, lowers, acc = carry
            (g_plain, g_oi, g_scaled, g_s_re, g_s_im,
             e_sum, e2_sum, a_sum, b_sum) = acc
            configs = smp.configs
            local_batch = configs.shape[0]
            inv = 1.0 / (local_batch * n_batches)

            if is_complex:
                amp, pullback = common.log_amp_phase_pullback(
                    wf, params, configs)
            else:
                amp, pullback = common.log_derivative_pullback(
                    wf, params, configs)
            e_loc = lax.stop_gradient(
                ham.local_value(wf, params, configs, amp))

            ones = jnp.full(local_batch, inv, jnp.float32)
            zeros = jnp.zeros(local_batch, jnp.float32)
            if is_complex:
                g_plain = jax.tree.map(jnp.add, g_plain,
                                       pullback(ones, zeros))
                g_oi = jax.tree.map(jnp.add, g_oi, pullback(zeros, ones))
                g_scaled = jax.tree.map(
                    jnp.add, g_scaled,
                    pullback(jnp.real(e_loc) * inv, jnp.imag(e_loc) * inv))
                e2_sum = e2_sum + jnp.sum(jnp.abs(e_loc) ** 2) * inv
            else:
                g_plain = jax.tree.map(jnp.add, g_plain, pullback(ones))
                g_scaled = jax.tree.map(jnp.add, g_scaled,
                                        pullback(e_loc * inv))
                e2_sum = e2_sum + jnp.sum(e_loc ** 2) * inv
            e_sum = e_sum + jnp.sum(e_loc) * inv

            # --- Overlap moments, one frozen state at a time ------------
            new_lowers = []
            new_gsre, new_gsim, new_a, new_b = [], [], [], []
            for k in range(n_lower):
                wf_k, p_k = self.lower_wfs[k], self.lower_params[k]
                # A_k = <psi_k/psi> over this batch's psi-samples.
                amp_kx = wf_k.apply(p_k, configs)
                r = lax.stop_gradient(common.normalized_ratio(amp_kx, amp))
                new_a.append(a_sum[k] + jnp.sum(r).astype(cdtype) * inv)

                # B_k and <s O> over the frozen chain's samples.
                l_smp = lowers[k]
                y = l_smp.configs
                inv_y = 1.0 / (y.shape[0] * n_batches)
                if is_complex:
                    amp_y, pull_y = common.log_amp_phase_pullback(
                        wf, params, y)
                else:
                    amp_y, pull_y = common.log_derivative_pullback(
                        wf, params, y)
                amp_ky = wf_k.apply(p_k, y)
                s = lax.stop_gradient(
                    common.normalized_ratio(amp_y, amp_ky))
                new_b.append(b_sum[k] + jnp.sum(s).astype(cdtype) * inv_y)
                if is_complex:
                    s_re, s_im = jnp.real(s), jnp.imag(s)
                    # Re<sO> and Im<sO> with O = O_r + i O_i.
                    new_gsre.append(jax.tree.map(
                        jnp.add, g_s_re[k],
                        pull_y(s_re * inv_y, -s_im * inv_y)))
                    new_gsim.append(jax.tree.map(
                        jnp.add, g_s_im[k],
                        pull_y(s_im * inv_y, s_re * inv_y)))
                else:
                    new_gsre.append(jax.tree.map(
                        jnp.add, g_s_re[k], pull_y(s * inv_y)))
                    new_gsim.append(g_s_im[k])

                new_lowers.append(self.lower_sweeps[k](
                    p_k, l_smp, cfg.num_monte_carlo_sweeps))

            smp = self.sweeps(params, smp, cfg.num_monte_carlo_sweeps)
            acc = (g_plain, g_oi, g_scaled, new_gsre, new_gsim,
                   e_sum, e2_sum, new_a, new_b)
            return (smp, new_lowers, acc), None

        acc0 = (zero_grads, zero_grads, zero_grads,
                [zero_grads] * n_lower, [zero_grads] * n_lower,
                jnp.zeros((), cdtype), jnp.zeros((), jnp.float32),
                [jnp.zeros((), cdtype)] * n_lower,
                [jnp.zeros((), cdtype)] * n_lower)
        (sampler, lower_samplers, acc), _ = lax.scan(
            batch_step, (sampler, lower_samplers, acc0), None,
            length=n_batches)
        (g_plain, g_oi, g_scaled, g_s_re, g_s_im,
         e_mean, e2_mean, a_list, b_list) = jax.tree.map(
            lambda x: common.pmean(x, axis_name), acc)

        # Energy gradient (variance-reduced); complex: grad = <E_r O> +
        # <E_i O_i>-style moments exactly as EnergyGradientOptimizer.
        if is_complex:
            grads = common.tree_weighted_diff(g_scaled, g_plain,
                                              jnp.real(e_mean))
            grads = common.tree_weighted_diff(grads, g_oi,
                                              jnp.imag(e_mean))
            energy = jnp.real(e_mean)
            variance = e2_mean - jnp.abs(e_mean) ** 2
        else:
            grads = common.tree_weighted_diff(g_scaled, g_plain,
                                              jnp.real(e_mean))
            energy = jnp.real(e_mean)
            variance = e2_mean - energy ** 2

        # Penalty gradients: 2 lambda Re[conj(A)<sO> − F <O_r>].
        overlap_total = jnp.zeros((), jnp.float32)
        for k in range(n_lower):
            a_k, b_k = a_list[k], b_list[k]
            fid = jnp.real(a_k * b_k)
            overlap_total = overlap_total + fid
            if is_complex:
                a_re, a_im = jnp.real(a_k), jnp.imag(a_k)
                # Re[conj(A)<sO>] = ReA·Re<sO> + ImA·Im<sO>.
                grads = jax.tree.map(
                    lambda g, gre, gim, gp: g + 2.0 * self.penalty * (
                        a_re * gre + a_im * gim - fid * gp),
                    grads, g_s_re[k], g_s_im[k], g_plain)
            else:
                grads = jax.tree.map(
                    lambda g, gs, gp: g + 2.0 * self.penalty * (
                        jnp.real(a_k) * gs - fid * gp),
                    grads, g_s_re[k], g_plain)

        params, opt_state = self.optax_opt.update(
            grads, state.opt_state, params, state.epoch)

        metrics = {
            'energy': energy,
            'energy_variance': variance,
            'overlap': overlap_total,
            'loss': energy + self.penalty * overlap_total,
            'acceptance_rate': common.pmean(
                metropolis.acceptance_rate(sampler), axis_name),
            'grad_norm': common.grad_global_norm(grads),
        }
        new_state = TrainState(
            params=params,
            opt_state=opt_state,
            sampler=sampler,
            epoch=state.epoch + 1,
            extra={**state.extra, 'lower_samplers': lower_samplers},
        )
        return new_state, metrics


class SRPenaltyExcitedOptimizer(StochasticReconfiguration):
    """Natural-gradient excited-state search: 'ExcitedSR'.

    The penalty force is a covariance over the psi-samples,

        dF = 2 Re[ F/A * <conj(r) O>_X  -  F <O_r>_X ],   A = <r>_X,

    i.e. exactly the form minSR already solves — so the whole SR pipeline
    (dense/dense_cg/sample_cg/cg solvers, trust region, residual
    rejection) applies unchanged with an EFFECTIVE local value

        e_solver(x) = E_loc(x) + lambda * sum_k (F_k/A_k) * r_k(x)

    (the -F<O_r> piece emerges from the solver's own centering).  For a
    real ansatz F/A = <s>_Y, the frozen-chain mean — no division.  The
    frozen lower chains only set the scalar coefficients, so they advance
    by num_monte_carlo_sweeps per epoch.
    """

    name = 'ExcitedSR'

    def __init__(self, wf: Wavefunction, hamiltonian: Operator, config,
                 lower_states: Optional[
                     Sequence[Tuple[Wavefunction, Params]]] = None):
        super().__init__(wf, hamiltonian, config)
        if lower_states is None:
            if not getattr(config, 'orthogonal_to', ()):
                raise ValueError(
                    "ExcitedSR needs frozen lower states: set "
                    "config.orthogonal_to (run dirs or params artifacts) "
                    "or pass lower_states=[(wf, params), ...]")
            lower_states = load_frozen_states(config)
        self.lower_wfs = [wf_k for wf_k, _ in lower_states]
        self.lower_params = [p_k for _, p_k in lower_states]
        self.penalty = float(getattr(config, 'orthogonality_penalty', 10.0))
        if self.penalty <= 0.0:
            raise ValueError(
                f'orthogonality_penalty must be > 0 (got {self.penalty})')
        self.lower_sweeps = [common.make_sweeps_fn(wf_k, config)
                             for wf_k in self.lower_wfs]

    def init_state(self, key: jax.Array, n_local_chains: Optional[int] = None
                   ) -> TrainState:
        cfg = self.config
        base_key, *lower_keys = jax.random.split(
            key, 1 + len(self.lower_wfs))
        state = super().init_state(base_key, n_local_chains)
        lower_samplers = []
        for i, (wf_k, p_k) in enumerate(zip(self.lower_wfs,
                                            self.lower_params)):
            smp = metropolis.init_sampler_for(
                lower_keys[i], wf_k, p_k, cfg, n_local_chains)
            smp = self.lower_sweeps[i](p_k, smp,
                                       cfg.num_equilibration_sweeps)
            lower_samplers.append(smp)
        return state._replace(
            extra={**state.extra, 'lower_samplers': lower_samplers})

    def _solver_residual(self, params, all_configs, amp, e_loc, state,
                         axis_name):
        cfg = self.config
        is_complex = jnp.iscomplexobj(amp.log)
        lowers = [metropolis.reset_stats(s)
                  for s in state.extra['lower_samplers']]
        if not is_complex and any(
                jnp.iscomplexobj(s.log_amp) for s in lowers):
            raise NotImplementedError(
                'complex frozen lower states require a complex-log '
                'variational ansatz')
        e_solver = e_loc
        overlap_total = jnp.zeros((), jnp.float32)
        new_lowers = []
        for k, (wf_k, p_k) in enumerate(zip(self.lower_wfs,
                                            self.lower_params)):
            amp_kx = wf_k.apply(p_k, all_configs)
            r = jax.lax.stop_gradient(common.normalized_ratio(amp_kx, amp))
            a_k = common.pmean(jnp.mean(r), axis_name)

            l_smp = lowers[k]
            y = l_smp.configs
            amp_y = self.wf.apply(params, y)
            amp_ky = wf_k.apply(p_k, y)
            s = jax.lax.stop_gradient(
                common.normalized_ratio(amp_y, amp_ky))
            b_k = common.pmean(jnp.mean(s), axis_name)

            fid = jnp.real(a_k * b_k)
            overlap_total = overlap_total + fid
            denom = a_k + jnp.where(
                jnp.abs(a_k) < 1e-20,
                jnp.asarray(1e-20, a_k.dtype), jnp.asarray(0, a_k.dtype))
            coeff = jax.lax.stop_gradient(fid / denom)
            e_solver = e_solver + self.penalty * coeff * r

            new_lowers.append(self.lower_sweeps[k](
                p_k, l_smp, cfg.num_monte_carlo_sweeps))

        extra = {**state.extra, 'lower_samplers': new_lowers}
        return e_solver, extra, {'overlap': overlap_total}
