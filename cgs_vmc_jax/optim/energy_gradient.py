"""Variance-reduced VMC energy-gradient optimizer.

Re-design of the reference EnergyGradientOptimizer
(cgs_vmc/training.py:506-623): gradient
  ∇E = <E_loc ∇logψ> − <E_loc><∇logψ>
with moments accumulated over ``num_batches_per_epoch`` decorrelated batches.
The reference's tf.metrics accumulators + ~6,000 session.run calls per epoch
become one ``lax.scan`` over batches inside a single jitted epoch; across a
device mesh every moment is a ``pmean`` over the 'chains' axis so all chips
hold identical gradients.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from cgs_vmc_jax.models.base import Wavefunction
from cgs_vmc_jax.ops.heisenberg import Operator
from cgs_vmc_jax.optim import common
from cgs_vmc_jax.optim.common import TrainState
from cgs_vmc_jax.sampler import metropolis


class EnergyGradientOptimizer:
    """Ground-state optimizer 'EnergyGradient'."""

    name = 'EnergyGradient'

    def __init__(self, wf: Wavefunction, hamiltonian: Operator, config):
        self.wf = wf
        self.hamiltonian = hamiltonian
        self.config = config
        self.optax_opt = common.make_optax_optimizer(config)
        self.sweeps = common.make_sweeps_fn(wf, config)

    def init_state(self, key: jax.Array, n_local_chains: Optional[int] = None
                   ) -> TrainState:
        params_key, sampler_key = jax.random.split(key)
        params = self.wf.init(params_key)
        sampler = metropolis.init_sampler_for(
            sampler_key, self.wf, params, self.config,
            n_local_chains)
        return TrainState(
            params=params,
            opt_state=self.optax_opt.init(params),
            sampler=sampler,
            epoch=jnp.zeros((), jnp.int32),
            extra={},
        )

    def epoch(self, state: TrainState, axis_name: Optional[str] = None
              ) -> Tuple[TrainState, Dict[str, jax.Array]]:
        """One optimization epoch (reference training.py:589-623 semantics:
        equilibrate; per batch accumulate moments then decorrelate; one
        parameter update from epoch-mean moments)."""
        cfg = self.config
        wf, ham = self.wf, self.hamiltonian
        params = state.params

        sampler = metropolis.reset_stats(state.sampler)
        # Params changed since last epoch's sweeps wrote the amplitude cache.
        sampler = metropolis.refresh_amplitudes(wf, params, sampler)
        sampler = self.sweeps(params, sampler,
                              cfg.num_equilibration_sweeps)

        n_batches = cfg.num_batches_per_epoch
        zero_grads = jax.tree.map(jnp.zeros_like, params)
        # Complex-log ansatz? (static at trace time — the branch below
        # compiles exactly one of the two moment pipelines).
        is_complex = jnp.iscomplexobj(state.sampler.log_amp)

        def batch_step(carry, _):
            """Real path: grad ∝ ⟨E·∇logψ⟩ − ⟨E⟩⟨∇logψ⟩."""
            smp, g_plain, g_scaled, e_sum, e2_sum = carry
            configs = smp.configs
            local_batch = configs.shape[0]

            amp, pullback = common.log_derivative_pullback(wf, params,
                                                           configs)
            logs = amp.log
            e_loc = lax.stop_gradient(
                ham.local_value(wf, params, configs, amp))

            inv = 1.0 / (local_batch * n_batches)
            g_plain = jax.tree.map(
                jnp.add, g_plain, pullback(jnp.full_like(logs, inv)))
            g_scaled = jax.tree.map(
                jnp.add, g_scaled, pullback(e_loc * inv))
            e_sum = e_sum + jnp.sum(e_loc) * inv
            e2_sum = e2_sum + jnp.sum(e_loc ** 2) * inv

            smp = self.sweeps(params, smp, cfg.num_monte_carlo_sweeps)
            return (smp, g_plain, g_scaled, e_sum, e2_sum), None

        def batch_step_complex(carry, _):
            """Complex path: grad ∝ Re[⟨E*·O⟩ − ⟨E⟩*⟨O⟩] with
            O = ∂log|ψ| + i·∂phase — i.e. ⟨E_r O_r⟩c + ⟨E_i O_i⟩c."""
            smp, g_or, g_oi, g_scaled, e_sum, e2_sum = carry
            configs = smp.configs
            local_batch = configs.shape[0]

            amp, pullback = common.log_amp_phase_pullback(wf, params,
                                                          configs)
            e_loc = lax.stop_gradient(
                ham.local_value(wf, params, configs, amp))
            e_re, e_im = jnp.real(e_loc), jnp.imag(e_loc)

            inv = 1.0 / (local_batch * n_batches)
            ones = jnp.full(local_batch, inv, jnp.float32)
            zeros = jnp.zeros(local_batch, jnp.float32)
            g_or = jax.tree.map(jnp.add, g_or, pullback(ones, zeros))
            g_oi = jax.tree.map(jnp.add, g_oi, pullback(zeros, ones))
            g_scaled = jax.tree.map(
                jnp.add, g_scaled, pullback(e_re * inv, e_im * inv))
            e_sum = e_sum + jnp.sum(e_loc) * inv
            e2_sum = e2_sum + jnp.sum(jnp.abs(e_loc) ** 2) * inv

            smp = self.sweeps(params, smp, cfg.num_monte_carlo_sweeps)
            return (smp, g_or, g_oi, g_scaled, e_sum, e2_sum), None

        if is_complex:
            init = (sampler, zero_grads, zero_grads, zero_grads,
                    jnp.zeros((), jnp.complex64), jnp.zeros((), jnp.float32))
            (sampler, g_or, g_oi, g_scaled, e_mean, e2_mean), _ = lax.scan(
                batch_step_complex, init, None, length=n_batches)
            g_or = common.pmean(g_or, axis_name)
            g_oi = common.pmean(g_oi, axis_name)
            g_scaled = common.pmean(g_scaled, axis_name)
            e_mean = common.pmean(e_mean, axis_name)
            e2_mean = common.pmean(e2_mean, axis_name)
            grads = common.tree_weighted_diff(g_scaled, g_or,
                                              jnp.real(e_mean))
            grads = common.tree_weighted_diff(grads, g_oi, jnp.imag(e_mean))
            energy = jnp.real(e_mean)
            variance = e2_mean - jnp.abs(e_mean) ** 2
        else:
            init = (sampler, zero_grads, zero_grads,
                    jnp.zeros((), jnp.float32), jnp.zeros((), jnp.float32))
            (sampler, g_plain, g_scaled, e_mean, e2_mean), _ = lax.scan(
                batch_step, init, None, length=n_batches)
            g_plain = common.pmean(g_plain, axis_name)
            g_scaled = common.pmean(g_scaled, axis_name)
            e_mean = common.pmean(e_mean, axis_name)
            e2_mean = common.pmean(e2_mean, axis_name)
            grads = common.tree_weighted_diff(g_scaled, g_plain, e_mean)
            energy = e_mean
            variance = e2_mean - e_mean ** 2

        params, opt_state = self.optax_opt.update(
            grads, state.opt_state, params, state.epoch)

        metrics = {
            'energy': energy,
            'energy_variance': variance,
            'acceptance_rate': common.pmean(
                metropolis.acceptance_rate(sampler), axis_name),
            'grad_norm': common.grad_global_norm(grads),
        }
        new_state = TrainState(
            params=params,
            opt_state=opt_state,
            sampler=sampler,
            epoch=state.epoch + 1,
            extra=state.extra,
        )
        return new_state, metrics
