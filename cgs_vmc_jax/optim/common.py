"""Shared optimizer scaffolding: train state, optax construction, helpers.

The reference split every optimizer into graph construction returning
TrainOps NamedTuples and a session.run epoch loop (cgs_vmc/training.py:27-132).
Here the split is "pure jitted epoch function over an explicit TrainState" /
"thin Python driver": a whole epoch — equilibration sweeps, per-batch
decorrelation, moment accumulation and the parameter update — is ONE
compiled call instead of ~6,000 dispatches (SURVEY.md §3.1).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from cgs_vmc_jax.models.base import Params, Wavefunction
from cgs_vmc_jax.sampler.metropolis import SamplerState


class TrainState(NamedTuple):
    """Everything a training run carries between epochs (all checkpointed,
    including sampler state — which the reference silently dropped on
    resume, SURVEY.md §5.4)."""
    params: Params
    opt_state: Any
    sampler: SamplerState
    epoch: jax.Array          # int32 scalar; drives the LR schedule
    extra: Dict[str, Any]     # optimizer-specific (supervisor params, EMAs)


EpochFn = Callable[[TrainState], Tuple[TrainState, Dict[str, jax.Array]]]


class SgdOptimizer(NamedTuple):
    """An optax transformation plus the reference's epoch-keyed LR schedule.

    The reference's piecewise-constant LR is a function of the EPOCH counter
    (cgs_vmc/training.py:86-91), independent of how many parameter updates
    an optimizer performs per epoch (EnergyGradient: 1, IT-SWO: one per
    batch) — so the schedule is applied explicitly at update time instead
    of through optax's internal step count.
    """
    transform: optax.GradientTransformation
    rates: tuple
    stops: tuple

    def init(self, params):
        return self.transform.init(params)

    def learning_rate(self, epoch) -> jax.Array:
        rates = jnp.asarray(self.rates, jnp.float32)
        stops = jnp.asarray(self.stops, jnp.int32)
        idx = jnp.sum(epoch >= stops)
        return rates[idx]

    def update(self, grads, opt_state, params, epoch):
        """Returns (new_params, new_opt_state) performing a descent step."""
        updates, opt_state = self.transform.update(grads, opt_state, params)
        lr = self.learning_rate(epoch)
        new_params = jax.tree.map(lambda p, u: p - lr * u, params, updates)
        return new_params, opt_state


def make_optax_optimizer(config) -> SgdOptimizer:
    """adam/gradient/rms_prop/momentum with a piecewise-constant LR schedule
    keyed on the epoch counter (reference create_sgd_optimizer,
    cgs_vmc/training.py:76-91)."""
    rates = tuple(config.learning_rates)
    stops = tuple(config.learning_rate_stops)
    if len(rates) != len(stops) + 1:
        raise ValueError(
            'learning_rates must have one more entry than '
            f'learning_rate_stops; got {len(rates)} vs {len(stops)}')
    makers = {
        'adam': lambda: optax.scale_by_adam(b2=config.beta2),
        'gradient': lambda: optax.identity(),
        'rms_prop': lambda: optax.scale_by_rms(),
        'momentum': lambda: optax.trace(decay=0.9),
    }
    if config.optimizer not in makers:
        raise ValueError(f'Unknown optimizer {config.optimizer!r}; '
                         f'known: {sorted(makers)}')
    return SgdOptimizer(makers[config.optimizer](), rates, stops)


def pmean(x, axis_name: Optional[str]):
    """Mean over the device axis when running under shard_map, identity
    otherwise (single-chip and multi-chip share one code path)."""
    if axis_name is None:
        return x
    return jax.lax.pmean(x, axis_name)


def log_derivative_pullback(wf: Wavefunction, params: Params,
                            configs: jax.Array):
    """Returns (amp: LogAmp, pullback) where pullback(w) = d/dparams sum_b
    w_b * log|psi_b|.

    One linearization serves every estimator moment: <∇logψ> with w = 1/M,
    <E_loc·∇logψ> with w = E_loc/M, <ratio·∇logψ> with w = ratio/M — the
    functional version of the reference's ``tf.gradients(psi/stop_grad(psi))``
    trick (cgs_vmc/training.py:545-548).
    """
    from cgs_vmc_jax.models.base import LogAmp

    def log_fn(p):
        amp = wf.apply(p, configs)
        return amp.log, amp.sign

    # The full LogAmp (sign carried as non-differentiated aux) is returned
    # so callers feed it straight into local_value instead of re-applying
    # the wavefunction (round-2 review: the redundant forward relied on
    # XLA CSE).
    logs, vjp_fn, sign = jax.vjp(log_fn, params, has_aux=True)
    if jnp.iscomplexobj(logs):
        raise NotImplementedError(
            'This optimizer path supports real-log ansatzes only; '
            'complex-phase wavefunctions train with EnergyGradient or '
            "SR (sr_solver='dense'), which use log_amp_phase_pullback.")
    return LogAmp(sign, logs), lambda w: vjp_fn(w)[0]


def log_amp_phase_pullback(wf: Wavefunction, params: Params,
                           configs: jax.Array):
    """Complex-log twin of `log_derivative_pullback`.

    Returns (amp: LogAmp, pullback) where
      pullback(w_re, w_im) = d/dparams sum_b [w_re_b·log|psi_b|
                                              + w_im_b·phase_b].
    Splitting the complex log into two real outputs keeps the vjp free of
    complex-cotangent conventions: O_k = ∂log|psi| + i·∂phase is consumed
    as its real and imaginary parts directly (energy gradient: grad =
    2·Re[⟨O*·(E−Ē)⟩] = 2[⟨O_r·E_r⟩c + ⟨O_i·E_i⟩c]).
    """
    from cgs_vmc_jax.models.base import LogAmp

    def fn(p):
        amp = wf.apply(p, configs)
        return (amp.log.real, amp.log.imag), amp.sign

    (log_re, log_im), vjp_fn, sign = jax.vjp(fn, params, has_aux=True)
    return (LogAmp(sign, log_re + 1j * log_im),
            lambda w_re, w_im: vjp_fn((w_re, w_im))[0])


def tree_weighted_diff(g_scaled: Params, g_plain: Params, coeff) -> Params:
    """g_scaled - coeff * g_plain, leafwise (variance-reduced gradients)."""
    return jax.tree.map(lambda a, b: a - coeff * b, g_scaled, g_plain)


def normalized_ratio(amp_num, amp_den) -> jax.Array:
    """sign-correct ratio psi_num/psi_den from two LogAmps.

    Uses conj(den.sign) for 1/sign — a no-op for real ±1 signs, correct
    for complex unit signs (see ops/logamp.py::ratio)."""
    return amp_num.sign * jnp.conj(amp_den.sign) * jnp.exp(
        amp_num.log - amp_den.log)


def grad_global_norm(grads: Params) -> jax.Array:
    return optax.global_norm(grads)


def make_sweeps_fn(wf: Wavefunction, config):
    """Returns sweeps(params, sampler_state, num_sweeps) -> sampler_state.

    Dispatch is delegated to the sampler fast-path registry
    (sampler/registry.py): explicit sampler knobs (MTM, MPS env-cached
    sweeps) outrank automatic incremental paths (Pallas RBM kernel,
    Sherman–Morrison PBDG), which outrank the generic per-chain sampler.
    Third-party ansatzes add entries with
    ``sampler.registry.register_fast_path`` — no framework edits."""
    from cgs_vmc_jax.sampler import registry
    return registry.resolve_sweeps_fn(wf, config)
