"""Supervised Wavefunction Optimization (SWO) — imaginary-time and distillation.

Re-designs of the reference's four supervised optimizers
(cgs_vmc/training.py:135-503) and two imaginary-time ground-state optimizers
(cgs_vmc/training.py:626-910), per arXiv:1808.05232.  Key structural change:
the reference cloned the ansatz graph via ``copy.deepcopy`` + introspection
and refreshed the supervisor with a group of tf.assign ops
(training.py:660,709; wavefunctions.py:177-204,300-325).  Here the
supervisor is just a second parameter pytree carried in
``state.extra['omega']`` and the refresh is an assignment.

Loss/gradient semantics preserved (log-domain):
 * psi/stop_grad(psi) == exp(log - stop_grad(log)) — the reference's
   normalized-output trick (training.py:545,337) — evaluates to 1 with
   gradient ∇logψ;
 * ITSWO normalization N = sqrt(1 − 2β<E> + β²<E²>) tracked by an
   epoch-keyed EMA(0.999) (training.py:822-841), with the reference's
   `time_evolution_befta` typo (training.py:812) fixed;
 * the √(2^n) target scaling of the distillation losses
   (training.py:170,257,452) is applied in log space.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from cgs_vmc_jax import basis as basis_lib
from cgs_vmc_jax.models.base import Params, Wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import common
from cgs_vmc_jax.optim.common import TrainState
from cgs_vmc_jax.sampler import metropolis


def _ema_update(shadow: jax.Array, value: jax.Array, num_updates: jax.Array,
                decay: float = 0.999) -> jax.Array:
    """tf.train.ExponentialMovingAverage semantics with num_updates:
    effective decay = min(decay, (1 + n) / (10 + n))."""
    n = num_updates.astype(jnp.float32)
    d = jnp.minimum(decay, (1.0 + n) / (10.0 + n))
    return shadow * d + value * (1.0 - d)


def _normalized_psi(log: jax.Array) -> jax.Array:
    """psi / stop_grad(psi): value 1, gradient ∇logψ (sign cancels).

    With a complex log the value is 1+0j and the gradient is the complex
    O = ∂log|ψ| + i·∂phase — the L2 losses below then differentiate
    |residual|², which is the conjugate-correct complex SWO objective."""
    return jnp.exp(log - lax.stop_gradient(log))


def _residual_l2(z: jax.Array) -> jax.Array:
    """mean(|z|²) — equals the reference's mean(z²) for real residuals and
    is the correct modulus-squared loss for complex ones (JAX propagates
    d|z|²/dθ = 2·Re[z*·dz/dθ] through complex intermediates to the real
    parameters automatically)."""
    return jnp.mean(jnp.real(z * jnp.conj(z)))


class _SWOBase:
    """Shared state plumbing for all SWO variants."""

    def __init__(self, wf: Wavefunction, config):
        self.wf = wf
        self.config = config
        self.optax_opt = common.make_optax_optimizer(config)
        self.sweeps = common.make_sweeps_fn(wf, config)

    def _base_state(self, key: jax.Array, extra: dict,
                    n_local_chains: Optional[int] = None) -> TrainState:
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
            extra=extra,
        )


# ======================================================================
# Ground-state imaginary-time SWO (self-supervised: target = (1-βH)|ψ_ω>).
# ======================================================================

def _log_overlap_grads(wf, params, configs, ratio, axis_name):
    """Half-scale log-overlap gradient, real or complex log:
      real:    <O> − <r·O>/<r>
      complex: <O_re> − Re[<r·O*>/<r>]   (O = ∂log|ψ| + i∂phase),
    which reduces to the real formula when Im ≡ 0.  Returns
    (grads pytree, <ratio>)."""
    m = configs.shape[0]
    if jnp.iscomplexobj(ratio) or jnp.iscomplexobj(
            wf.apply(params, configs[:1]).log):
        _, pull = common.log_amp_phase_pullback(wf, params, configs)
        ratio = ratio.astype(jnp.complex64)
        mean_ratio = common.pmean(jnp.mean(ratio), axis_name)
        w = ratio / (m * mean_ratio)
        ones = jnp.full((m,), 1.0 / m, jnp.float32)
        zeros = jnp.zeros((m,), jnp.float32)
        g_plain = common.pmean(pull(ones, zeros), axis_name)
        # Re[Σ w·O*] = Σ [Re(w)·O_re + Im(w)·O_im].
        g_corr = common.pmean(
            pull(jnp.real(w), jnp.imag(w)), axis_name)
        grads = jax.tree.map(jnp.subtract, g_plain, g_corr)
        return grads, mean_ratio
    _, pullback = common.log_derivative_pullback(wf, params, configs)
    g_plain = common.pmean(pullback(jnp.full((m,), 1.0 / m)), axis_name)
    g_ratio = common.pmean(pullback(ratio / m), axis_name)
    mean_ratio = common.pmean(jnp.mean(ratio), axis_name)
    grads = jax.tree.map(lambda a, b: a - b / mean_ratio, g_plain, g_ratio)
    return grads, mean_ratio


class LogOverlapImaginaryTimeSWO(_SWOBase):
    """Normalization-free IT-SWO via the log-overlap gradient
    (reference training.py:626-778):
      ∇L = <∇logψ> − <ratio·∇logψ>/<ratio>,  ratio = (ψ_ω − βHψ_ω)/ψ
    (complex-log ansatzes use the conjugate-correct form, see
    `_log_overlap_grads`).
    """

    name = 'LogOverlapITSWO'

    def __init__(self, wf: Wavefunction, hamiltonian: HeisenbergHamiltonian,
                 config):
        super().__init__(wf, config)
        self.hamiltonian = hamiltonian

    def init_state(self, key: jax.Array, n_local_chains: Optional[int] = None
                   ) -> TrainState:
        state = self._base_state(key, {}, n_local_chains)
        return state._replace(
            extra={'omega': jax.tree.map(jnp.copy, state.params)})

    def epoch(self, state: TrainState, axis_name: Optional[str] = None
              ) -> Tuple[TrainState, Dict[str, jax.Array]]:
        cfg = self.config
        wf, ham = self.wf, self.hamiltonian
        beta = cfg.time_evolution_beta

        sampler = metropolis.reset_stats(state.sampler)
        # Params changed since the cache was last written (previous epoch).
        sampler = metropolis.refresh_amplitudes(wf, state.params, sampler)
        sampler = self.sweeps(state.params, sampler,
                              cfg.num_equilibration_sweeps)
        # Supervisor refresh (reference training.py:755): ψ_ω ← ψ.
        omega = jax.tree.map(jnp.copy, state.params)

        def batch_step(carry, _):
            params, opt_state, smp, e_sum = carry
            smp = metropolis.refresh_amplitudes(wf, params, smp)
            smp = self.sweeps(params, smp, cfg.num_monte_carlo_sweeps)
            configs = smp.configs
            m = configs.shape[0]

            amp = wf.apply(params, configs)
            amp_omega = wf.apply(omega, configs)
            e_loc_omega = ham.local_value(wf, omega, configs, amp_omega)
            # ratio = (ψ_ω − β H ψ_ω) / ψ, all stop-grad (supervisor side).
            # exp(Δlog) carries any phase difference; 1/ψ contributes
            # conj(sign)/exp(log) since |s| = 1 (conj is a no-op for the
            # real ±1 signs of real-log ansatzes).
            ratio = lax.stop_gradient(
                amp_omega.sign * jnp.conj(amp.sign)
                * (1.0 - beta * e_loc_omega)
                * jnp.exp(amp_omega.log - amp.log))

            grads, _ = _log_overlap_grads(wf, params, configs, ratio,
                                          axis_name)
            params, opt_state = self.optax_opt.update(
                grads, opt_state, params, state.epoch)

            e_sum = e_sum + common.pmean(
                jnp.real(jnp.mean(e_loc_omega)), axis_name)
            return (params, opt_state, smp, e_sum), None

        init = (state.params, state.opt_state, sampler,
                jnp.zeros((), jnp.float32))
        (params, opt_state, sampler, e_sum), _ = lax.scan(
            batch_step, init, None, length=cfg.num_batches_per_epoch)

        metrics = {
            'energy': e_sum / cfg.num_batches_per_epoch,
            'acceptance_rate': common.pmean(
                metropolis.acceptance_rate(sampler), axis_name),
        }
        new_state = TrainState(params, opt_state, sampler, state.epoch + 1,
                               {'omega': omega})
        return new_state, metrics


class ImaginaryTimeSWO(_SWOBase):
    """L2-loss IT-SWO with EMA-tracked normalization (reference
    training.py:781-910; 'ITSWO' — the reference's default ground-state
    optimizer, run_training.py:48-51):
      loss = <(ψ − (ψ_ω − βHψ_ω)/N)² / stop(ψ)²>,
      N EMA-tracks sqrt(1 − 2β<E> + β²<E²>).
    """

    name = 'ITSWO'

    def __init__(self, wf: Wavefunction, hamiltonian: HeisenbergHamiltonian,
                 config):
        super().__init__(wf, config)
        self.hamiltonian = hamiltonian

    def init_state(self, key: jax.Array, n_local_chains: Optional[int] = None
                   ) -> TrainState:
        state = self._base_state(key, {}, n_local_chains)
        extra = {
            'omega': jax.tree.map(jnp.copy, state.params),
            'ite_normalization': jnp.ones((), jnp.float32),
            'ema_norm': jnp.ones((), jnp.float32),
            'ema_energy': jnp.zeros((), jnp.float32),
            'ema_count': jnp.zeros((), jnp.float32),
        }
        return state._replace(extra=extra)

    def epoch(self, state: TrainState, axis_name: Optional[str] = None
              ) -> Tuple[TrainState, Dict[str, jax.Array]]:
        cfg = self.config
        wf, ham = self.wf, self.hamiltonian
        beta = cfg.time_evolution_beta

        sampler = metropolis.reset_stats(state.sampler)
        # Params changed since the cache was last written (previous epoch).
        sampler = metropolis.refresh_amplitudes(wf, state.params, sampler)
        sampler = self.sweeps(state.params, sampler,
                              cfg.num_equilibration_sweeps)
        omega = jax.tree.map(jnp.copy, state.params)
        norm_var = state.extra['ite_normalization']

        def batch_step(carry, _):
            params, opt_state, smp, ema_norm, ema_energy, ema_count = carry
            smp = metropolis.refresh_amplitudes(wf, params, smp)
            smp = self.sweeps(params, smp, cfg.num_monte_carlo_sweeps)
            configs = smp.configs

            amp_omega = wf.apply(omega, configs)
            e_loc_omega = ham.local_value(wf, omega, configs, amp_omega)
            # N² = <ψ|(1−βH)²|ψ>/<ψ|ψ> = 1 − 2β<H> + β²<H²> with
            # <H> = E[Re E_loc] and <H²> = E[|E_loc|²] (H Hermitian) —
            # |·|² and Re are no-ops for real-log ansatzes.
            e_mean = common.pmean(jnp.mean(jnp.real(e_loc_omega)), axis_name)
            e2_mean = common.pmean(jnp.mean(jnp.abs(e_loc_omega) ** 2),
                                   axis_name)
            ite_norm = jnp.sqrt(1.0 - 2.0 * beta * e_mean
                                + beta ** 2 * e2_mean)

            def loss_fn(p):
                amp = wf.apply(p, configs)
                # (ψ_ω − βHψ_ω)/ψ: 1/ψ contributes conj(sign)/exp(log)
                # (|s| = 1; conj is a no-op for real ±1 signs).
                target = lax.stop_gradient(
                    amp_omega.sign * jnp.conj(amp.sign)
                    * (1.0 - beta * e_loc_omega)
                    * jnp.exp(amp_omega.log - amp.log)) / norm_var
                r = _normalized_psi(amp.log)
                return _residual_l2(r - target)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            grads = common.pmean(grads, axis_name)
            loss = common.pmean(loss, axis_name)
            params, opt_state = self.optax_opt.update(
                grads, opt_state, params, state.epoch)

            ema_norm = _ema_update(ema_norm, ite_norm, ema_count)
            ema_energy = _ema_update(ema_energy, e_mean, ema_count)
            ema_count = ema_count + 1.0
            carry = (params, opt_state, smp, ema_norm, ema_energy, ema_count)
            return carry, loss

        init = (state.params, state.opt_state, sampler,
                state.extra['ema_norm'], state.extra['ema_energy'],
                state.extra['ema_count'])
        (params, opt_state, sampler, ema_norm, ema_energy, ema_count), losses \
            = lax.scan(batch_step, init, None,
                       length=cfg.num_batches_per_epoch)

        extra = {
            'omega': omega,
            # update_normalization at epoch end (reference training.py:908).
            'ite_normalization': ema_norm,
            'ema_norm': ema_norm,
            'ema_energy': ema_energy,
            'ema_count': ema_count,
        }
        metrics = {
            'energy': ema_energy,
            'loss': jnp.mean(losses),
            'acceptance_rate': common.pmean(
                metropolis.acceptance_rate(sampler), axis_name),
        }
        new_state = TrainState(params, opt_state, sampler, state.epoch + 1,
                               extra)
        return new_state, metrics


# ======================================================================
# Supervised distillation toward a FIXED trained target wavefunction.
# ======================================================================

class SupervisedWavefunctionOptimizer(_SWOBase):
    """'SWO': |ψ|²-sampled adjusted L2 fit to a fixed target
    (reference training.py:135-212):
      loss = <(ψ − ψ_t·√2ⁿ)² / stop(ψ)²>.
    """

    name = 'SWO'

    def __init__(self, wf: Wavefunction, target_wf: Wavefunction, config):
        super().__init__(wf, config)
        self.target_wf = target_wf

    def init_state(self, key: jax.Array, target_params: Params,
                   n_local_chains: Optional[int] = None) -> TrainState:
        state = self._base_state(key, {}, n_local_chains)
        return state._replace(extra={'target': target_params})

    def epoch(self, state: TrainState, axis_name: Optional[str] = None
              ) -> Tuple[TrainState, Dict[str, jax.Array]]:
        cfg = self.config
        wf = self.wf
        target_params = state.extra['target']
        half_log2n = 0.5 * cfg.num_sites * np.log(2.0)

        def batch_step(carry, _):
            params, opt_state, smp = carry
            smp = metropolis.refresh_amplitudes(wf, params, smp)
            smp = self.sweeps(params, smp, cfg.num_monte_carlo_sweeps)
            configs = smp.configs
            amp_t = self.target_wf.apply(target_params, configs)

            def loss_fn(p):
                amp = wf.apply(p, configs)
                # ψ_t√2ⁿ / stop(ψ), computed in log space (conj(sign) is
                # the 1/ψ factor; no-op for real ±1 signs).
                target = lax.stop_gradient(
                    amp_t.sign * jnp.conj(amp.sign)
                    * jnp.exp(amp_t.log + half_log2n - amp.log))
                r = _normalized_psi(amp.log)
                return _residual_l2(r - target)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            grads = common.pmean(grads, axis_name)
            params, opt_state = self.optax_opt.update(
                grads, opt_state, params, state.epoch)
            return (params, opt_state, smp), common.pmean(loss, axis_name)

        sampler = metropolis.reset_stats(state.sampler)
        (params, opt_state, sampler), losses = lax.scan(
            batch_step, (state.params, state.opt_state, sampler), None,
            length=cfg.num_batches_per_epoch)

        metrics = {
            'loss': jnp.mean(losses),
            'acceptance_rate': common.pmean(
                metropolis.acceptance_rate(sampler), axis_name),
        }
        new_state = TrainState(params, opt_state, sampler, state.epoch + 1,
                               state.extra)
        return new_state, metrics


class LogOverlapSWO(SupervisedWavefunctionOptimizer):
    """Log-overlap gradient against a fixed target (reference
    training.py:298-404): ∇L = <∇logψ> − <ratio·∇logψ>/<ratio>,
    ratio = ψ_t/ψ (conjugate-correct complex form via
    `_log_overlap_grads` when the student has a complex log)."""

    name = 'LogOverlapSWO'

    def epoch(self, state: TrainState, axis_name: Optional[str] = None
              ) -> Tuple[TrainState, Dict[str, jax.Array]]:
        cfg = self.config
        wf = self.wf
        target_params = state.extra['target']

        def batch_step(carry, _):
            params, opt_state, smp = carry
            smp = metropolis.refresh_amplitudes(wf, params, smp)
            smp = self.sweeps(params, smp, cfg.num_monte_carlo_sweeps)
            configs = smp.configs
            m = configs.shape[0]

            amp = wf.apply(params, configs)
            amp_t = self.target_wf.apply(target_params, configs)
            ratio = lax.stop_gradient(
                amp_t.sign * jnp.conj(amp.sign)
                * jnp.exp(amp_t.log - amp.log))

            grads, mean_ratio = _log_overlap_grads(wf, params, configs,
                                                   ratio, axis_name)
            params, opt_state = self.optax_opt.update(
                grads, opt_state, params, state.epoch)
            return (params, opt_state, smp), jnp.abs(mean_ratio)

        sampler = metropolis.reset_stats(state.sampler)
        (params, opt_state, sampler), ratios = lax.scan(
            batch_step, (state.params, state.opt_state, sampler), None,
            length=cfg.num_batches_per_epoch)

        metrics = {
            'mean_ratio': jnp.mean(ratios),
            'acceptance_rate': common.pmean(
                metropolis.acceptance_rate(sampler), axis_name),
        }
        new_state = TrainState(params, opt_state, sampler, state.epoch + 1,
                               state.extra)
        return new_state, metrics


class DualSamplingSWO(_SWOBase):
    """Raw-L2 fit with half the chains sampling |ψ|² and half |ψ_t|²
    (reference training.py:407-503; the sampling bias is deliberately not
    corrected, per its docstring)."""

    name = 'DualSamplingSWO'

    def __init__(self, wf: Wavefunction, target_wf: Wavefunction, config):
        super().__init__(wf, config)
        self.target_wf = target_wf
        # The target chains get their own registry-resolved sweeps (not a
        # raw metropolis.run_sweeps): parallel-tempering sampler states
        # must be driven by their matching sweep discipline.
        self.target_sweeps = common.make_sweeps_fn(target_wf, config)

    def init_state(self, key: jax.Array, target_params: Params,
                   n_local_chains: Optional[int] = None) -> TrainState:
        half = (n_local_chains or self.config.batch_size) // 2
        k1, k2, k3 = jax.random.split(key, 3)
        params = self.wf.init(k1)
        sampler = metropolis.init_sampler_for(
            k2, self.wf, params, self.config, half)
        target_sampler = metropolis.init_sampler_for(
            k3, self.target_wf, target_params, self.config, half)
        return TrainState(
            params=params,
            opt_state=self.optax_opt.init(params),
            sampler=sampler,
            epoch=jnp.zeros((), jnp.int32),
            extra={'target': target_params,
                   'target_sampler': target_sampler},
        )

    def epoch(self, state: TrainState, axis_name: Optional[str] = None
              ) -> Tuple[TrainState, Dict[str, jax.Array]]:
        cfg = self.config
        wf, target_wf = self.wf, self.target_wf
        target_params = state.extra['target']
        half_log2n = 0.5 * cfg.num_sites * np.log(2.0)

        def batch_step(carry, _):
            params, opt_state, smp, t_smp = carry
            smp = metropolis.refresh_amplitudes(wf, params, smp)
            smp = self.sweeps(params, smp, cfg.num_monte_carlo_sweeps)
            t_smp = self.target_sweeps(target_params, t_smp,
                                       cfg.num_monte_carlo_sweeps)
            configs = jnp.concatenate([smp.configs, t_smp.configs], axis=0)
            amp_t = target_wf.apply(target_params, configs)
            psi_target = amp_t.sign * jnp.exp(amp_t.log + half_log2n)

            def loss_fn(p):
                amp = wf.apply(p, configs)
                psi = amp.sign * jnp.exp(amp.log)
                return _residual_l2(psi - psi_target)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            grads = common.pmean(grads, axis_name)
            params, opt_state = self.optax_opt.update(
                grads, opt_state, params, state.epoch)
            return (params, opt_state, smp, t_smp), common.pmean(
                loss, axis_name)

        sampler = metropolis.reset_stats(state.sampler)
        t_sampler = metropolis.reset_stats(state.extra['target_sampler'])
        (params, opt_state, sampler, t_sampler), losses = lax.scan(
            batch_step,
            (state.params, state.opt_state, sampler, t_sampler), None,
            length=cfg.num_batches_per_epoch)

        metrics = {
            'loss': jnp.mean(losses),
            'acceptance_rate': common.pmean(
                metropolis.acceptance_rate(sampler), axis_name),
        }
        extra = dict(state.extra)
        extra['target_sampler'] = t_sampler
        new_state = TrainState(params, opt_state, sampler, state.epoch + 1,
                               extra)
        return new_state, metrics


class BasisIterationSWO(_SWOBase):
    """Raw-L2 fit over shuffled minibatches of the FULL fixed-Sz basis —
    no MCMC (reference training.py:215-295, whose tf.data CSV pipeline
    also carried a `scipy.special.binomi` typo; here the basis is an
    in-memory array batched by a permutation carried in the train state)."""

    name = 'BasisIterSWO'

    def __init__(self, wf: Wavefunction, target_wf: Wavefunction, config,
                 basis_array: Optional[np.ndarray] = None):
        super().__init__(wf, config)
        self.target_wf = target_wf
        if basis_array is None:
            if config.basis_file_path:
                basis_array = basis_lib.load_basis_file(config.basis_file_path)
            else:
                basis_array = basis_lib.enumerate_sz_basis(
                    config.num_sites,
                    basis_lib.n_down_for(config.num_sites,
                                         getattr(config, 'total_sz2', 0)))
        # Host numpy (DEVELOPMENT.md constant rule); traced gathers use
        # jnp.take so the table lowers as a host constant.
        self.basis = np.asarray(basis_array, np.float32)

    # Dummy-sampler width: a fixed power of two so (a) TrainState
    # checkpoint templates are environment-independent — sizing to
    # jax.device_count() made a checkpoint saved on an 8-device host
    # unrestorable on a 1-device host — and (b) it shards over any
    # realistic chains mesh (whose size divides 256), unlike
    # config.batch_size, which for this optimizer is the basis-iteration
    # batch and need not be mesh-divisible.
    _DUMMY_CHAINS = 256

    def init_state(self, key: jax.Array, target_params: Params,
                   n_local_chains: Optional[int] = None) -> TrainState:
        del n_local_chains  # no MCMC chains in this optimizer
        k1, k2, k3 = jax.random.split(key, 3)
        params = self.wf.init(k1)
        # A dummy sampler keeps TrainState uniform across optimizers; its
        # contents are never read by this optimizer.
        sampler = metropolis.init_sampler_for(
            k2, self.wf, params, self.config, self._DUMMY_CHAINS)
        return TrainState(
            params=params,
            opt_state=self.optax_opt.init(params),
            sampler=sampler,
            epoch=jnp.zeros((), jnp.int32),
            # Derived from the run key so config.seed changes the basis
            # iteration order (round-2 review: a constant key made every
            # run of every config iterate the same permutation sequence).
            extra={'target': target_params, 'data_key': k3},
        )

    def _epoch_indices(self, perm_key: jax.Array,
                       axis_name: Optional[str]) -> jax.Array:
        """Flat basis-row index stream for one epoch.

        Shuffled full-basis iteration (reference training.py:242-251): a
        fresh permutation per epoch, consumed in order; when the epoch
        needs more rows than the basis holds, the permutation is tiled
        (cycling without replacement inside each pass, static shapes).
        Under shard_map the data_key is replicated, so each device reads a
        DISJOINT slice of the shared permutation (offset by its
        axis_index) — multi-device distillation then genuinely adds
        samples instead of pmean-ing N identical gradients.
        """
        cfg = self.config
        n_rows = cfg.num_batches_per_epoch * cfg.batch_size
        perm = jax.random.permutation(perm_key, self.basis.shape[0])
        dev = 0 if axis_name is None else lax.axis_index(axis_name)
        offsets = (jnp.arange(n_rows) + dev * n_rows) % self.basis.shape[0]
        return perm[offsets]

    def epoch(self, state: TrainState, axis_name: Optional[str] = None
              ) -> Tuple[TrainState, Dict[str, jax.Array]]:
        cfg = self.config
        wf = self.wf
        target_params = state.extra['target']
        half_log2n = 0.5 * cfg.num_sites * np.log(2.0)
        batch = cfg.batch_size

        data_key, perm_key = jax.random.split(state.extra['data_key'])
        idx = self._epoch_indices(perm_key, axis_name)
        idx = idx.reshape(cfg.num_batches_per_epoch, batch)

        def batch_step(carry, batch_idx):
            params, opt_state = carry
            configs = jnp.take(self.basis, batch_idx, axis=0)
            amp_t = self.target_wf.apply(target_params, configs)
            psi_target = amp_t.sign * jnp.exp(amp_t.log + half_log2n)

            def loss_fn(p):
                amp = wf.apply(p, configs)
                psi = amp.sign * jnp.exp(amp.log)
                return _residual_l2(psi - psi_target)

            loss, grads = jax.value_and_grad(loss_fn)(params)
            grads = common.pmean(grads, axis_name)
            params, opt_state = self.optax_opt.update(
                grads, opt_state, params, state.epoch)
            return (params, opt_state), common.pmean(loss, axis_name)

        (params, opt_state), losses = lax.scan(
            batch_step, (state.params, state.opt_state), idx)

        extra = dict(state.extra)
        extra['data_key'] = data_key
        metrics = {'loss': jnp.mean(losses)}
        new_state = TrainState(params, opt_state, state.sampler,
                               state.epoch + 1, extra)
        return new_state, metrics
