"""Wavefunction evaluators: Monte Carlo observables and full-basis dumps.

Re-designs of the reference evaluators (cgs_vmc/evaluation.py:30-246):

 * MonteCarloOperatorEvaluator — equilibrate, then alternate (record local
   values / decorrelate) entirely inside compiled calls.  Error analysis is
   done RIGHT: binning over decorrelated samples gives the standard error
   of the mean (the reference printed ``sqrt(std)/len``, a dimensionally
   wrong formula, cgs_vmc/run_energy_evaluation.py:87).
 * VectorWavefunctionEvaluator — batched amplitude dump over an enumerated
   basis for fidelity/overlap checks against ED.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from cgs_vmc_jax import basis as basis_lib
from cgs_vmc_jax.models.base import Params, Wavefunction
from cgs_vmc_jax.ops.heisenberg import Operator
from cgs_vmc_jax.sampler import metropolis


class EvalResult(NamedTuple):
    mean: float
    error: float           # standard error of the mean (binned)
    values: np.ndarray     # per-sample batch means [num_samples]
    acceptance_rate: float


def evaluate_operator(
    wf: Wavefunction,
    params: Params,
    operator: Operator,
    config,
    key: Optional[jax.Array] = None,
    state: Optional[metropolis.SamplerState] = None,
) -> EvalResult:
    """MC expectation <O> = mean(O_loc) with binned error bars
    (reference evaluation.py:74-152 + run_energy_evaluation.py:63-88).

    With config.num_devices > 1 the chains shard over a 'chains' mesh and
    each recorded sample is the pmean over all devices (benchmark config
    #5: device-parallel evaluation farm).
    """
    if state is None:
        if key is None:
            key = jax.random.key(config.seed)
        state = metropolis.init_sampler_for(key, wf, params, config)
    state = metropolis.refresh_amplitudes(wf, params, state)

    from cgs_vmc_jax.optim.common import make_sweeps_fn
    sweeps_fn = make_sweeps_fn(wf, config)

    if getattr(config, 'split_eval', False) and \
            getattr(config, 'num_devices', 1) <= 1:
        return _evaluate_operator_split(wf, params, operator, config,
                                        state, sweeps_fn)

    def local_run(smp, axis_name=None):
        smp = metropolis.reset_stats(smp)
        smp = sweeps_fn(params, smp, config.num_equilibration_sweeps)

        def step(smp, _):
            # Re: complex-log ansatzes yield complex local values whose
            # expectation is real (Hermitian O); the imaginary part is
            # pure sampling noise.  No-op for real ansatzes.
            value = jnp.real(jnp.mean(
                operator.local_value(wf, params, smp.configs)))
            if axis_name is not None:
                value = jax.lax.pmean(value, axis_name)
            smp = sweeps_fn(params, smp, config.num_monte_carlo_sweeps)
            return smp, value

        smp, values = lax.scan(step, smp, None,
                               length=config.num_evaluation_samples)
        acc = metropolis.acceptance_rate(smp)
        if axis_name is not None:
            acc = jax.lax.pmean(acc, axis_name)
        return smp, values, acc

    if getattr(config, 'num_devices', 1) > 1:
        from functools import partial
        from jax.sharding import PartitionSpec as P
        from cgs_vmc_jax.parallel import mesh as mesh_lib

        device_mesh = mesh_lib.make_mesh(config.num_devices)
        sampler_specs = jax.tree.map(lambda _: P(mesh_lib.CHAINS_AXIS),
                                     state)
        run = jax.jit(jax.shard_map(
            partial(local_run, axis_name=mesh_lib.CHAINS_AXIS),
            mesh=device_mesh,
            in_specs=(sampler_specs,),
            out_specs=(sampler_specs, P(), P()),
            check_vma=False,
        ))
        state = jax.tree.map(
            lambda x, s: jax.device_put(
                x, jax.sharding.NamedSharding(device_mesh, s)),
            state, sampler_specs)
    else:
        run = jax.jit(local_run)

    state, values, acc = run(state)
    values = np.asarray(values)
    mean, err = binned_error(values)
    return EvalResult(
        mean=float(mean),
        error=float(err),
        values=values,
        acceptance_rate=float(acc),
    )


def _evaluate_operator_split(wf, params, operator, config, state,
                             sweeps_fn) -> EvalResult:
    """Split-program evaluation: sweeps and the local-value estimator are
    SEPARATE small compiled programs driven by a Python loop, instead of
    one program scanning over all samples.

    Identical estimator semantics to the monolithic path; keeps each
    compiled program small when num_evaluation_samples × the full
    connected-config fan-out of a big symmetrized ansatz makes one
    program unwieldy (``cgs eval --override split_eval=true``)."""
    import functools

    @functools.partial(jax.jit, static_argnums=2)
    def sweep_prog(p, smp, n):
        return sweeps_fn(p, smp, n)

    @jax.jit
    def value_prog(p, configs):
        return jnp.real(jnp.mean(operator.local_value(wf, p, configs)))

    state = metropolis.reset_stats(state)
    state = sweep_prog(params, state, config.num_equilibration_sweeps)
    values = []
    for _ in range(config.num_evaluation_samples):
        values.append(float(value_prog(params, state.configs)))
        state = sweep_prog(params, state,
                           config.num_monte_carlo_sweeps)
    values = np.asarray(values)
    mean, err = binned_error(values)
    return EvalResult(
        mean=float(mean),
        error=float(err),
        values=values,
        acceptance_rate=float(metropolis.acceptance_rate(state)),
    )


def binned_error(values: np.ndarray, min_bins: int = 16
                 ) -> tuple[float, float]:
    """Mean and autocorrelation-robust standard error via binning analysis:
    double the bin size until the binned SEM plateaus (take its max)."""
    values = np.asarray(values, dtype=np.float64)
    n = len(values)
    mean = values.mean()
    if n < 2:
        return mean, float('nan')
    best = values.std(ddof=1) / np.sqrt(n)
    size = 2
    while n // size >= min_bins:
        nb = n // size
        binned = values[:nb * size].reshape(nb, size).mean(axis=1)
        best = max(best, binned.std(ddof=1) / np.sqrt(nb))
        size *= 2
    return mean, best


def evaluate_vector(
    wf: Wavefunction,
    params: Params,
    config,
    basis_array: Optional[np.ndarray] = None,
    output_path: Optional[str] = None,
    epoch_num: int = 0,
) -> np.ndarray:
    """Evaluates psi on every basis configuration; optionally writes the
    reference's ``wavefunction_epoch_{n}.txt`` ``(re,im)`` format
    (cgs_vmc/evaluation.py:223-246).  Returns raw amplitudes, normalized
    to unit maximum magnitude (global scale is physically meaningless)."""
    if basis_array is None:
        if config.basis_file_path:
            basis_array = basis_lib.load_basis_file(config.basis_file_path)
        else:
            basis_array = basis_lib.enumerate_sz_basis(
                config.num_sites,
                basis_lib.n_down_for(config.num_sites,
                                     getattr(config, 'total_sz2', 0)))
    configs = jnp.asarray(basis_array, jnp.float32)

    batch = max(config.batch_size, 1)
    apply_fn = jax.jit(lambda c: wf.apply(params, c))
    signs, logs = [], []
    for start in range(0, configs.shape[0], batch):
        chunk = configs[start:start + batch]
        pad = batch - chunk.shape[0]
        if pad:
            chunk = jnp.concatenate([chunk, chunk[:pad]], axis=0)
        amp = apply_fn(chunk)
        take = batch - pad
        signs.append(np.asarray(amp.sign[:take]))
        logs.append(np.asarray(amp.log[:take]))
    sign = np.concatenate(signs)
    log = np.concatenate(logs)
    psi = sign * np.exp(log - np.real(log).max())

    if output_path is None and config.checkpoint_dir:
        output_path = os.path.join(
            config.checkpoint_dir, f'wavefunction_epoch_{epoch_num}.txt')
    if output_path:
        with open(output_path, 'w') as f:
            for value in psi:
                f.write(f'({np.real(value)},{np.imag(value)})\n')
    return psi


def exact_expectation(
    wf: Wavefunction,
    params: Params,
    operator: Operator,
    num_sites: int,
    n_down: Optional[int] = None,
    batch: int = 4096,
) -> float:
    """Deterministic <O> over the FULL fixed-Sz basis (no MCMC):
    sum_R |ψ(R)|² O_loc(R) / sum_R |ψ(R)|².

    The zero-variance / debugging companion to `evaluate_operator` —
    practical up to num_sites ≈ 20.  Evaluated in batches so large
    sectors don't blow up the connected-config fan-out.

    NOTE: the forwards here run EAGERLY (op-by-op) — fine on CPU where
    the suite uses it, but on an accelerator that is one dispatch per
    primitive and the unchunked connected-config intermediates can
    exhaust device memory.  There, jit a chunked contraction instead (see
    examples/order_param_4x4_check.py).
    """
    states = basis_lib.enumerate_sz_basis(num_sites, n_down)
    logs, values = [], []
    for start in range(0, states.shape[0], batch):
        chunk = jnp.asarray(states[start:start + batch])
        amp = wf.apply(params, chunk)
        logs.append(np.real(np.asarray(amp.log)).astype(np.float64))
        values.append(np.asarray(
            operator.local_value(wf, params, chunk, amp)))
    logs = np.concatenate(logs)
    values = np.concatenate(values)
    weights = np.exp(2.0 * (logs - logs.max()))
    weights /= weights.sum()
    return float(np.real(np.sum(weights * values)))


def overlap_with_vector(psi: np.ndarray, reference_vector: np.ndarray
                        ) -> float:
    """|<psi|phi>| / (|psi||phi|) — fidelity against an ED vector
    (complex-safe: conjugates psi)."""
    psi = np.asarray(psi)
    phi = np.asarray(reference_vector)
    return float(abs(np.vdot(psi, phi))
                 / (np.linalg.norm(psi) * np.linalg.norm(phi)))
