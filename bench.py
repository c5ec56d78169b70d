"""Benchmark on one NVIDIA GPU.  Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "sweeps/s", "device": {...},
   "card": "<name>, <power limit>", "extra": {...}}

Primary metric: full Metropolis exchange sweeps/s with 2048 parallel
chains of a 6x6 (36-site) RBM with H=64 hidden units — one sweep = n_sites
independent per-chain exchange moves — through the fused Pallas-Triton
kernel (sampler/kernels.py).  Work is checked via the acceptance rate.

extra:
  * the same sweeps as plain XLA (kernels.rbm_sweeps_xla);
  * one RBM training epoch (20-site chain, pure RBM, EnergyGradient, 512
    chains, the README recipe) with the kernel and with plain XLA, run in
    turns (kernel, XLA, XLA, kernel);
  * one flagship SR epoch (6x6 symmetrized conv 5x32, dense minSR, 4096
    samples; `flagship_config`) and its samples/s;
  * i.i.d. draws/s of the 36-site MADE ansatz.
Timings are host clock around work that ends in block_until_ready, median
of the reps.  The script fails when JAX finds no GPU.
"""

import json
import subprocess
import time

import jax
import jax.numpy as jnp

from cgs_vmc_jax.utils import compile_cache

N_SITES = 36
N_CHAINS = 2048
HIDDEN = 64
SWEEPS_PER_CALL = 800
SWEEP_REPS = 5
EPOCH_REPS = 5


def _median(times):
    return sorted(times)[len(times) // 2]


def _timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0


def bench_rbm_sweeps():
    from cgs_vmc_jax import gpu_checks
    from cgs_vmc_jax.sampler import kernels
    w, b, a, configs = gpu_checks.rbm_problem(N_SITES, HIDDEN, N_CHAINS)
    n_steps = SWEEPS_PER_CALL * N_SITES
    picks = kernels.sample_picks(jax.random.key(2), n_steps, N_SITES,
                                 N_CHAINS)
    result = {}
    for name, fn in (('kernel', kernels.rbm_sweeps),
                     ('xla', kernels.rbm_sweeps_xla)):
        out, _ = _timed(fn, w, b, a, configs, picks, jax.random.key(3))
        times, accepted = [], 0.0
        for rep in range(SWEEP_REPS):
            out, dt = _timed(fn, w, b, a, out.configs, picks,
                             jax.random.key(10 + rep))
            times.append(dt)
            accepted += float(out.num_accepted.sum())
        acceptance = accepted / (SWEEP_REPS * n_steps * N_CHAINS)
        assert 0.05 < acceptance < 0.98, f'implausible acceptance {acceptance}'
        result[name] = SWEEPS_PER_CALL / _median(times)
        result[f'{name}_acceptance'] = acceptance
    return result


def bench_rbm_epoch():
    """Seconds per RBM training epoch with the kernel and with plain XLA."""
    from cgs_vmc_jax.config import Config
    from cgs_vmc_jax.sampler import fast_rbm, kernels
    from cgs_vmc_jax.train import _init_ground_state
    config = Config(num_sites=20, wavefunction_type='rbm', num_fc_layers=0,
                    wavefunction_optimizer_type='EnergyGradient',
                    heisenberg_jx=-1.0, batch_size=512)
    runs = {}
    for name, sweeps_fn in (('kernel', kernels.rbm_sweeps),
                            ('xla', kernels.rbm_sweeps_xla)):
        wf, _, opt, state = _init_ground_state(config)
        opt.sweeps = (lambda params, smp, n, sweeps_fn=sweeps_fn, wf=wf:
                      fast_rbm.run_sweeps(wf, params, smp, n, sweeps_fn))
        epoch = jax.jit(opt.epoch)
        (state, _), _ = _timed(epoch, state)
        runs[name] = [epoch, state, []]
    for name in ('kernel', 'xla', 'xla', 'kernel'):
        epoch, state, times = runs[name]
        for _ in range(EPOCH_REPS):
            (state, metrics), dt = _timed(epoch, state)
            assert jnp.isfinite(metrics['energy'])
            times.append(dt)
        runs[name][1] = state
    return {name: _median(times) for name, (_, _, times) in runs.items()}


def flagship_config():
    """The 6x6 symmetrized conv 5x32 with dense minSR at 4096 samples per
    epoch (RESULTS.md row 4); the chunk sizes are exact chunkings."""
    from cgs_vmc_jax.config import Config
    return Config(num_sites=36, size_x=6, size_y=6,
                  wavefunction_type='conv_2d', num_conv_layers=5,
                  num_conv_filters=32, kernel_size=3,
                  wavefunction_optimizer_type='SR',
                  batch_size=1024, num_batches_per_epoch=4,
                  num_equilibration_sweeps=10, num_monte_carlo_sweeps=2,
                  learning_rates=[0.02], learning_rate_stops=[],
                  optimizer='gradient', heisenberg_jx=-1.0,
                  sr_diag_shift=1e-2, sr_solver='dense',
                  sr_delta_clip=1.0, symmetrize=True,
                  sr_matmul_precision='high',
                  energy_chunk_samples=128, sr_jacobian_chunk=512, seed=11)


def bench_flagship_sr_epoch():
    from cgs_vmc_jax.train import _init_ground_state
    config = flagship_config()
    _, _, opt, state = _init_ground_state(config)
    epoch = jax.jit(opt.epoch)
    (state, _), compile_s = _timed(epoch, state)
    times = []
    for _ in range(EPOCH_REPS):
        (state, metrics), dt = _timed(epoch, state)
        assert jnp.isfinite(metrics['energy'])
        times.append(dt)
    samples = config.batch_size * config.num_batches_per_epoch
    return _median(times), samples, compile_s


def bench_made_exact_sampling():
    """i.i.d. ancestral draws/s from the 36-site MADE ansatz (H=64)."""
    from cgs_vmc_jax.models.autoregressive import AutoregressiveSpinModel
    wf = AutoregressiveSpinModel(N_SITES, hidden=64, num_hidden_layers=1)
    params = wf.init(jax.random.key(11))
    batch = 2048
    draw = jax.jit(lambda key: wf.sample(params, jax.random.split(key,
                                                                  batch)))
    _timed(draw, jax.random.key(0))
    times = [_timed(draw, jax.random.key(rep + 1))[1] for rep in range(3)]
    return batch / _median(times)


def main():
    compile_cache.configure()
    device = jax.devices()[0]
    if device.platform != 'gpu':
        raise SystemExit(f'bench.py needs an NVIDIA GPU; JAX found '
                         f'{device.platform!r}')
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]

    sweeps = bench_rbm_sweeps()
    rbm_epoch = bench_rbm_epoch()
    sr_epoch_s, sr_samples, sr_compile_s = bench_flagship_sr_epoch()
    extra = {
        'rbm_kernel_acceptance': sweeps['kernel_acceptance'],
        'rbm_xla_sweeps_per_sec': sweeps['xla'],
        'rbm_epoch_s_kernel': rbm_epoch['kernel'],
        'rbm_epoch_s_xla': rbm_epoch['xla'],
        'sr_epoch_s': sr_epoch_s,
        'sr_epoch_samples_per_sec': sr_samples / sr_epoch_s,
        'sr_epoch_compile_s': sr_compile_s,
        'made_exact_samples_per_sec': bench_made_exact_sampling(),
    }
    print(json.dumps({
        'metric': 'rbm_sweeps_per_sec_6x6_h64_2048chains',
        'value': sweeps['kernel'],
        'unit': 'sweeps/s',
        'device': {'platform': device.platform, 'kind': device.device_kind,
                   'count': jax.device_count()},
        'card': card,
        'extra': extra,
    }))


if __name__ == '__main__':
    main()
