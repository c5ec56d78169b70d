"""Sampler-path throughput comparison on the current backend (meant for
the GPU: PYTHONPATH=. python examples/bench_samplers.py).

Measures, at 2048 chains on the 6x6 lattice:
 * conv_2d (5x16,k3) generic single-try sampler sweeps/s,
 * conv_2d multiple-try Metropolis for k in {2, 4, 8} — MTM evaluates k
   candidates per step in ONE batched forward, so for latency-bound
   ansatzes the effective proposal throughput scales with k,
 * conv_2d generic with compute_dtype=bfloat16 (bf16 tensor cores),
 * ProjectedBDG generic (slogdet per proposal) vs the Sherman-Morrison
   incremental sampler (sampler/fast_pbdg.py).

Timing protocol: warm up one call, then best-of-3 with a device->host
value read inside the timed region.
"""
import os
import functools
import time

import jax
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()
import jax.numpy as jnp

from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.sampler import fast_pbdg, metropolis, mtm

N_CHAINS = 2048
N_SITES = 36
SWEEPS = 20


def time_sweeps(label, run, state, n_reps=3, sweeps=SWEEPS,
                proposals_per_sweep=N_SITES):
    out = run(state)
    jax.block_until_ready(out)
    best = float('inf')
    for _ in range(n_reps):
        t0 = time.perf_counter()
        out = run(out)
        _ = float(out.num_accepted.sum())   # forced device->host read
        best = min(best, time.perf_counter() - t0)
    sps = sweeps / best
    print(f'{label:44s} {sps:10.1f} sweeps/s   '
          f'({sps * N_CHAINS * proposals_per_sweep / 1e6:8.1f} M moves/s)',
          flush=True)
    return sps


def conv_state(cfg, seed=0):
    wf = build_wavefunction(cfg)
    params = wf.init(jax.random.key(seed))
    state = metropolis.init_sampler(jax.random.key(seed + 1), wf, params,
                                    N_SITES, N_CHAINS)
    return wf, params, state


def main():
    print(f'backend: {jax.default_backend()}  devices: {jax.devices()}',
          flush=True)

    base = Config(num_sites=36, size_x=6, size_y=6,
                  wavefunction_type='conv_2d', num_conv_layers=5,
                  num_conv_filters=16, kernel_size=3, heisenberg_jx=-1.0)

    # --- conv_2d generic.
    wf, params, state = conv_state(base)

    @functools.partial(jax.jit, static_argnums=())
    def generic(s):
        return metropolis.run_sweeps(wf, params, s, SWEEPS)
    time_sweeps('conv_2d 5x16 generic f32', generic, state)

    # --- conv_2d bf16 compute.
    cfg_bf16 = base.replace(compute_dtype='bfloat16')
    wf_b, params_b, state_b = conv_state(cfg_bf16)

    @jax.jit
    def generic_bf16(s):
        return metropolis.run_sweeps(wf_b, params_b, s, SWEEPS)
    time_sweeps('conv_2d 5x16 generic bf16', generic_bf16, state_b)

    # --- conv_2d MTM (k candidates per batched forward).  An MTM sweep
    # makes n_sites steps x k proposals each; report both sweeps/s and
    # proposal throughput.
    for k in (2, 4, 8):
        @functools.partial(jax.jit, static_argnums=())
        def run_mtm(s, k=k):
            return mtm.run_sweeps(wf, params, s, SWEEPS, k=k)
        time_sweeps(f'conv_2d 5x16 MTM k={k}', run_mtm, state,
                    proposals_per_sweep=N_SITES * k)

    # --- ProjectedBDG: generic slogdet-per-move vs Sherman-Morrison.
    from cgs_vmc_jax.models.determinant import ProjectedBDG
    det_wf = ProjectedBDG(N_SITES)
    det_params = det_wf.init(jax.random.key(5))
    det_state = metropolis.init_sampler(jax.random.key(6), det_wf,
                                        det_params, N_SITES, N_CHAINS)

    @jax.jit
    def det_generic(s):
        return metropolis.run_sweeps(det_wf, det_params, s, SWEEPS)
    time_sweeps('pbdg 36-site generic (slogdet/move)', det_generic,
                det_state)

    @jax.jit
    def det_fast(s):
        return fast_pbdg.run_sweeps(det_wf, det_params, s, SWEEPS)
    time_sweeps('pbdg 36-site Sherman-Morrison', det_fast, det_state)

    # --- Jastrow: generic O(n^2) quadratic form vs exact O(n) delta.
    from cgs_vmc_jax.models.jastrow import JastrowWavefunction
    from cgs_vmc_jax.sampler import fast_jastrow
    jas_wf = JastrowWavefunction(N_SITES)
    jas_params = jas_wf.init(jax.random.key(7))
    jas_state = metropolis.init_sampler(jax.random.key(8), jas_wf,
                                        jas_params, N_SITES, N_CHAINS)

    @jax.jit
    def jas_generic(s):
        return metropolis.run_sweeps(jas_wf, jas_params, s, SWEEPS)
    time_sweeps('jastrow 36-site generic (s\'Ss/move)', jas_generic,
                jas_state)

    @jax.jit
    def jas_fast(s):
        return fast_jastrow.run_sweeps(jas_wf, jas_params, s, SWEEPS)
    time_sweeps('jastrow 36-site O(n) delta', jas_fast, jas_state)

    # --- MADE exact ancestral sampling: one call = one i.i.d. config per
    # chain (N_CHAINS fresh samples), zero autocorrelation.  Report as
    # "sweeps"/s where one call stands in for a full decorrelation run.
    from cgs_vmc_jax.models.autoregressive import AutoregressiveSpinModel
    from cgs_vmc_jax.sampler import fast_ar
    ar_wf = AutoregressiveSpinModel(N_SITES, hidden=64)
    ar_params = ar_wf.init(jax.random.key(9))
    ar_state = metropolis.init_sampler(jax.random.key(10), ar_wf,
                                       ar_params, N_SITES, N_CHAINS)

    @jax.jit
    def ar_draw(s):
        def body(st, _):
            return fast_ar.run_sweeps(ar_wf, ar_params, st, 1), None
        out, _ = jax.lax.scan(body, s, None, length=SWEEPS)
        return out
    time_sweeps('made 36-site exact draws (per i.i.d. batch)', ar_draw,
                ar_state, proposals_per_sweep=1)


if __name__ == '__main__':
    main()
