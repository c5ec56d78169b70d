"""Measure S(pi,pi) AND the energy of the SAME chains on one trained
conv artifact — the decisive staggered-order diagnostic.

Round-5 finding that motivates the energy column: inverting the
committed S(q) maps (examples/correlation_length.py) shows the L=12
staggered run's nearest-neighbour correlator C(1) = -0.0995 where the
state's measured energy (E/N = -0.670) requires SzSz(1) ~ -0.112 — an
11% short-range discrepancy that CANNOT be a property of the state
(its energy pins C(1)); the chains in that run were therefore not
sampling |psi|^2, despite a reproducible S(pi,pi) plateau across 100
vs 1152 equilibration sweeps.  This script measures E/N, 3S(pi,pi)/N,
and C(1) on the same chains, with trend prints during equilibration,
so sampling bias is visible instead of silent.

Because the local energy of a near-eigenstate is nearly
configuration-independent (zero-variance principle: var(E_loc) ~ 0.27
at 12x12 vs |E| = 96), an energy readback is almost blind to sampling
bias — a "converged energy" NEVER certified equilibration.  The
decisive test is the two-sided bracket this script runs by default:
equilibrate once from RANDOM chains (staggered order builds up) and
once from scrambled-NEEL chains (order decays down).  Agreement of the
two S(pi,pi) values certifies equilibration; a gap measures the
residual bias.

Usage (GPU): PYTHONPATH=. python \
    examples/measure_sq.py <artifact> <L> <layers> <filters> \
    [samples=400] [batch=1024] [equil=8*L*L] [seed=91] [inits=random,neel]
"""
import os
import sys
import threading
import time

import numpy as np
import jax
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()
import jax.numpy as jnp
from cgs_vmc_jax.utils import codec

from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.evaluate import binned_error
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.ops.observables import SpinStructureFactor, square_positions
from cgs_vmc_jax.sampler import metropolis

QMC = {36: -0.678872, 100: -0.671549, 144: -0.670685}

path, L, layers, filters = (sys.argv[1], int(sys.argv[2]),
                            int(sys.argv[3]), int(sys.argv[4]))
SAMPLES = int(sys.argv[5]) if len(sys.argv) > 5 else 400
BATCH = int(sys.argv[6]) if len(sys.argv) > 6 else 1024
n = L * L
EQUIL = int(sys.argv[7]) if len(sys.argv) > 7 else max(100, 8 * n)
SEED = int(sys.argv[8]) if len(sys.argv) > 8 else 91
INITS = (sys.argv[9] if len(sys.argv) > 9 else 'random,neel').split(',')

cfg = Config(num_sites=n, size_x=L, size_y=L,
             wavefunction_type='conv_2d', num_conv_layers=layers,
             num_conv_filters=filters, kernel_size=3, symmetrize=True,
             heisenberg_jx=-1.0, batch_size=BATCH, seed=SEED)
wf = build_wavefunction(cfg)
params = codec.from_bytes(
    wf.init(jax.random.key(0)), open(path, 'rb').read())
obs = SpinStructureFactor([np.pi, np.pi], square_positions(L, L))
ham = HeisenbergHamiltonian(lattice.square_lattice_bonds(L, L), -1.0, 1.0)
sq_mean = jax.jit(lambda c: jnp.mean(obs.local_value(None, None, c)))


@jax.jit
def energy_mean(c):
    chunks = c.reshape(128, -1, n)
    return jnp.mean(jax.lax.map(lambda x: ham.local_value(wf, params, x),
                                chunks))


@jax.jit
def c1_mean(c):
    # nearest-neighbour SzSz along x, torus-averaged
    sz = 0.5 * c.reshape(-1, L, L)
    return jnp.mean(jnp.sum(sz * jnp.roll(sz, 1, axis=1), axis=(1, 2)) / n)


def sweeps(p, s, k):
    s = metropolis.refresh_amplitudes(wf, p, s)
    return metropolis.run_sweeps(wf, p, s, k)


sweeps = jax.jit(sweeps, static_argnums=2)
t0 = time.time()
decorr = max(2, L // 3)


def _beat(window_s=2700, interval_s=240):
    # long fresh-shape compiles print nothing; keep the log alive
    def run():
        while time.time() - t0 < window_s:
            time.sleep(interval_s)
            print(f'  [heartbeat t={time.time()-t0:.0f}s]', flush=True)
    threading.Thread(target=run, daemon=True).start()


_beat()


def neel_scrambled(rng, chains):
    """Checkerboard Neel chains, each scrambled by n/4 random exchange
    pairs (keeps Sz = 0 and high staggered order; decorrelates chains)."""
    x = np.arange(L)
    neel = ((-1.0) ** np.add.outer(x, x)).reshape(-1).astype(np.float32)
    cfgs = np.tile(neel, (chains, 1))
    for c in range(chains):
        for _ in range(n // 4):
            ups = np.flatnonzero(cfgs[c] > 0)
            dns = np.flatnonzero(cfgs[c] < 0)
            i, j = rng.choice(ups), rng.choice(dns)
            cfgs[c, i], cfgs[c, j] = cfgs[c, j], cfgs[c, i]
    return cfgs


def run_leg(init):
    smp = metropolis.init_sampler(jax.random.key(SEED), wf, params, n, BATCH)
    if init == 'neel':
        cfgs = neel_scrambled(np.random.default_rng(SEED), BATCH)
        smp = smp._replace(configs=jnp.asarray(cfgs))
    done, step_sz = 0, max(8, 2500 // n)
    while done < EQUIL:
        step = min(step_sz, EQUIL - done)
        smp = sweeps(params, smp, step)
        _ = jax.device_get(smp.configs[0, 0])  # end of this chunk
        done += step
        if done % 200 < step_sz or done == EQUIL:
            e = float(energy_mean(smp.configs))
            print(f'  [{init}] equil {done}/{EQUIL}: E/N={e/n:+.6f} '
                  f'3S/N={3*float(sq_mean(smp.configs))/n:.5f} '
                  f'C1={float(c1_mean(smp.configs)):+.5f} '
                  f'acc={float(metropolis.acceptance_rate(smp)):.3f} '
                  f't={time.time()-t0:.0f}s', flush=True)
    vals, evals, c1s = [], [], []
    for i in range(SAMPLES):
        vals.append(float(sq_mean(smp.configs)))
        c1s.append(float(c1_mean(smp.configs)))
        if i % 4 == 0:  # energy is the expensive estimator; 1-in-4 is plenty
            evals.append(float(energy_mean(smp.configs)))
        smp = sweeps(params, smp, decorr)
        if (i + 1) % 100 == 0:
            print(f'  [{init}] {i + 1}/{SAMPLES} samples '
                  f't={time.time()-t0:.0f}s', flush=True)
    s_mean, s_err = binned_error(np.asarray(vals))
    e_mean, e_err = binned_error(np.asarray(evals))
    c1_m = float(np.mean(c1s))
    qmc = QMC.get(n)
    eline = f'E/N = {e_mean/n:+.6f} +/- {e_err/n:.6f}'
    if qmc:
        eline += f' (QMC {qmc}; rel_err {(e_mean/n-qmc)/abs(qmc):.2e})'
    print(f'[{init}] {path} (L={L}, {layers}x{filters}, batch {BATCH}, '
          f'equil {EQUIL}, seed {SEED}):')
    print(f'[{init}]   S(pi,pi) = {s_mean:.4f} +/- {s_err:.4f}   '
          f'3S/N = {3*s_mean/n:.5f} +/- {3*s_err/n:.5f}')
    print(f'[{init}]   C1(SzSz nn-x) = {c1_m:+.5f}   {eline}   '
          f't={time.time()-t0:.0f}s', flush=True)
    return 3 * s_mean / n, 3 * s_err / n


res = {init: run_leg(init) for init in INITS}
if len(res) == 2:
    (ya, ea), (yb, eb) = res.values()
    gap = abs(ya - yb)
    sig = gap / np.hypot(ea, eb)
    print(f'BRACKET: 3S/N {" vs ".join(INITS)} = '
          f'{ya:.5f} vs {yb:.5f}  (gap {gap:.5f}, {sig:.1f} sigma) — '
          f'{"EQUILIBRATED" if sig < 3 else "NOT equilibrated: bias >= gap"}',
          flush=True)
