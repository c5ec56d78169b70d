"""Staggered magnetization of the square-lattice AFM from the flagship
artifacts: 1/L extrapolation of the static structure factor.

The longitudinal structure factor at the ordering vector,
S(pi,pi) = (1/N) <|sum_i e^{i pi (x_i+y_i)} Sz_i|^2>, is DIAGONAL in the
computational basis (ops/observables.py): its estimator needs only the
sampled configurations, no connected-config fan-out — so a flagship
measurement costs little more than the Metropolis sweeps themselves.
Diagonal observables are also invariant under the Marshall gauge the
artifacts were trained in (the gauge U = prod_B sigma^z_i is diagonal,
so |<R|U psi>|^2 = |<R|psi>|^2).

For the SU(2)-symmetric ground state the full staggered moment obeys
m_s^2 = 3 <(m_s^z)^2> = 3 S(pi,pi)/N, with the Huse finite-size law
3 S(pi,pi)/N = m_s^2(inf) + c/L + O(1/L^2).  Measuring the three deep
artifacts (L = 6, 10, 12) and extrapolating the 1/L fit gives m_s to
compare against QMC m_s = 0.3070(3) (Sandvik PRB 56, 11678 (1997)).
The reference framework ships no observables beyond the energy
(cgs_vmc/evaluation.py:74-152).

Usage (GPU): PYTHONPATH=. \
    python examples/staggered_flagship.py [SAMPLES=400] [BATCH=1024]
"""
import os
import json
import sys
import time

import numpy as np
import jax
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()
import jax.numpy as jnp
from cgs_vmc_jax.utils import codec

from cgs_vmc_jax.config import Config
from cgs_vmc_jax.evaluate import binned_error
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.observables import SpinStructureFactor, square_positions
from cgs_vmc_jax.sampler import metropolis

SAMPLES = int(sys.argv[1]) if len(sys.argv) > 1 else 400
BATCH = int(sys.argv[2]) if len(sys.argv) > 2 else 1024

ARTIFACTS = [
    ('artifacts/heisenberg_6x6_deep48.msgpack', 6, 7, 48),
    ('artifacts/heisenberg_10x10_deep32_cont.msgpack', 10, 7, 32),
    ('artifacts/heisenberg_12x12_deep32.msgpack', 12, 7, 32),
]

t0 = time.time()
rows = []

# Per-L resume cache: each finished lattice size is persisted and
# skipped on restart.  Keyed on (L, SAMPLES, BATCH).
PARTIAL = 'artifacts/staggered_partial.json'
_cache = {}
if os.path.exists(PARTIAL):
    for r in json.load(open(PARTIAL)):
        if r['samples'] == SAMPLES and r['batch'] == BATCH:
            _cache[r['L']] = r

for path, L, layers, filters in ARTIFACTS:
    if L in _cache:
        r = _cache[L]
        rows.append((L, r['s'], r['s_err'], r['y'], r['y_err'],
                     np.asarray(r['sq_map'], np.float64)))
        print(f'L={L:2d}: cached from {PARTIAL}: 3S/N = {r["y"]:.5f} '
              f'+/- {r["y_err"]:.5f}', flush=True)
        continue
    n = L * L
    cfg = Config(num_sites=n, size_x=L, size_y=L,
                 wavefunction_type='conv_2d', num_conv_layers=layers,
                 num_conv_filters=filters, kernel_size=3, symmetrize=True,
                 heisenberg_jx=-1.0, batch_size=BATCH, seed=91)
    wf = build_wavefunction(cfg)
    params = codec.from_bytes(
        wf.init(jax.random.key(0)), open(path, 'rb').read())
    obs = SpinStructureFactor([np.pi, np.pi], square_positions(L, L))

    @jax.jit
    def sq_mean(configs, _obs=obs):
        return jnp.mean(_obs.local_value(None, None, configs))

    # Full-BZ structure factor S(q) = <|DFT2(Sz)|^2>/N as REAL cos/sin
    # contractions: at L<=12 two [L^2, L^2] GEMMs are trivial.
    xs = np.arange(L)
    ang = 2.0 * np.pi / L * (xs[:, None] * xs[None, :])  # [k, x]
    cosm, sinm = jnp.asarray(np.cos(ang), jnp.float32), jnp.asarray(
        np.sin(ang), jnp.float32)

    @jax.jit
    def sq_map(configs, _L=L):
        sz = 0.5 * configs.reshape(-1, _L, _L).astype(jnp.float32)
        # exp(-i qx x) exp(-i qy y) = (cx - i sx)(cy - i sy); contract x
        # then y, tracking the four real quadrature components.
        cx = jnp.einsum('bxy,kx->bky', sz, cosm)
        sx = jnp.einsum('bxy,kx->bky', sz, sinm)
        re = (jnp.einsum('bky,ly->bkl', cx, cosm)
              - jnp.einsum('bky,ly->bkl', sx, sinm))
        im = (jnp.einsum('bky,ly->bkl', cx, sinm)
              + jnp.einsum('bky,ly->bkl', sx, cosm))
        return jnp.mean(re ** 2 + im ** 2, axis=0) / (_L * _L)

    def sweeps(p, s, k, _wf=wf):
        s = metropolis.refresh_amplitudes(_wf, p, s)
        return metropolis.run_sweeps(_wf, p, s, k)

    sweeps = jax.jit(sweeps, static_argnums=2)
    smp = metropolis.init_sampler(jax.random.key(cfg.seed), wf, params,
                                  n, BATCH)
    # Equilibration must scale with the ORDER-building time, not the
    # energy-relaxation time: from a random Sz=0 init, local pair
    # exchanges build Neel order diffusively, ~L^2 sweeps — the first
    # run's 100 sweeps left L=12 at 3S/N = 0.0898 vs the ~0.13 QMC
    # finite-size trend while its ENERGY was already converged.
    equil = max(100, 8 * L * L)
    decorr = max(2, L // 3)
    # Chunked equilibration with progress prints: the queue watchdog
    # kills a stage whose log goes stale for 15 min, and the L=12 leg
    # legitimately spends ~25 min here.
    # Short per-call chunks, each ended by a scalar device_get so the
    # dispatch queue stays shallow and progress stays visible.
    done = 0
    step_sz = max(8, 2500 // (L * L))
    while done < equil:
        step = min(step_sz, equil - done)
        smp = sweeps(params, smp, step)
        _ = jax.device_get(smp.configs[0, 0])  # end of this chunk
        done += step
        if done % 200 < step_sz or done == equil:
            print(f'  L={L}: equilibrated {done}/{equil} sweeps '
                  f't={time.time()-t0:.0f}s', flush=True)
    vals = []
    bz = np.zeros((L, L), np.float64)
    for i in range(SAMPLES):
        vals.append(float(sq_mean(smp.configs)))
        bz += np.asarray(sq_map(smp.configs))
        smp = sweeps(params, smp, decorr)
        if (i + 1) % 100 == 0:
            print(f'  L={L}: {i + 1}/{SAMPLES} samples '
                  f't={time.time()-t0:.0f}s', flush=True)
    bz /= SAMPLES
    s_mean, s_err = binned_error(np.asarray(vals))
    # Cross-check: the FFT map's (pi,pi) entry is the same estimator.
    assert abs(bz[L // 2, L // 2] - s_mean) < 20 * s_err + 1e-6, (
        bz[L // 2, L // 2], s_mean)
    y, yerr = 3.0 * s_mean / n, 3.0 * s_err / n
    rows.append((L, s_mean, s_err, y, yerr, bz))
    print(f'L={L:2d}: S(pi,pi) = {s_mean:.4f} +/- {s_err:.4f}   '
          f'3S/N = {y:.5f} +/- {yerr:.5f}   t={time.time()-t0:.0f}s',
          flush=True)
    os.makedirs('artifacts', exist_ok=True)
    with open(PARTIAL, 'w') as f:
        json.dump([dict(L=int(Lr), s=s, s_err=se, y=yy, y_err=ye,
                        sq_map=np.asarray(b).tolist(),
                        samples=SAMPLES, batch=BATCH)
                   for Lr, s, se, yy, ye, b in rows], f)

# Weighted least squares y = m2 + c/L over the three sizes.
Ls = np.array([r[0] for r in rows], np.float64)
ys = np.array([r[3] for r in rows], np.float64)
ws = 1.0 / np.array([r[4] for r in rows], np.float64) ** 2
A = np.stack([np.ones_like(Ls), 1.0 / Ls], axis=1)
cov = np.linalg.inv(A.T @ (ws[:, None] * A))
coef = cov @ (A.T @ (ws * ys))
m2, m2_err = coef[0], np.sqrt(cov[0, 0])
m_s = np.sqrt(max(m2, 0.0))
m_s_err = m2_err / (2 * m_s) if m_s > 0 else float('nan')
print(f'\n1/L fit: 3S(pi,pi)/N = {m2:.5f}(+/-{m2_err:.5f}) '
      f'+ {coef[1]:.4f}/L')
print(f'm_s = {m_s:.4f} +/- {m_s_err:.4f}   (QMC: 0.3070 +/- 0.0003, '
      f'Sandvik 1997)')

# Robustness: the exactly-determined quadratic through all three points.
Aq = np.stack([np.ones_like(Ls), 1.0 / Ls, 1.0 / Ls ** 2], axis=1)
cq = np.linalg.solve(Aq, ys)
print(f'quadratic (3-point, exact): intercept {cq[0]:.5f} '
      f'-> m_s = {np.sqrt(max(cq[0], 0.0)):.4f}')

os.makedirs('artifacts', exist_ok=True)
with open('artifacts/staggered_flagship.json', 'w') as f:
    json.dump({'rows': [dict(L=int(L), s=s, s_err=se, y=y, y_err=ye,
                             sq_map=bz.tolist())
                        for L, s, se, y, ye, bz in rows],
               'fit_linear': {'m2': float(m2), 'm2_err': float(m2_err),
                              'c': float(coef[1]), 'm_s': float(m_s),
                              'm_s_err': float(m_s_err)},
               'fit_quadratic_intercept': float(cq[0]),
               'samples': SAMPLES, 'batch': BATCH}, f)
if os.path.exists(PARTIAL):
    os.remove(PARTIAL)
print('wrote artifacts/staggered_flagship.json', flush=True)
