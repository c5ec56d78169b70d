"""Why the staggered-moment 1/L extrapolation failed: energy converges
QUADRATICALLY in the variational error, order parameters LINEARLY —
measured exactly at 4x4 where full sector ED is trivial.

Context: the deep flagship
artifacts give 3S(pi,pi)/N = 0.2089 / 0.1359 / 0.0897 at L = 6/10/12 —
convex-DOWN in 1/L, extrapolating to a negative intercept, while the
Huse law demands an approach to m_s^2 = 0.094 from above.  The L=12
value is reproducible across 100 vs 1152 equilibration sweeps (0.0898
vs 0.0897), so it is a property of the STATE, not the sampler.  This
script quantifies the mechanism at a size where everything is exact:

  1. ED ground state (Sz=0 sector, 12870 states) -> exact E0 and exact
     3S(pi,pi)/N at L=4.
  2. The flagship ansatz family (symmetrized conv 7x32) trained by
     dense-SR with snapshots at several depths; at each snapshot the
     FULL-BASIS contraction (evaluate.exact_expectation — zero MC
     noise) gives the state's true energy error AND its true
     3S(pi,pi)/N deficit.
  3. The staggered-measurement MC pipeline (same estimator as
     examples/staggered_flagship.py) run on the final snapshot must
     agree with its exact contraction — validating the pipeline so the
     L=6/10/12 numbers are trusted as measurements OF THOSE STATES.

The reference framework has no observables beyond the energy
(cgs_vmc/evaluation.py:74-152) and no exact-basis oracle.

Usage (GPU): PYTHONPATH=. \
    python examples/order_param_4x4_check.py
"""
import os
import json
import threading
import time

import numpy as np
import jax
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()
import jax.numpy as jnp

from cgs_vmc_jax import basis as basis_lib
from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.evaluate import binned_error
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.ops.observables import SpinStructureFactor, square_positions
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
from cgs_vmc_jax.sampler import metropolis
from cgs_vmc_jax.utils import ed

L = 4
N = L * L
EPOCHS = int(os.environ.get('OP44_EPOCHS', '500'))
SNAPSHOTS = sorted({int(s) for s in
                    os.environ.get('OP44_SNAPSHOTS',
                                   '25,75,200,500').split(',')
                    if 0 < int(s) <= EPOCHS})
BATCH = int(os.environ.get('OP44_BATCH', '1024'))
MC_SAMPLES = int(os.environ.get('OP44_MC_SAMPLES', '200'))

bonds = lattice.square_lattice_bonds(L, L)
obs = SpinStructureFactor([np.pi, np.pi], square_positions(L, L))

# ---- 1. exact ground state ------------------------------------------------
t0 = time.time()
e0, vec = ed.ground_state(N, bonds, j_x=-1.0, j_z=1.0, n_down=N // 2)
states = basis_lib.enumerate_sz_basis(N, N // 2)          # ED basis order
sz = 0.5 * states.astype(np.float64)                       # [dim, N]
phase = np.cos(np.pi * (np.add.outer(np.arange(L), np.arange(L))).reshape(-1))
m_stag = sz @ phase                                        # [dim]
s_exact = float(np.sum(vec ** 2 * m_stag ** 2) / N)
y_exact = 3.0 * s_exact / N
print(f'ED 4x4 (Sz=0, dim {states.shape[0]}): E0 = {e0:.6f}   '
      f'3S(pi,pi)/N = {y_exact:.5f}   t={time.time()-t0:.0f}s', flush=True)

# ---- 2. flagship-family training with exact snapshots ---------------------
cfg = Config(num_sites=N, size_x=L, size_y=L,
             wavefunction_type='conv_2d', num_conv_layers=7,
             num_conv_filters=32, kernel_size=3,
             wavefunction_optimizer_type='SR',
             batch_size=BATCH, num_batches_per_epoch=4,
             num_equilibration_sweeps=10, num_monte_carlo_sweeps=2,
             learning_rates=[0.02, 0.01, 0.004, 0.0015],
             learning_rate_stops=[125, 280, 400],
             optimizer='gradient', heisenberg_jx=-1.0,
             sr_diag_shift=1e-2, sr_solver='dense', sr_delta_clip=1.0,
             sr_reject_residual=0.5, symmetrize=True, seed=23)
wf = build_wavefunction(cfg)
ham = HeisenbergHamiltonian(bonds, -1.0, 1.0)
opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
state = opt.init_state(jax.random.key(cfg.seed))
epoch_fn = jax.jit(opt.epoch)

rows = []

# JITTED full-basis contraction (evaluate.exact_expectation runs the
# forwards eagerly — one dispatch per primitive on an accelerator, and
# the unchunked 2.16M-row conv intermediates outgrow device memory).
ham_meas = HeisenbergHamiltonian(bonds, -1.0, 1.0, sample_chunk=256)
_h_loc = jax.jit(lambda p, c: ham_meas.local_value(wf, p, c))
_s_loc = jax.jit(lambda c: obs.local_value(None, None, c))
_logpsi = jax.jit(lambda p, c: wf.apply(p, c).log)
_chunks = np.split(states, 6)  # 12870 = 6 x 2145, static shapes


def _exact(params, loc_fn):
    logs = np.concatenate([np.asarray(_logpsi(params, jnp.asarray(c)),
                                      np.float64) for c in _chunks])
    vals = np.concatenate([np.asarray(loc_fn(jnp.asarray(c)), np.float64)
                           for c in _chunks])
    w = np.exp(2.0 * (logs - logs.max()))
    return float(np.sum(w * vals) / np.sum(w))


def snapshot(label, params):
    e = _exact(params, lambda c: _h_loc(params, c))
    s = _exact(params, _s_loc)
    rel = (e - e0) / abs(e0)
    y = 3.0 * s / N
    deficit = (y_exact - y) / y_exact
    rows.append(dict(epoch=label, e=e, rel_err=rel, y=y, deficit=deficit))
    print(f'epoch {label:>4}: rel_err(E) = {rel:.3e}   3S/N = {y:.5f}   '
          f'order deficit = {100*deficit:+.2f}%   '
          f'[sqrt(rel_err) = {np.sqrt(max(rel, 0)):.3e}]', flush=True)


print('training symmetrized conv 7x32 at 4x4 (flagship family)...',
      flush=True)


def _compile_heartbeat(window_s=2700, interval_s=240):
    # Long fresh-shape compiles print nothing; keep the log alive over
    # the compile window only — after it, the per-epoch prints take over.
    t0 = time.time()

    def beat():
        while time.time() - t0 < window_s:
            time.sleep(interval_s)
            print(f'  [heartbeat t={time.time()-t0:.0f}s]', flush=True)

    threading.Thread(target=beat, daemon=True).start()


_compile_heartbeat()
t_tr = time.time()
for i in range(EPOCHS):
    state, metrics = epoch_fn(state)
    if i == 0 or (i + 1) % 25 == 0:
        # progress print (the float() read also bounds the number of
        # queued epochs)
        e = float(metrics['energy'])
        print(f'  epoch {i+1}/{EPOCHS}: E={e:.4f} '
              f't={time.time()-t_tr:.0f}s', flush=True)
    if (i + 1) in SNAPSHOTS:
        snapshot(i + 1, state.params)

# ---- 3. MC pipeline validation on the final snapshot ----------------------
params = state.params


def sweeps(p, s, k):
    s = metropolis.refresh_amplitudes(wf, p, s)
    return metropolis.run_sweeps(wf, p, s, k)


sweeps = jax.jit(sweeps, static_argnums=2)
sq_mean = jax.jit(lambda c: jnp.mean(obs.local_value(None, None, c)))
smp = metropolis.init_sampler(jax.random.key(91), wf, params, N, BATCH)
smp = sweeps(params, smp, max(100, 8 * L * L))
vals = []
for i in range(MC_SAMPLES):
    vals.append(float(sq_mean(smp.configs)))
    smp = sweeps(params, smp, 2)
s_mc, s_mc_err = binned_error(np.asarray(vals))
y_mc, y_mc_err = 3.0 * s_mc / N, 3.0 * s_mc_err / N
y_fin = rows[-1]['y']
sigma = abs(y_mc - y_fin) / y_mc_err
print(f'\nMC pipeline on final snapshot: 3S/N = {y_mc:.5f} +/- {y_mc_err:.5f}'
      f'   exact contraction {y_fin:.5f}   ({sigma:.1f} sigma)', flush=True)

print(f'\nexact 3S/N(L=4) = {y_exact:.5f}; the state reaches rel_err(E) '
      f'{rows[-1]["rel_err"]:.1e} with an order deficit of '
      f'{100*rows[-1]["deficit"]:+.2f}% — order-parameter error tracks '
      f'sqrt(energy error), so flagship states at 2.5-5e-4 carry '
      f'O(sqrt(5e-4)) ~ 2-4% amplitude error that the S(pi,pi) '
      f'estimator sees LINEARLY while the energy sees it squared.',
      flush=True)

os.makedirs('artifacts', exist_ok=True)
with open('artifacts/order_param_4x4.json', 'w') as f:
    json.dump({'ed': {'e0': float(e0), 'y_exact': float(y_exact)},
               'snapshots': rows,
               'mc_check': {'y': float(y_mc), 'y_err': float(y_mc_err),
                            'sigma': float(sigma)}}, f)
print('wrote artifacts/order_param_4x4.json', flush=True)
