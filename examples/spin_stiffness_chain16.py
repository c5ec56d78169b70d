"""Spin stiffness of the N=16 Heisenberg chain by twisted-boundary VMC.

rho_s = L * d^2 E0(phi) / dphi^2 at phi=0, with the twist phi
distributed uniformly over the ring (phi/L per bond,
lattice.twist_phases).  Measured the way the signal is actually
resolvable (round-5 redesign after the round-4 attempt):

* ansatz: complex(rbm x fc) — the fc x fc modulus net needs a ~1600-
  epoch anneal at N=16 (RESULTS.md row 1b), while the RBM modulus
  converges in a few hundred;
* twists large enough to beat the noise: Delta E_ED(phi=0.3) is only
  8e-4 at N=16, far below any independent-run error bar, so phi runs
  over {0, +/-1.2, +/-1.8, +/-2.4} where the signal is 0.013..0.05;
* warm starts: each phi point re-converges from the phi=0 artifact, so
  the (smooth-in-phi) variational bias largely cancels in
  E(phi) - E(0) — the classic correlated-sampling trick, applied at
  the optimization level;
* fit E(phi) = E0 + a*phi^2 + b*phi^4 over all 7 points;
  rho_s = 2*a*L, compared against the same fit through the exact
  twisted-ED energies (convention-free comparison).

Runs on the CPU (or the GPU without JAX_PLATFORMS=cpu):

  JAX_PLATFORMS=cpu PYTHONPATH=. \
      python examples/spin_stiffness_chain16.py
"""
import os
os.environ.setdefault('JAX_PLATFORMS', 'cpu')
import json
import time

import numpy as np
import jax

from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
from cgs_vmc_jax.utils import ed

N = 16
BONDS = lattice.chain_bonds(N)
PHIS = [1.2, 1.8, 2.4]          # +/- each, plus phi=0
EPOCHS_0 = 800                   # cold start at phi=0
EPOCHS_PHI = 320                 # warm re-converge per twist
TAIL = 150
ACF = 4.0                        # tail-mean err inflation (measured ~4)


def make_opt(phi: float, lrs, stops, seed: int):
    phases = lattice.twist_phases(N, BONDS, phi, size_x=N) if phi else None
    cfg = Config(num_sites=N, wavefunction_type='complex',
                 composite_wavefunction_types=['rbm', 'fully_connected'],
                 num_fc_layers=1, fc_layer_size=48,
                 batch_size=512, num_batches_per_epoch=2,
                 num_equilibration_sweeps=4, num_monte_carlo_sweeps=1,
                 learning_rates=lrs, learning_rate_stops=stops,
                 optimizer='gradient', heisenberg_jx=-1.0,
                 sr_diag_shift=1e-3, sr_solver='dense', sr_delta_clip=1.0,
                 seed=seed)
    wf = build_wavefunction(cfg)
    ham = HeisenbergHamiltonian(BONDS, -1.0, 1.0, twist_phases=phases)
    opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
    return opt, phases


def run(opt, n_epochs: int, params=None, seed: int = 0):
    state = opt.init_state(jax.random.key(seed))
    if params is not None:
        state = state._replace(params=params)
    epoch_fn = jax.jit(opt.epoch)
    energies = []
    for _ in range(n_epochs):
        state, m = epoch_fn(state)
        energies.append(float(np.real(m['energy'])))
    tail = np.asarray(energies[-TAIL:])
    return (state.params, float(tail.mean()),
            float(tail.std() / np.sqrt(len(tail) / ACF)))


t0 = time.time()
results = {}

opt0, _ = make_opt(0.0, [0.05, 0.02, 0.008], [250, 450], seed=3)
params0, e0, err0 = run(opt0, EPOCHS_0, seed=3)
e_ed0, _ = ed.ground_state(N, BONDS, j_x=-1.0, j_z=1.0)
print(f'phi=+0.00: VMC E = {e0:.5f} +/- {err0:.5f}   ED {e_ed0:.5f}   '
      f'rel {abs(e0 - e_ed0) / abs(e_ed0):.1e}   t={time.time()-t0:.0f}s',
      flush=True)
results[0.0] = (e0, err0, e_ed0)

for phi_mag in PHIS:
    for phi in (phi_mag, -phi_mag):
        opt_p, phases = make_opt(phi, [0.008, 0.004], [EPOCHS_PHI // 2],
                                 seed=5)
        _, e, err = run(opt_p, EPOCHS_PHI, params=params0, seed=5)
        e_ed, _ = ed.ground_state(N, BONDS, j_x=-1.0, j_z=1.0,
                                  twist_phases=phases)
        print(f'phi={phi:+.2f}: VMC E = {e:.5f} +/- {err:.5f}   '
              f'ED {e_ed:.5f}   rel {abs(e - e_ed) / abs(e_ed):.1e}   '
              f'dE_vmc = {e - e0:+.5f}  dE_ed = {e_ed - e_ed0:+.5f}   '
              f't={time.time()-t0:.0f}s', flush=True)
        results[phi] = (e, err, e_ed)

# Quadratic + quartic fit through all points (VMC and ED separately).
phis = np.asarray(sorted(results))
e_vmc = np.asarray([results[p][0] for p in phis])
e_err = np.asarray([results[p][1] for p in phis])
e_ed_v = np.asarray([results[p][2] for p in phis])
design = np.stack([np.ones_like(phis), phis**2, phis**4], axis=1)
w = 1.0 / np.maximum(e_err, 1e-6)
coef_vmc, *_ = np.linalg.lstsq(design * w[:, None], e_vmc * w, rcond=None)
coef_ed, *_ = np.linalg.lstsq(design, e_ed_v, rcond=None)
# 1-sigma on the phi^2 coefficient by parametric bootstrap over e_err.
rng = np.random.default_rng(0)
boots = []
for _ in range(400):
    samp = e_vmc + rng.normal(0.0, e_err)
    c, *_ = np.linalg.lstsq(design * w[:, None], samp * w, rcond=None)
    boots.append(c[1])
a_err = float(np.std(boots))

rho_vmc = 2.0 * coef_vmc[1] * N
rho_err = 2.0 * a_err * N
rho_ed = 2.0 * coef_ed[1] * N
print(f'\nfit (VMC): E(phi) = {coef_vmc[0]:.5f} + {coef_vmc[1]:.5f} phi^2 '
      f'+ {coef_vmc[2]:.6f} phi^4')
print(f'fit (ED) : E(phi) = {coef_ed[0]:.5f} + {coef_ed[1]:.5f} phi^2 '
      f'+ {coef_ed[2]:.6f} phi^4')
print(f'rho_s = L * d2E/dphi2: VMC {rho_vmc:.4f} +/- {rho_err:.4f}   '
      f'ED {rho_ed:.4f}   rel {abs(rho_vmc - rho_ed) / abs(rho_ed):.1%}')

os.makedirs('artifacts', exist_ok=True)
with open('artifacts/spin_stiffness_chain16.json', 'w') as f:
    json.dump({'phis': phis.tolist(), 'e_vmc': e_vmc.tolist(),
               'e_err': e_err.tolist(), 'e_ed': e_ed_v.tolist(),
               'rho_vmc': rho_vmc, 'rho_err': rho_err, 'rho_ed': rho_ed},
              f, indent=1)
print('wrote artifacts/spin_stiffness_chain16.json', flush=True)
