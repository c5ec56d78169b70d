"""RESULTS.md row-1 follow-up: is the N=20 chain's 8.6e-3 gap the
ansatz or the optimizer?

Row 1 trains the reference-parity config (fully_connected 3x80 +
EnergyGradient/adam, BASELINE config #1) and floors at 8.6e-3.  This
runs the SAME 3x80 FC ansatz under dense minSR — if SR lands ~1e-3 or
better, the gap was the optimizer (plain energy gradient), not the
MLP's expressivity; if it stays ~1e-2, the flat MLP itself is the
floor.  ED reference E = -8.904400 (N=20 chain, Marshall gauge).

Run (GPU): PYTHONPATH=. \
    python examples/chain20_fc_sr.py
"""
import os
import time

import numpy as np
import jax
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()

from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS

N = 20
E_ED = -8.904400
EPOCHS = 1600

# First attempt (400 epochs, lr 0.05->0.01) was still descending at its
# budget's end (rel_err 0.31 -> 0.18 over the last 250 epochs) — not a
# floor, an under-budgeted run.  This schedule matches the budget SR
# actually needs from a random FC init.
cfg = Config(num_sites=N, wavefunction_type='fully_connected',
             num_fc_layers=3, fc_layer_size=80,
             wavefunction_optimizer_type='SR',
             batch_size=1024, num_batches_per_epoch=2,
             num_equilibration_sweeps=10, num_monte_carlo_sweeps=2,
             learning_rates=[0.1, 0.05, 0.02, 0.008],
             learning_rate_stops=[400, 800, 1200],
             optimizer='gradient', heisenberg_jx=-1.0,
             sr_diag_shift=1e-3, sr_solver='dense', sr_delta_clip=1.0,
             sr_reject_residual=0.5, seed=12)
wf = build_wavefunction(cfg)
ham = HeisenbergHamiltonian(lattice.chain_bonds(N), -1.0, 1.0)
opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
state = opt.init_state(jax.random.key(cfg.seed))
epoch_fn = jax.jit(opt.epoch)

t0 = time.time()
energies = []
for i in range(EPOCHS):
    state, metrics = epoch_fn(state)
    energies.append(float(metrics['energy']))
    if (i + 1) % 50 == 0:
        e = energies[-1]
        print(f'epoch {i+1:4d}  E={e:.5f}  rel_err='
              f'{(e - E_ED) / abs(E_ED):.2e}  '
              f'acc={float(metrics["acceptance_rate"]):.3f}  '
              f'({time.time()-t0:.0f}s)', flush=True)

tail = np.asarray(energies[-80:])
e_t, sem = float(tail.mean()), float(tail.std() / np.sqrt(len(tail)))
print(f'\nFC(3x80) + SR: E = {e_t:.5f} +/- {sem:.5f}  '
      f'rel_err = {(e_t - E_ED) / abs(E_ED):.2e}  (ED {E_ED})')
print('row-1 EnergyGradient result was E = -8.8282, rel_err 8.6e-3')
