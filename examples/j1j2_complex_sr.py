"""Frustrated J1-J2 chain with a complex-phase ansatz + dense SR.

The Majumdar-Ghosh point (J2/J1 = 1/2) has an exactly known ground
energy E0 = -3N/8; no Marshall gauge exists at generic J2, so a
positive ansatz cannot represent the sign structure — the complex
phase network learns it instead.  Runs on CPU in ~1 minute (N=8) or
one GPU; scale N / the networks up from here.
"""
import os
import numpy as np
import jax
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()

from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim.sr import StochasticReconfiguration

N = 8
J2 = 0.5

config = Config(
    num_sites=N, wavefunction_type='complex',
    composite_wavefunction_types=('fully_connected', 'fully_connected'),
    num_fc_layers=1, fc_layer_size=16,
    heisenberg_j2=J2,
    batch_size=256, num_batches_per_epoch=4,
    num_equilibration_sweeps=10, num_monte_carlo_sweeps=1,
    optimizer='gradient', learning_rates=[0.05, 0.02],
    learning_rate_stops=[40],
    sr_solver='dense', sr_diag_shift=1e-3, sr_delta_clip=10.0, seed=7)

wf = build_wavefunction(config)
bonds, mask = lattice.j1j2_chain_bonds(N)
ham = HeisenbergHamiltonian(bonds, couplings=(1.0 - mask) + J2 * mask)
opt = StochasticReconfiguration(wf, ham, config)
state = opt.init_state(jax.random.key(config.seed))
epoch = jax.jit(lambda s: opt.epoch(s))

e0 = -3.0 * N / 8.0  # exact Majumdar-Ghosh energy
for i in range(150):
    state, metrics = epoch(state)
    if i % 15 == 14:
        e = float(metrics['energy'])
        print(f'epoch {i+1:3d}: E={e:.4f}  exact={e0}  '
              f'rel_err={(e - e0) / abs(e0):.2e}  '
              f"acc={float(metrics['acceptance_rate']):.2f}", flush=True)
