"""Triplet (spin) gap of the 6x6 AFM Heisenberg lattice.

Trains the lowest Sz=1-sector state (config.total_sz2=2 — the exchange
move conserves Sz, so the init pins the sector) with a C4v-symmetrized
conv ansatz warm-started from the committed Sz=0 ground-state artifact,
and reports the finite-size triplet gap

    Delta = E(Sz=1) - E0,   E0/N = -0.678872 (QMC, BASELINE.md)

Spin-flip symmetrization is OFF: the flip maps the Sz=+1 sector onto
Sz=-1, so only the C4v orbit is projected.  The ground-state artifact's
conv weights load unchanged (the symmetry projection is evaluation-time
orbit averaging; parameters are the inner network's).

M=8192, 600 epochs.  Saves the sector
artifact every 100 epochs so an interrupted run keeps its progress.

  PYTHONPATH=. python examples/spin_gap_6x6.py
"""
import os
import sys
import time

import numpy as np
import jax
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cgs_vmc_jax.utils import codec
from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS

E0_QMC_PER_SITE = -0.678872
# GAP66_SZ2 = 2*Sz selects the sector: 2 (triplet, default) or 4
# (quintet) — the Sz=2 energy gives the Anderson-tower consistency
# check E(S) - E0 ~ S(S+1)/(2*theta*N): Delta_2/Delta_1 must be ~3.
SZ2 = int(os.environ.get('GAP66_SZ2', '2'))
GROUND_ARTIFACT = 'artifacts/heisenberg_6x6_symconv_v2.msgpack'
if SZ2 == 2:
    OUT = 'artifacts/heisenberg_6x6_triplet.msgpack'
else:
    OUT = f'artifacts/heisenberg_6x6_sz{SZ2}.msgpack'
    # the adjacent sector's converged state is the best warm start
    if os.path.exists('artifacts/heisenberg_6x6_triplet.msgpack'):
        GROUND_ARTIFACT = 'artifacts/heisenberg_6x6_triplet.msgpack'
EPOCHS = int(os.environ.get('GAP66_EPOCHS', '600'))
BATCH = int(os.environ.get('GAP66_BATCH', '2048'))  # CPU smoke: 64

cfg = Config(num_sites=36, size_x=6, size_y=6,
             wavefunction_type='conv_2d', num_conv_layers=5,
             num_conv_filters=32, kernel_size=3,
             wavefunction_optimizer_type='SR',
             total_sz2=SZ2,
             batch_size=BATCH, num_batches_per_epoch=4,
             num_equilibration_sweeps=10, num_monte_carlo_sweeps=2,
             learning_rates=[0.01, 0.004, 0.0015],
             learning_rate_stops=[200, 400],
             optimizer='gradient', heisenberg_jx=-1.0,
             sr_diag_shift=1e-2, sr_solver='dense', sr_delta_clip=1.0,
             sr_reject_residual=0.5, sr_jacobian_chunk=1024,
             energy_chunk_samples=128,
             symmetrize=True, symmetrize_spin_flip=False, seed=31)

bonds = lattice.square_lattice_bonds(6, 6)
wf = build_wavefunction(cfg)
ham = HeisenbergHamiltonian(bonds, -1.0, 1.0,
                            sample_chunk=cfg.energy_chunk_samples)
opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
state = opt.init_state(jax.random.key(cfg.seed))
if os.path.exists(OUT):
    params = codec.from_bytes(state.params, open(OUT, 'rb').read())
    print(f'warm start: resumed sector artifact {OUT}')
else:
    params = codec.from_bytes(
        state.params, open(GROUND_ARTIFACT, 'rb').read())
    print(f'warm start: ground artifact {GROUND_ARTIFACT}')
state = state._replace(params=params)

epoch_fn = jax.jit(opt.epoch)
t0 = time.time()
energies = []
for i in range(EPOCHS):
    state, metrics = epoch_fn(state)
    e = float(metrics['energy'])
    energies.append(e)
    if (i + 1) % 20 == 0:
        print(f'epoch {i+1:4d}  E={e:.5f}  E/N={e/36:.6f}  '
              f'var={float(metrics["energy_variance"]):.4f}  '
              f'acc={float(metrics["acceptance_rate"]):.3f}  '
              f'({time.time()-t0:.0f}s)', flush=True)
    if (i + 1) % 100 == 0:
        with open(OUT, 'wb') as f:
            f.write(codec.to_bytes(state.params))

with open(OUT, 'wb') as f:
    f.write(codec.to_bytes(state.params))

tail = np.asarray(energies[-100:])
e_t = float(tail.mean())
err = float(tail.std() / np.sqrt(len(tail)))
e0 = E0_QMC_PER_SITE * 36
print(f'\nE(Sz={SZ2//2}) = {e_t:.5f} +/- {err:.5f}   E/N = {e_t/36:.6f}')
print(f'E0 (QMC) = {e0:.5f}')
print(f'sector gap Delta_{SZ2//2} = {e_t - e0:.5f} +/- {err:.5f}')
print('NOTE: epoch means are an upper-bound estimate; for the headline '
      'number run the split-program MC eval on the saved artifact with '
      'total_sz2=2.')
