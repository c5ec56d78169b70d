"""Physics validation of compute_dtype='bfloat16' on the 6x6 flagship.

Before the bench flips the flagship SR epoch to bf16 conv forwards, the
convergence must match fp32: same config/schedule as RESULTS.md row 4
(5x32 symmetrized conv, dense minSR, M=4096), 700 epochs, comparing the
last-100-epoch mean against QMC.  fp32 reached rel err ~2.3e-4 in
round 1; bf16 passes if its floor is statistically indistinguishable.

The Jacobian rows inherit bf16 forward noise (~1e-2 relative); minSR's
relative diag shift (1e-2) dominates that perturbation, and the [M,M]
assembly + Cholesky stay f32-highest — this run is the empirical check.

Run: PYTHONPATH=. python examples/bf16_flagship_validation.py [dtype] [epochs]
"""
import os
import sys, time
import numpy as np, jax
from cgs_vmc_jax import lattice
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS

DTYPE = sys.argv[1] if len(sys.argv) > 1 else 'bfloat16'
EPOCHS = int(sys.argv[2]) if len(sys.argv) > 2 else 700
E_REF = -0.678872 * 36

cfg = Config(num_sites=36, size_x=6, size_y=6,
             wavefunction_type='conv_2d', num_conv_layers=5,
             num_conv_filters=32, kernel_size=3,
             wavefunction_optimizer_type='SR',
             batch_size=1024, num_batches_per_epoch=4,
             num_equilibration_sweeps=10, num_monte_carlo_sweeps=2,
             learning_rates=[0.02, 0.008, 0.003, 0.001],
             learning_rate_stops=[200, 400, 550],
             optimizer='gradient', heisenberg_jx=-1.0,
             sr_diag_shift=1e-2, sr_solver='dense', sr_delta_clip=1.0,
             sr_reject_residual=0.5, sr_jacobian_chunk=512,
             energy_chunk_samples=128, symmetrize=True,
             compute_dtype=DTYPE, seed=13)
wf = build_wavefunction(cfg)
ham = HeisenbergHamiltonian(lattice.square_lattice_bonds(6, 6), -1.0, 1.0,
                            sample_chunk=128)
opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
state = opt.init_state(jax.random.key(cfg.seed))
epoch_fn = jax.jit(opt.epoch)

energies, t0 = [], time.time()
for i in range(EPOCHS):
    state, m = epoch_fn(state)
    energies.append(float(m['energy']))
    if i % 50 == 49:
        e = np.mean(energies[-20:])
        print(f'epoch {i+1}: E/N={e/36:.6f} '
              f'rel_err={(e-E_REF)/abs(E_REF):.2e} '
              f't={time.time()-t0:.0f}s', flush=True)

tail = np.asarray(energies[-100:])
print(f'{DTYPE}: last-100 mean E/N={tail.mean()/36:.6f} '
      f'rel_err={(tail.mean()-E_REF)/abs(E_REF):.2e} '
      f'spread={tail.std()/36:.2e}  wall={time.time()-t0:.0f}s '
      f'({(time.time()-t0)/EPOCHS:.3f}s/epoch)', flush=True)
