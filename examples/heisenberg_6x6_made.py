"""MCMC-free 6x6 Heisenberg: autoregressive MADE ansatz, exact sampling.

Capability demo (models/autoregressive.py): every epoch's samples are
i.i.d. from the exactly normalized |psi|^2 — no equilibration, no
decorrelation sweeps, no autocorrelation in the estimators.  A flat
MADE is weaker variationally than the symmetrized CNN flagship (no 2-D
weight sharing), so the target here is the capability + a clean
few-times-1e-3 energy, not the 1e-4-class CNN floor.

Run (GPU): PYTHONPATH=. \
    python examples/heisenberg_6x6_made.py
"""

import os
import time, numpy as np, jax, jax.numpy as jnp
from cgs_vmc_jax.utils import codec
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()
from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS

OUT = 'artifacts/heisenberg_6x6_made.msgpack'
N = 36
E_REF = -0.678872 * N
cfg = Config(num_sites=N, size_x=6, size_y=6,
             wavefunction_type='made',
             # 1 hidden layer keeps the O(hidden)-per-site incremental
             # ancestral sampler; a 0.1 lr start risks the AR
             # mode-collapse measured on the complex composite.
             num_fc_layers=1, fc_layer_size=256,
             wavefunction_optimizer_type='SR',
             batch_size=1024, num_batches_per_epoch=4,
             num_equilibration_sweeps=1, num_monte_carlo_sweeps=1,
             learning_rates=[0.05, 0.02, 0.008],
             learning_rate_stops=[200, 450],
             optimizer='gradient', heisenberg_jx=-1.0,
             sr_diag_shift=1e-3, sr_solver='dense', sr_delta_clip=1.0,
             energy_chunk_samples=256, sr_jacobian_chunk=512, seed=17)
wf = build_wavefunction(cfg)
ham = HeisenbergHamiltonian(lattice.square_lattice_bonds(6, 6), -1.0, 1.0,
                            sample_chunk=cfg.energy_chunk_samples)
opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
state = opt.init_state(jax.random.key(cfg.seed))
epoch_fn = jax.jit(opt.epoch)

t0 = time.time()
print('6x6 MADE (MCMC-free) SR: compiling...', flush=True)
for i in range(700):
    state, metrics = epoch_fn(state)
    if i % 20 == 19:
        e = float(metrics['energy'])
        print(f'epoch {i+1}: E/N={e/N:.6f} err={(e-E_REF)/abs(E_REF):.2e} '
              f'acc={float(metrics["acceptance_rate"]):.2f} '
              f't={time.time()-t0:.0f}s', flush=True)
    if i % 100 == 99:
        with open(OUT, 'wb') as f:
            f.write(codec.to_bytes(jax.device_get(state.params)))

with open(OUT, 'wb') as f:
    f.write(codec.to_bytes(jax.device_get(state.params)))
print(f'DONE; artifact {OUT}', flush=True)
