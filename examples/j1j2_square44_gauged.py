"""Frustrated J1-J2 square lattice at the maximally frustrated point,
through the CLI-reachable machinery: Marshall-gauged couplings + a
symmetrized complex-phase conv ansatz + dense minSR.

4x4, J2/J1 = 0.5 (deep in the frustrated regime where NO positive
ansatz can represent the bare sign structure and the bipartite jx=-1
trick does not exist).  The gauge (lattice.j1j2_marshall_gauged) moves
the J1 sign structure into the Hamiltonian, the phase network learns
the J2 remainder.  ED oracle from utils/ed (dim 12,870).  Beyond the
reference: its only operator is the bipartite Heisenberg exchange
(cgs_vmc/operators.py) and all its ansatzes are real.

Run: PYTHONPATH=. python examples/j1j2_square44_gauged.py
"""
import os
import time
import numpy as np
import jax
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()
import jax.numpy as jnp
from cgs_vmc_jax.utils import codec

from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
from cgs_vmc_jax.train import build_hamiltonian
from cgs_vmc_jax.utils import ed

OUT = 'artifacts/j1j2_4x4_gauged_complex.msgpack'
J2 = 0.5

bonds, mask = lattice.j1j2_square_bonds(4, 4)
coup = (1.0 - mask) + J2 * mask
e0, _ = ed.ground_state(16, bonds, couplings=coup)
print(f'ED ground energy 4x4 J2={J2}: {e0:.6f}', flush=True)

cfg = Config(
    num_sites=16, size_x=4, size_y=4,
    wavefunction_type='complex',
    composite_wavefunction_types=('conv_2d', 'conv_2d'),
    num_conv_layers=3, num_conv_filters=16, kernel_size=3,
    symmetrize=True,
    heisenberg_j2=J2, heisenberg_marshall_gauge=True,
    wavefunction_optimizer_type='SR',
    batch_size=512, num_batches_per_epoch=4,
    num_equilibration_sweeps=10, num_monte_carlo_sweeps=2,
    optimizer='gradient',
    learning_rates=[0.05, 0.02, 0.008, 0.003],
    learning_rate_stops=[200, 400, 600],
    sr_solver='dense', sr_diag_shift=1e-3, sr_delta_clip=10.0,
    sr_reject_residual=0.5, sr_jacobian_chunk=512,
    energy_chunk_samples=512, seed=7)

wf = build_wavefunction(cfg)
ham = build_hamiltonian(cfg)
opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
state = opt.init_state(jax.random.key(cfg.seed))
epoch_fn = jax.jit(opt.epoch)

t0 = time.time()
print('compiling...', flush=True)
for i in range(800):
    state, metrics = epoch_fn(state)
    if i % 40 == 39:
        e = float(metrics['energy'])
        print(f'epoch {i+1:3d}: E={e:.4f} rel_err={(e-e0)/abs(e0):.2e} '
              f"acc={float(metrics['acceptance_rate']):.2f} "
              f't={time.time()-t0:.0f}s', flush=True)
    if i % 100 == 99:
        with open(OUT, 'wb') as f:
            f.write(codec.to_bytes(jax.device_get(state.params)))

with open(OUT, 'wb') as f:
    f.write(codec.to_bytes(jax.device_get(state.params)))
print(f'saved {OUT}', flush=True)

from cgs_vmc_jax.evaluate import evaluate_operator
cfg_eval = cfg.replace(num_evaluation_samples=400, num_monte_carlo_sweeps=2)
res = evaluate_operator(wf, state.params, ham, cfg_eval,
                        key=jax.random.key(99), state=state.sampler)
print(f'FINAL MC eval: E={res.mean:.4f} +/- {res.error:.4f}  '
      f'rel_err={(res.mean-e0)/abs(e0):.2e}', flush=True)
