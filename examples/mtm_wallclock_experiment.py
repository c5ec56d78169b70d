"""Equal-wall-clock 6x6 comparison: single-try vs multiple-try Metropolis.

Round-2 measured MTM k=8 at 5.3x the PROPOSAL throughput of single-try
for conv_2d, but proposals are not sweeps: each MTM step still advances
one exchange per chain, so more candidates buy better mixing per step,
not more steps.  The open question (VERDICT #7) is whether that better
mixing wins at EQUAL WALL-CLOCK on the flagship run.  Each variant
trains the same 5x32 symmetrized conv with dense minSR for the same
time budget; the decision metric is the mean +/- spread of the last-K
epoch means vs QMC.

Run: PYTHONPATH=. python examples/mtm_wallclock_experiment.py [budget_s]
"""
import os
import sys, time, functools
import numpy as np, jax, jax.numpy as jnp
from cgs_vmc_jax import lattice
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS, common
from cgs_vmc_jax.sampler import metropolis

BUDGET_S = float(sys.argv[1]) if len(sys.argv) > 1 else 420.0
E_REF = -0.678872 * 36


def run(name, mtm_k, seed):
    cfg = Config(num_sites=36, size_x=6, size_y=6,
                 wavefunction_type='conv_2d', num_conv_layers=5,
                 num_conv_filters=32, kernel_size=3,
                 wavefunction_optimizer_type='SR',
                 batch_size=1024, num_batches_per_epoch=4,
                 num_equilibration_sweeps=10, num_monte_carlo_sweeps=2,
                 learning_rates=[0.02, 0.008, 0.003],
                 learning_rate_stops=[150, 350],
                 optimizer='gradient', heisenberg_jx=-1.0,
                 sr_diag_shift=1e-2, sr_solver='dense', sr_delta_clip=1.0,
                 sr_reject_residual=0.5, sr_jacobian_chunk=512,
                 energy_chunk_samples=128, symmetrize=True,
                 mtm_candidates=mtm_k, seed=seed)
    wf = build_wavefunction(cfg)
    ham = HeisenbergHamiltonian(lattice.square_lattice_bonds(6, 6),
                                -1.0, 1.0, sample_chunk=128)
    opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
    state = opt.init_state(jax.random.key(seed))
    epoch_fn = jax.jit(opt.epoch)
    state, m = epoch_fn(state)              # compile outside the budget
    _ = float(m['energy'])

    energies, t0 = [], time.time()
    while time.time() - t0 < BUDGET_S:
        state, m = epoch_fn(state)
        energies.append(float(m['energy']))
    k = max(10, len(energies) // 5)
    tail = np.asarray(energies[-k:])
    rel = (tail.mean() - E_REF) / abs(E_REF)
    print(f'{name}: {len(energies)} epochs in {time.time()-t0:.0f}s, '
          f'last-{k} mean E/N={tail.mean()/36:.6f} '
          f'rel_err={rel:.2e} spread={tail.std()/36:.2e} '
          f'acc={float(m["acceptance_rate"]):.3f}', flush=True)


for seed in (5, 6):
    run(f'single-try seed={seed}', 0, seed)
    run(f'MTM k=4     seed={seed}', 4, seed)
    run(f'MTM k=8     seed={seed}', 8, seed)
