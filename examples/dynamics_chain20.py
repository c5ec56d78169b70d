"""Spinon dispersion demo: S(q, omega) of the N=20 Heisenberg chain.

Trains a complex(rbm x fc) ground state with dense SR, then runs the
antithetic linear-response protocol (ops/dynamics.py) at several
momenta and reports each S(q, omega) peak against the des
Cloizeaux-Pearson lower edge omega_dCP(q) = (pi/2)|sin q| — the exact
spinon dispersion of the infinite chain (finite-N shifts expected).
The reference framework has no dynamics of any kind.

Runs on the CPU or the GPU; the rbm-modulus ansatz converges where the round-4 fc x fc
choice crawled (RESULTS.md row 1b: flat FC needs a ~1600-epoch anneal).

Usage:  JAX_PLATFORMS=cpu PYTHONPATH=. \
            python examples/dynamics_chain20.py [N=20] [EPOCHS=600]
Writes: artifacts/dynamics_chain{N}.json (per-q correlators + spectra)
"""
import os
os.environ.setdefault('JAX_PLATFORMS', 'cpu')
import json
import sys
import time

import numpy as np
import jax
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()
import jax.numpy as jnp

from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops import dynamics
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.ops.observables import chain_positions
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS

N = int(sys.argv[1]) if len(sys.argv) > 1 else 20
EPOCHS = int(sys.argv[2]) if len(sys.argv) > 2 else 600

cfg = Config(num_sites=N, wavefunction_type='complex',
             composite_wavefunction_types=('rbm', 'fully_connected'),
             num_fc_layers=1, fc_layer_size=64,
             wavefunction_optimizer_type='SR',
             batch_size=512, num_batches_per_epoch=2,
             num_equilibration_sweeps=5, num_monte_carlo_sweeps=1,
             optimizer='gradient',
             learning_rates=[0.05, 0.02, 0.01],
             learning_rate_stops=[EPOCHS // 3, 2 * EPOCHS // 3],
             sr_solver='dense', sr_diag_shift=1e-3, sr_delta_clip=10.0,
             heisenberg_jx=-1.0, seed=7)
wf = build_wavefunction(cfg)
ham = HeisenbergHamiltonian(lattice.chain_bonds(N), -1.0, 1.0)
opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
state = opt.init_state(jax.random.key(cfg.seed))
epoch = jax.jit(opt.epoch)

t0 = time.time()
print(f'training complex rbm x fc ground state, N={N}...', flush=True)
for i in range(EPOCHS):
    state, metrics = epoch(state)
    if i % 50 == 49:
        print(f'epoch {i+1}: E={float(metrics["energy"]):.4f} '
              f't={time.time()-t0:.0f}s', flush=True)
params = state.params

# Linear response at a momentum sweep; dt resolves the top of the
# two-spinon band (omega_max = pi), T=12 resolves ~0.5 splittings.
positions = chain_positions(N)
dt, n_steps, eps, eta = 0.05, 240, 0.05, 0.2
omegas = np.linspace(0.05, 4.0, 400)
results = {}
for m in (2, 3, 5):
    q = 2.0 * np.pi * m / N
    probe = dynamics.FourierSz([q], positions)
    times, corr, _ = dynamics.sampled_linear_response(
        wf, params, ham, probe, cfg, eps, dt, n_steps)
    spec = dynamics.spectral_function(times, corr, omegas, eta)
    peak = float(omegas[int(np.argmax(spec))])
    dcp = 0.5 * np.pi * abs(np.sin(q))
    print(f'q = {m}*2pi/{N}: S(q,w) peak at {peak:.3f}  '
          f'(dCP lower edge {dcp:.3f})  t={time.time()-t0:.0f}s',
          flush=True)
    results[f'{m}'] = {'q': q, 'times': times.tolist(),
                       'correlator': corr.tolist(),
                       'spectrum': spec.tolist(), 'peak': peak,
                       'dcp_edge': dcp}

os.makedirs('artifacts', exist_ok=True)
out = f'artifacts/dynamics_chain{N}.json'
with open(out, 'w') as f:
    json.dump({'omegas': omegas.tolist(), 'eta': eta, 'eps': eps,
               'results': results}, f)
print(f'wrote {out}', flush=True)
