"""Headline benchmark: 6x6 AFM Heisenberg to 2.3e-4 of the QMC reference.

Reproduces RESULTS.md row #4 on one GPU:
symmetrized conv-CGS (5x32, C4v x spin-flip projection) + dense
sample-space SR.  Final MC eval: E/N = -0.678717 vs QMC -0.678872.

Uses split compiled programs (sweeps / local energy / SR update) so each
(possibly remote) compile stays small; the all-in-one `cgs train` driver
path works too but compiles one large epoch program.
"""
import os
import time, functools, numpy as np, jax, jax.numpy as jnp
from cgs_vmc_jax import lattice
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
from cgs_vmc_jax.sampler import metropolis

cfg = Config(num_sites=36, size_x=6, size_y=6,
             wavefunction_type='conv_2d', num_conv_layers=5,
             num_conv_filters=32, kernel_size=3,
             wavefunction_optimizer_type='SR',
             batch_size=1024, num_batches_per_epoch=4,
             num_equilibration_sweeps=10, num_monte_carlo_sweeps=2,
             learning_rates=[0.02, 0.01, 0.004, 0.0015], learning_rate_stops=[150, 350, 550],
             optimizer='gradient', heisenberg_jx=-1.0,
             sr_diag_shift=1e-2, sr_solver='dense', sr_delta_clip=1.0,
             sr_reject_residual=0.5, symmetrize=True, seed=11)
bonds = lattice.square_lattice_bonds(6, 6)
wf = build_wavefunction(cfg)
ham = HeisenbergHamiltonian(bonds, -1.0, 1.0)
opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
state = opt.init_state(jax.random.key(cfg.seed))

# Program 1: sweeps (reused for equilibration and decorrelation).
@functools.partial(jax.jit, static_argnums=2)
def sweeps(params, smp, n):
    smp = metropolis.refresh_amplitudes(wf, params, smp)
    return metropolis.run_sweeps(wf, params, smp, n)

# Program 2: local energy, chunked over samples (the symmetrized orbit
# multiplies the connected-config fan-out by |G|; evaluate in slices).
@jax.jit
def local_energy(params, configs):
    chunks = configs.reshape(32, -1, cfg.num_sites)
    return jax.lax.map(lambda c: ham.local_value(wf, params, c),
                       chunks).reshape(-1)

# Program 3: dense SR solve + SGD update.
@jax.jit
def sr_update(params, opt_state, epoch, all_configs, e_loc):
    e_mean = jnp.mean(e_loc)
    delta, grad_e, res = opt._dense_solve(all_configs, params, e_loc,
                                          e_mean, None)
    finite = jnp.all(jnp.asarray(
        [jnp.all(jnp.isfinite(l)) for l in jax.tree.leaves(delta)]))
    delta = jax.tree.map(lambda d, g: jnp.where(finite, d, g), delta, grad_e)
    from cgs_vmc_jax.optim import common
    ok = jnp.logical_or(jnp.logical_not(finite),
                        res < cfg.sr_reject_residual *
                        (common.grad_global_norm(grad_e) + 1e-12))
    delta = jax.tree.map(lambda d: jnp.where(ok, d, jnp.zeros_like(d)), delta)
    norm = common.grad_global_norm(delta)
    clip = jnp.minimum(1.0, cfg.sr_delta_clip / (norm + 1e-12))
    delta = jax.tree.map(lambda d: d * clip, delta)
    new_params, new_opt_state = opt.optax_opt.update(delta, opt_state,
                                                     params, epoch)
    return new_params, new_opt_state, res

params, opt_state, epoch_ct = state.params, state.opt_state, state.epoch
smp = state.sampler
E_REF = -0.678872 * 36
t0 = time.time()
print('compiling...', flush=True)
for i in range(700):
    smp = sweeps(params, smp, cfg.num_equilibration_sweeps)
    config_batches = []
    for b in range(cfg.num_batches_per_epoch):
        config_batches.append(smp.configs)
        smp = sweeps(params, smp, cfg.num_monte_carlo_sweeps)
    all_configs = jnp.concatenate(config_batches, axis=0)
    e_loc = local_energy(params, all_configs)
    params, opt_state, res = sr_update(params, opt_state, epoch_ct,
                                       all_configs, e_loc)
    epoch_ct = epoch_ct + 1
    if i % 25 == 24:
        e = float(jnp.mean(e_loc))
        print(f'epoch {i+1}: E={e:.4f} E/N={e/36:.6f} err={(e-E_REF)/abs(E_REF):.5f} '
              f'res={float(res):.3f} t={time.time()-t0:.0f}s', flush=True)

# Final evaluation with more samples.
from cgs_vmc_jax.evaluate import evaluate_operator
cfg_eval = cfg.replace(num_evaluation_samples=300, num_monte_carlo_sweeps=2)
res = evaluate_operator(wf, params, ham, cfg_eval, key=jax.random.key(99),
                        state=smp)
print(f'FINAL MC eval: E={res.mean:.4f} +/- {res.error:.4f}  E/N={res.mean/36:.6f} '
      f'target E/N=-0.678872  rel_err={(res.mean-E_REF)/abs(E_REF):.6f}', flush=True)
