"""Continuation run: push the 6x6 headline below the round-1 2.3e-4.

Warm-starts from artifacts/heisenberg_6x6_symconv.msgpack and anneals
with doubled sample count (M=8192) and a finer LR schedule.  Saves the
improved artifact periodically so an interrupted run keeps its progress.
"""
import os
import time, functools, numpy as np, jax, jax.numpy as jnp
from cgs_vmc_jax.utils import codec
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()
from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS, common
from cgs_vmc_jax.sampler import metropolis

OUT = 'artifacts/heisenberg_6x6_symconv_v2.msgpack'
cfg = Config(num_sites=36, size_x=6, size_y=6,
             wavefunction_type='conv_2d', num_conv_layers=5,
             num_conv_filters=32, kernel_size=3,
             wavefunction_optimizer_type='SR',
             batch_size=2048, num_batches_per_epoch=4,
             num_equilibration_sweeps=10, num_monte_carlo_sweeps=2,
             learning_rates=[0.002, 0.001, 0.0004, 0.00015],
             learning_rate_stops=[200, 400, 600],
             optimizer='gradient', heisenberg_jx=-1.0,
             sr_diag_shift=1e-2, sr_solver='dense', sr_delta_clip=1.0,
             sr_reject_residual=0.5, sr_jacobian_chunk=1024,
             symmetrize=True, seed=23)
bonds = lattice.square_lattice_bonds(6, 6)
wf = build_wavefunction(cfg)
ham = HeisenbergHamiltonian(bonds, -1.0, 1.0)
opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
state = opt.init_state(jax.random.key(cfg.seed))
params = codec.from_bytes(
    state.params, open('artifacts/heisenberg_6x6_symconv.msgpack',
                       'rb').read())
opt_state, epoch_ct, smp = state.opt_state, state.epoch, state.sampler

@functools.partial(jax.jit, static_argnums=2)
def sweeps(p, s, n):
    s = metropolis.refresh_amplitudes(wf, p, s)
    return metropolis.run_sweeps(wf, p, s, n)

@jax.jit
def local_energy(p, configs):
    chunks = configs.reshape(64, -1, cfg.num_sites)
    return jax.lax.map(lambda c: ham.local_value(wf, p, c),
                       chunks).reshape(-1)

@jax.jit
def sr_update(p, o, epoch, all_configs, e_loc):
    e_mean = jnp.mean(e_loc)
    delta, grad_e, res = opt._dense_solve(all_configs, p, e_loc, e_mean,
                                          None)
    finite = jnp.all(jnp.asarray(
        [jnp.all(jnp.isfinite(l)) for l in jax.tree.leaves(delta)]))
    delta = jax.tree.map(lambda d, g: jnp.where(finite, d, g), delta, grad_e)
    ok = jnp.logical_or(jnp.logical_not(finite),
                        res < cfg.sr_reject_residual *
                        (common.grad_global_norm(grad_e) + 1e-12))
    delta = jax.tree.map(lambda d: jnp.where(ok, d, jnp.zeros_like(d)),
                         delta)
    norm = common.grad_global_norm(delta)
    clip = jnp.minimum(1.0, cfg.sr_delta_clip / (norm + 1e-12))
    delta = jax.tree.map(lambda d: d * clip, delta)
    new_p, new_o = opt.optax_opt.update(delta, o, p, epoch)
    return new_p, new_o, res

E_REF = -0.678872 * 36
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
    params, opt_state, res = sr_update(params, opt_state, epoch_ct,
                                       all_configs, e_loc)
    epoch_ct = epoch_ct + 1
    if i % 20 == 19:
        e = float(jnp.mean(e_loc))
        print(f'epoch {i+1}: E/N={e/36:.6f} err={(e-E_REF)/abs(E_REF):.2e} '
              f'res={float(res):.3f} t={time.time()-t0:.0f}s', flush=True)
    if i % 50 == 49:
        with open(OUT, 'wb') as f:
            f.write(codec.to_bytes(jax.device_get(params)))
        print(f'  saved {OUT} @ epoch {i+1}', flush=True)

with open(OUT, 'wb') as f:
    f.write(codec.to_bytes(jax.device_get(params)))

from cgs_vmc_jax.evaluate import evaluate_operator
# Chunked Hamiltonian for the big-batch final eval: the symmetrized
# orbit multiplies the connected-config fan-out; unchunked it can exceed
# device memory.
ham = HeisenbergHamiltonian(bonds, -1.0, 1.0, sample_chunk=128)
cfg_eval = cfg.replace(num_evaluation_samples=600, num_monte_carlo_sweeps=2,
                       batch_size=2048)
res = evaluate_operator(wf, params, ham, cfg_eval, key=jax.random.key(99),
                        state=smp)
print(f'FINAL MC eval: E={res.mean:.4f} +/- {res.error:.4f}  '
      f'E/N={res.mean/36:.6f}  rel_err={(res.mean-E_REF)/abs(E_REF):.2e}',
      flush=True)
