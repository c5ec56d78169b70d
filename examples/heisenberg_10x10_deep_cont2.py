"""Deep 10x10 continuation, stage 2: resume the 7x32 anneal at epoch 350.

Round-2's continuation (examples/heisenberg_10x10_deep_cont.py) stopped
at epoch ~350 of its 1400-epoch lr 0.01/0.004/0.0015 schedule;
the epoch-350 params live in artifacts/heisenberg_10x10_deep32_cont.msgpack.
This resumes THAT artifact at the correct schedule position (epoch counter
350) and runs the remaining anneal stages with periodic saves.  No final
eval here — `cgs eval --params` runs separately on the saved weights."""

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

IN = 'artifacts/heisenberg_10x10_deep32_cont.msgpack'
OUT = 'artifacts/heisenberg_10x10_deep32_cont.msgpack'
START_EPOCH = 350
END_EPOCH = 1400
cfg = Config(num_sites=100, size_x=10, size_y=10,
             wavefunction_type='conv_2d', num_conv_layers=7,
             num_conv_filters=32, kernel_size=3,
             wavefunction_optimizer_type='SR',
             batch_size=1024, num_batches_per_epoch=4,
             num_equilibration_sweeps=10, num_monte_carlo_sweeps=2,
             learning_rates=[0.01, 0.004, 0.0015],
             learning_rate_stops=[400, 800],
             optimizer='gradient', heisenberg_jx=-1.0,
             sr_diag_shift=1e-2, sr_solver='dense', sr_delta_clip=1.0,
             sr_reject_residual=0.5, sr_jacobian_chunk=1024,
             sr_cg_tol=1e-5, sr_cg_maxiter=200,
             symmetrize=True, seed=31)
bonds = lattice.square_lattice_bonds(10, 10)
wf = build_wavefunction(cfg)
ham = HeisenbergHamiltonian(bonds, -1.0, 1.0)
opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
state = opt.init_state(jax.random.key(cfg.seed))
params = codec.from_bytes(state.params, open(IN, 'rb').read())
opt_state, smp = state.opt_state, state.sampler
epoch_ct = jnp.asarray(START_EPOCH, dtype=state.epoch.dtype)

@functools.partial(jax.jit, static_argnums=2)
def sweeps(p, s, n):
    s = metropolis.refresh_amplitudes(wf, p, s)
    return metropolis.run_sweeps(wf, p, s, n)

@jax.jit
def local_energy(p, configs):
    chunks = configs.reshape(128, -1, cfg.num_sites)
    return jax.lax.map(lambda c: ham.local_value(wf, p, c),
                       chunks).reshape(-1)

@jax.jit
def sr_update(p, o, epoch, all_configs, e_loc):
    e_mean = jnp.mean(e_loc)
    delta, grad_e, res = opt._dense_solve(all_configs, p, e_loc,
                                          e_mean, None)
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

E_REF = -0.671549 * 100
t0 = time.time()
print(f'resuming {IN} at epoch {START_EPOCH}; compiling...', flush=True)
# Re-equilibrate the fresh sampler state against the loaded params.
smp = sweeps(params, smp, 50)
for i in range(START_EPOCH, END_EPOCH):
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
        print(f'epoch {i+1}: E/N={e/100:.6f} err={(e-E_REF)/abs(E_REF):.2e} '
              f'res={float(res):.3f} t={time.time()-t0:.0f}s', flush=True)
    if i % 50 == 49:
        with open(OUT, 'wb') as f:
            f.write(codec.to_bytes(jax.device_get(params)))
        print(f'  saved {OUT} @ epoch {i+1}', flush=True)

with open(OUT, 'wb') as f:
    f.write(codec.to_bytes(jax.device_get(params)))
print(f'DONE: saved {OUT} @ epoch {END_EPOCH}; MC eval: '
      f'cgs eval --params {OUT} (see examples/README.md)', flush=True)
