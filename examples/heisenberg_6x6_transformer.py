"""6x6 AFM Heisenberg with the self-attention ansatz (rounds 4-5).

Flagship-lattice run of the transformer family (models/attention.py):
symmetrized (C4v x spin-flip) pre-LN encoder, dense sample-space minSR.
The goal is a clean measured row for the new ansatz family next to the
conv flagship (RESULTS.md row 4: 5x32 conv reaches 2.3e-4), not to beat
it — the conv's translation weight sharing is exactly the right
inductive bias here, while attention has to learn the geometry through
the positional embeddings.

Cost: the 4-layer d=64 h=8 default is dominated not by its FLOPs
(~37 TFLOP/epoch) but by the 648 SEQUENTIAL Metropolis steps per epoch,
each a small-latency attention forward over 1024 chains x 16 symmetry
copies (its time on an H100 is not measured).  A 450-epoch run therefore cannot fit a round's
wall-clock; the measured flagship datum uses the smaller env-configured
model and sweep schedule below, plus resume + a hard time budget so a
watchdog kill never loses progress.

Env knobs:
  TF66_LAYERS/TF66_DIM/TF66_HEADS  model size   (default 4 / 64 / 8)
  TF66_EPOCHS                      total epochs (LR stops scale with it)
  TF66_EQUIL/TF66_MC               sweeps: per-epoch re-equilibration /
                                   between sample batches (10 / 2)
  TF66_BUDGET_S                    stop training after this many seconds
                                   (0 = no budget) and go straight to
                                   the final eval
  TF66_RESUME=1                    warm-start from the artifact if present
  TF66_EVAL_SAMPLES                final unbiased MC eval samples (120)

Run (GPU): PYTHONPATH=. \
    python examples/heisenberg_6x6_transformer.py
"""
import os
import threading, time, functools, numpy as np, jax, jax.numpy as jnp
from cgs_vmc_jax.utils import codec
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()
from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
from cgs_vmc_jax.sampler import metropolis

N = 36
LAYERS = int(os.environ.get('TF66_LAYERS', '4'))
DIM = int(os.environ.get('TF66_DIM', '64'))
HEADS = int(os.environ.get('TF66_HEADS', '8'))
EPOCHS = int(os.environ.get('TF66_EPOCHS', '800'))
EQUIL = int(os.environ.get('TF66_EQUIL', '10'))
MC = int(os.environ.get('TF66_MC', '2'))
BUDGET_S = float(os.environ.get('TF66_BUDGET_S', '0'))
RESUME = os.environ.get('TF66_RESUME', '0') == '1'
EVAL_SAMPLES = int(os.environ.get('TF66_EVAL_SAMPLES', '120'))
BATCH = int(os.environ.get('TF66_BATCH', '1024'))  # CPU smoke: 64
OUT = (f'artifacts/heisenberg_6x6_transformer.msgpack'
       if (LAYERS, DIM, HEADS) == (4, 64, 8) else
       f'artifacts/heisenberg_6x6_transformer_{LAYERS}x{DIM}h{HEADS}.msgpack')
# LR anneal stops scale with EPOCHS so the run compresses cleanly.
_stops = [max(1, round(s * EPOCHS / 800)) for s in (200, 450, 650)]
cfg = Config(num_sites=N, size_x=6, size_y=6,
             wavefunction_type='transformer',
             num_attention_layers=LAYERS, attention_dim=DIM,
             num_attention_heads=HEADS,
             wavefunction_optimizer_type='SR',
             batch_size=BATCH, num_batches_per_epoch=4,
             num_equilibration_sweeps=EQUIL, num_monte_carlo_sweeps=MC,
             learning_rates=[0.02, 0.01, 0.004, 0.0015],
             learning_rate_stops=_stops,
             optimizer='gradient', heisenberg_jx=-1.0,
             sr_diag_shift=1e-2, sr_solver='dense', sr_delta_clip=1.0,
             sr_jacobian_chunk=64,
             sr_reject_residual=0.5, symmetrize=True, seed=17)
bonds = lattice.square_lattice_bonds(6, 6)
wf = build_wavefunction(cfg)
ham = HeisenbergHamiltonian(bonds, -1.0, 1.0)
opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
state = opt.init_state(jax.random.key(cfg.seed))

@functools.partial(jax.jit, static_argnums=2)
def sweeps(params, smp, n):
    smp = metropolis.refresh_amplitudes(wf, params, smp)
    return metropolis.run_sweeps(wf, params, smp, n)

@jax.jit
def local_energy(params, configs):
    # 8 configs/chunk: each chunk's connected-config forward is
    # 8*72 bonds * 16 symmetry copies = 9216 rows, so the per-layer
    # attention score buffer is [9216, 8, 36, 36] f32 ~ 0.95 GB.  The
    # first run used 32 chunks -> a 24 GB buffer.
    chunks = configs.reshape(-1, 8, cfg.num_sites)
    return jax.lax.map(lambda c: ham.local_value(wf, params, c),
                       chunks).reshape(-1)

@jax.jit
def sr_update(params, opt_state, epoch, all_configs, e_loc):
    new_params, new_opt_state, res, _ = opt.update_from_samples(
        params, opt_state, epoch, all_configs, e_loc)
    return new_params, new_opt_state, res

params, opt_state, epoch_ct = state.params, state.opt_state, state.epoch
smp = state.sampler
start_epoch = 0
if RESUME and os.path.exists(OUT):
    params = codec.from_bytes(params, open(OUT, 'rb').read())
    meta = OUT + '.epoch'
    if os.path.exists(meta):
        start_epoch = int(open(meta).read().strip())
    epoch_ct = epoch_ct + start_epoch
    print(f'resumed {OUT} at epoch {start_epoch}', flush=True)
E_REF = -0.678872 * N
t0 = time.time()
n_params = sum(int(np.prod(l.shape)) for l in jax.tree.leaves(params))
print(f'transformer {LAYERS}xd{DIM}h{HEADS} ({n_params} params), '
      f'equil/mc = {EQUIL}/{MC}, epochs {start_epoch}->{EPOCHS}, '
      f'budget {BUDGET_S or "none"}s; compiling...', flush=True)


def save(i):
    with open(OUT, 'wb') as f:
        f.write(codec.to_bytes(jax.device_get(params)))
    with open(OUT + '.epoch', 'w') as f:
        f.write(str(i))


def _compile_heartbeat(window_s=2700, interval_s=240):
    # Long fresh-shape compiles print nothing; keep the log alive over
    # the compile window only.
    t0 = time.time()

    def beat():
        while time.time() - t0 < window_s:
            time.sleep(interval_s)
            print(f'  [heartbeat t={time.time()-t0:.0f}s]', flush=True)

    threading.Thread(target=beat, daemon=True).start()


_compile_heartbeat()
phase_t = None
i = start_epoch - 1  # loop may be empty on a fully-resumed run
for i in range(start_epoch, EPOCHS):
    ts = time.time()
    smp = sweeps(params, smp, cfg.num_equilibration_sweeps)
    if phase_t is None and i > start_epoch:  # post-compile phase probe
        _ = jax.device_get(smp.configs[0, 0])
        t_sw = time.time() - ts
    config_batches = []
    for b in range(cfg.num_batches_per_epoch):
        config_batches.append(smp.configs)
        smp = sweeps(params, smp, cfg.num_monte_carlo_sweeps)
    all_configs = jnp.concatenate(config_batches, axis=0)
    if phase_t is None and i > start_epoch:
        _ = jax.device_get(smp.configs[0, 0])
        t_sw2 = time.time() - ts
    e_loc = local_energy(params, all_configs)
    if phase_t is None and i > start_epoch:
        _ = jax.device_get(e_loc[0])
        t_el = time.time() - ts
    params, opt_state, res = sr_update(params, opt_state, epoch_ct,
                                       all_configs, e_loc)
    epoch_ct = epoch_ct + 1
    if phase_t is None and i > start_epoch:
        _ = jax.device_get(res)
        phase_t = time.time() - ts
        print(f'phase probe (epoch {i+1}): equil {t_sw:.1f}s, +mc '
              f'{t_sw2-t_sw:.1f}s, +e_loc {t_el-t_sw2:.1f}s, +sr '
              f'{phase_t-t_el:.1f}s = {phase_t:.1f}s/epoch', flush=True)
    if i % 5 == 4:
        e = float(jnp.mean(e_loc))
        print(f'epoch {i+1}: E/N={e/N:.6f} err={(e-E_REF)/abs(E_REF):.2e} '
              f'res={float(res):.3f} t={time.time()-t0:.0f}s', flush=True)
    if i % 25 == 24:
        save(i + 1)
    if BUDGET_S and time.time() - t0 > BUDGET_S:
        print(f'budget {BUDGET_S}s reached at epoch {i+1}; '
              f'stopping training', flush=True)
        break

save(i + 1)

# Final unbiased MC eval, split-program style (fresh decorrelated reads).
# Equilibration runs as short 2-sweep chunks, each ended by a
# device->host read (progress stays visible).
from cgs_vmc_jax.evaluate import binned_error
for _ in range(25):
    smp = sweeps(params, smp, 2)
    _ = jax.device_get(smp.configs[0, 0])  # end of this chunk
vals = []
for k in range(EVAL_SAMPLES):
    vals.append(float(jnp.mean(local_energy(params, smp.configs))))
    smp = sweeps(params, smp, 2)
    if (k + 1) % 20 == 0:
        print(f'eval {k+1}/{EVAL_SAMPLES} t={time.time()-t0:.0f}s',
              flush=True)
e_mean, e_err = binned_error(np.asarray(vals))
print(f'FINAL MC eval ({LAYERS}xd{DIM}h{HEADS}, epoch {i+1}): '
      f'E={e_mean:.4f} +/- {e_err:.4f}  E/N={e_mean/N:.6f}  '
      f'rel_err={(e_mean-E_REF)/abs(E_REF):.2e}', flush=True)
