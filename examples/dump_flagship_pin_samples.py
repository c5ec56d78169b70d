"""Generate the seeded |psi|^2 sample set for the flagship CI pin.

Draws decorrelated Metropolis samples from the committed 6x6 deep48
artifact (RESULTS.md headline row, rel err 7.05e-5) and writes them to
tests/data/flagship_6x6_deep48_samples.npy as int8 spins.  The CI test
(tests/test_flagship_pin.py) re-evaluates the local energy over these
FIXED configurations with self-normalized importance reweighting, so
the headline claim is pinned to ~1e-3 on CPU without MCMC at test time.

Run once (GPU): PYTHONPATH=. \
    python examples/dump_flagship_pin_samples.py
The logpsi drift reference is then recomputed automatically in a
CPU subprocess (the platform pytest runs on — accelerator
log-amplitudes at default precision differ from the CPU by ~4e-3 on
deep conv stacks, above the pin test's 1e-3 tolerance).
"""
import os
import subprocess
import sys
import numpy as np
import jax
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()
import jax.numpy as jnp
from cgs_vmc_jax.utils import codec

from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.sampler import metropolis

ARTIFACT = 'artifacts/heisenberg_6x6_deep48.msgpack'
OUT = 'tests/data/flagship_6x6_deep48_samples.npy'
N = 36
N_CHAINS = 128
N_BATCHES = 4           # 512 samples total
EQUIL_SWEEPS = 200
DECORR_SWEEPS = 10

cfg = Config(num_sites=N, size_x=6, size_y=6,
             wavefunction_type='conv_2d', num_conv_layers=7,
             num_conv_filters=48, kernel_size=3, symmetrize=True,
             heisenberg_jx=-1.0, batch_size=N_CHAINS, seed=2026)
wf = build_wavefunction(cfg)
params = codec.from_bytes(wf.init(jax.random.key(0)),
                                  open(ARTIFACT, 'rb').read())
smp = metropolis.init_sampler_for(jax.random.key(cfg.seed), wf, params, cfg)
smp = metropolis.refresh_amplitudes(wf, params, smp)

sweeps = jax.jit(lambda s, k: metropolis.run_sweeps(wf, params, s, k),
                 static_argnums=1)
smp = sweeps(smp, EQUIL_SWEEPS)
batches = []
for _ in range(N_BATCHES):
    batches.append(np.asarray(smp.configs, np.int8))
    smp = sweeps(smp, DECORR_SWEEPS)
configs = np.concatenate(batches, axis=0)
os.makedirs(os.path.dirname(OUT), exist_ok=True)
np.save(OUT, configs)
print(f'wrote {configs.shape} -> {OUT}; acceptance '
      f'{float(metropolis.acceptance_rate(smp)):.3f}')

# log|psi| drift reference over the set: the CI test recomputes these
# (importance weights must be exactly 1 on the committed artifact) and
# reweights E_loc if the amplitudes moved.  It MUST be computed on
# clean CPU — the CI platform — so the recompute is delegated to a
# subprocess with JAX_PLATFORMS=cpu.
LOGPSI_OUT = OUT.replace('samples', 'logpsi')
recompute = f'''
import sys
sys.path.insert(0, {os.getcwd()!r})
import numpy as np, jax, jax.numpy as jnp
from cgs_vmc_jax.utils import codec
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
cfg = Config(num_sites={N}, size_x=6, size_y=6,
             wavefunction_type='conv_2d', num_conv_layers=7,
             num_conv_filters=48, kernel_size=3, symmetrize=True,
             heisenberg_jx=-1.0)
wf = build_wavefunction(cfg)
params = codec.from_bytes(wf.init(jax.random.key(0)),
                                  open({ARTIFACT!r}, 'rb').read())
configs = jnp.asarray(np.load({OUT!r}), jnp.float32)
logs = np.asarray(wf.apply(params, configs).log, np.float64)
np.save({LOGPSI_OUT!r}, logs)
print('logpsi reference (clean CPU):', logs[:3])
'''
subprocess.run(
    ['env', '-i', 'HOME=/root', 'PATH=/opt/venv/bin:/usr/bin:/bin',
     'JAX_PLATFORMS=cpu', sys.executable, '-c', recompute],
    check=True)

# Reference value over the dumped set (recorded into the CI test).
ham = HeisenbergHamiltonian(lattice.square_lattice_bonds(6, 6), -1.0, 1.0,
                            sample_chunk=64)
e_loc = np.asarray(ham.local_value(wf, params,
                                   jnp.asarray(configs, jnp.float32)))
print(f'E/N over set = {e_loc.mean()/N:.6f}  std(E_loc)/N = '
      f'{e_loc.std()/N:.6f}  sem/N = '
      f'{e_loc.std()/np.sqrt(len(e_loc))/N:.6f}')
