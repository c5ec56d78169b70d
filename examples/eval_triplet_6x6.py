"""Split-program MC eval of the 6x6 Sz=1 sector artifact (triplet gap).

Unbiased <H> over the Sz=1 sector chains (total_sz2=2 init; exchange
moves conserve the sector) for the artifact trained by
examples/spin_gap_6x6.py.  Spin-flip symmetrization stays OFF (the flip
maps Sz=+1 onto Sz=-1).

Run: PYTHONPATH=. \
    python examples/eval_triplet_6x6.py [SAMPLES=400]
"""
import os
import sys
import functools

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
from cgs_vmc_jax.evaluate import binned_error

SZ2 = int(os.environ.get('GAP66_SZ2', '2'))
PATH = ('artifacts/heisenberg_6x6_triplet.msgpack' if SZ2 == 2
        else f'artifacts/heisenberg_6x6_sz{SZ2}.msgpack')
SAMPLES = int(sys.argv[1]) if len(sys.argv) > 1 else 400
N, BATCH = 36, 512
E0_QMC = -0.678872 * N

cfg = Config(num_sites=N, size_x=6, size_y=6,
             wavefunction_type='conv_2d', num_conv_layers=5,
             num_conv_filters=32, kernel_size=3, symmetrize=True,
             symmetrize_spin_flip=False, total_sz2=SZ2,
             heisenberg_jx=-1.0, batch_size=BATCH, seed=91)
wf = build_wavefunction(cfg)
ham = HeisenbergHamiltonian(lattice.square_lattice_bonds(6, 6), -1.0, 1.0)
params = codec.from_bytes(
    wf.init(jax.random.key(0)), open(PATH, 'rb').read())

@functools.partial(jax.jit, static_argnums=2)
def sweeps(p, s, k):
    s = metropolis.refresh_amplitudes(wf, p, s)
    return metropolis.run_sweeps(wf, p, s, k)

@jax.jit
def local_energy(p, configs):
    chunks = configs.reshape(128, -1, N)
    return jax.lax.map(lambda c: ham.local_value(wf, p, c),
                       chunks).reshape(-1)

smp = metropolis.init_sampler_for(jax.random.key(cfg.seed), wf, params, cfg)
assert int(jnp.sum(smp.configs)) == BATCH * SZ2, f'chains must sit in Sz={SZ2/2:g}'
smp = sweeps(params, smp, 50)
values = []
for i in range(SAMPLES):
    values.append(float(jnp.mean(local_energy(params, smp.configs))))
    smp = sweeps(params, smp, 2)
    if i % 50 == 49:
        m, err = binned_error(np.asarray(values))
        print(f'{i+1} samples: E/N={m/N:.6f} +/- {err/N:.6f}', flush=True)

m, err = binned_error(np.asarray(values))
print(f'FINAL: E(Sz={SZ2//2}) = {m:.4f} +/- {err:.4f}   E/N = {m/N:.6f}')
print(f'gap vs QMC E0 ({E0_QMC:.4f}): Delta_{SZ2//2} = {m - E0_QMC:.4f} '
      f'+/- {err:.4f}')
