"""Chunked final MC evaluation of a 10x10 artifact (OOM-safe).

The symmetrized 10x10 fan-out is sample_chunk x 200 bonds x 8 orbit
configurations of 100-site conv activations — chunk SMALL (16).
Usage: PYTHONPATH=. python examples/eval_10x10_artifact.py [path]
"""
import os, sys
import jax
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()
from cgs_vmc_jax.utils import codec
from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.evaluate import evaluate_operator

path = sys.argv[1] if len(sys.argv) > 1 else \
    'artifacts/heisenberg_10x10_symconv_v2.msgpack'

cfg = Config(num_sites=100, size_x=10, size_y=10,
             wavefunction_type='conv_2d', num_conv_layers=5,
             num_conv_filters=32, kernel_size=3, symmetrize=True,
             heisenberg_jx=-1.0,
             batch_size=512, num_equilibration_sweeps=50,
             num_monte_carlo_sweeps=2, num_evaluation_samples=300,
             energy_chunk_samples=16, seed=97)
wf = build_wavefunction(cfg)
params = codec.from_bytes(
    wf.init(jax.random.key(0)), open(path, 'rb').read())
ham = HeisenbergHamiltonian(lattice.square_lattice_bonds(10, 10), -1.0, 1.0,
                            sample_chunk=cfg.energy_chunk_samples)
res = evaluate_operator(wf, params, ham, cfg, key=jax.random.key(103))
E_REF = -0.671549 * 100
print(f'{path}: E={res.mean:.4f} +/- {res.error:.4f}  '
      f'E/N={res.mean/100:.6f}  rel_err={(res.mean-E_REF)/abs(E_REF):.2e}  '
      f'acc={res.acceptance_rate:.3f}', flush=True)
