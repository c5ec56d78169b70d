"""Chunked final MC evaluation of a 6x6 artifact (OOM-safe).

Usage: PYTHONPATH=. python examples/eval_6x6_artifact.py [path]
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
    'artifacts/heisenberg_6x6_symconv_v2.msgpack'
filters = int(sys.argv[2]) if len(sys.argv) > 2 else 32

cfg = Config(num_sites=36, size_x=6, size_y=6,
             wavefunction_type='conv_2d', num_conv_layers=5,
             num_conv_filters=filters, kernel_size=3, symmetrize=True,
             heisenberg_jx=-1.0,
             batch_size=1024, num_equilibration_sweeps=50,
             num_monte_carlo_sweeps=2, num_evaluation_samples=600,
             energy_chunk_samples=128, seed=97)
wf = build_wavefunction(cfg)
params = codec.from_bytes(
    wf.init(jax.random.key(0)), open(path, 'rb').read())
ham = HeisenbergHamiltonian(lattice.square_lattice_bonds(6, 6), -1.0, 1.0,
                            sample_chunk=cfg.energy_chunk_samples)
res = evaluate_operator(wf, params, ham, cfg, key=jax.random.key(101))
E_REF = -0.678872 * 36
print(f'{path}: E={res.mean:.4f} +/- {res.error:.4f}  '
      f'E/N={res.mean/36:.6f}  rel_err={(res.mean-E_REF)/abs(E_REF):.2e}  '
      f'acc={res.acceptance_rate:.3f}', flush=True)
