"""Measure the observable suite on the trained 6x6 artifact.

Demonstrates the measurement stack end to end on a converged state:
energy, S(q) across the Brillouin zone (peak at the AFM ordering vector
(pi, pi)), staggered magnetization, longitudinal + transverse
correlators, and Renyi-2 entanglement of a 6-site strip.

Runs on the CPU or the GPU:
  PYTHONPATH=. python examples/measure_6x6_observables.py
"""
import os, sys
import numpy as np
import jax
from cgs_vmc_jax.utils import compile_cache
compile_cache.configure()
from cgs_vmc_jax.utils import codec

from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.ops.observables import (
    SpinStructureFactor, SzSzCorrelation, StaggeredMagnetizationSquared,
    TransverseCorrelation, square_positions)
from cgs_vmc_jax.ops.renyi import evaluate_renyi2
from cgs_vmc_jax.evaluate import evaluate_operator

path = sys.argv[1] if len(sys.argv) > 1 else \
    'artifacts/heisenberg_6x6_symconv_v2.msgpack'
layers = int(sys.argv[2]) if len(sys.argv) > 2 else 5
filters = int(sys.argv[3]) if len(sys.argv) > 3 else 32
cfg = Config(num_sites=36, size_x=6, size_y=6,
             wavefunction_type='conv_2d', num_conv_layers=layers,
             num_conv_filters=filters, kernel_size=3, symmetrize=True,
             heisenberg_jx=-1.0,
             batch_size=256, num_equilibration_sweeps=30,
             num_monte_carlo_sweeps=2, num_evaluation_samples=100,
             energy_chunk_samples=64, seed=55)
wf = build_wavefunction(cfg)
params = codec.from_bytes(
    wf.init(jax.random.key(0)), open(path, 'rb').read())
pos = square_positions(6, 6)

def measure(op, label, key):
    r = evaluate_operator(wf, params, op, cfg, key=jax.random.key(key))
    print(f'{label:34s} {r.mean:+.5f} +/- {r.error:.5f}', flush=True)
    return r.mean

ham = HeisenbergHamiltonian(lattice.square_lattice_bonds(6, 6), -1.0, 1.0,
                            sample_chunk=cfg.energy_chunk_samples)
e = measure(ham, 'E (Marshall gauge)', 1)
print(f'{"E/N":34s} {e/36:+.6f}  (QMC -0.678872)')

for q, name in (((np.pi, np.pi), 'S(pi,pi)  [AFM peak]'),
                ((np.pi, 0.0), 'S(pi,0)'),
                ((np.pi / 3, np.pi / 3), 'S(pi/3,pi/3)'),
                ((0.0, 0.0), 'S(0,0)   [= 0: Sz conserved]')):
    measure(SpinStructureFactor(list(q), pos), name, hash(name) % 1000)

measure(StaggeredMagnetizationSquared(
    lattice.marshall_sublattice(36, 6, 6)), 'staggered m^2', 7)


def y_pairs(d):
    """True lattice pairs at offset d along y (site = x*6 + y)."""
    return [(x * 6 + y, x * 6 + (y + d) % 6)
            for x in range(6) for y in range(6)]


zz1 = None
for d in (1, 2, 3):
    val = measure(SzSzCorrelation(y_pairs(d)), f'SzSz(d={d}, y-dir)',
                  10 + d)
    if d == 1:
        zz1 = val
# The trained state is the MARSHALL-GAUGE-rotated ground state (jx=-1):
# U = prod_B sigma^z flips Sx,Sy on sublattice B, so for A-B pairs the
# physical transverse correlator is MINUS the measured one.  SU(2)
# symmetry of the physical state then demands it equal 2*SzSz.
perp = measure(TransverseCorrelation(y_pairs(1), sample_chunk=64),
               'SxSx+SySy(d=1) gauge-rotated', 20)
print(f'{"  -> physical (x -1, Marshall)":34s} {-perp:+.5f}   '
      f'[SU(2) check: 2*SzSz = {2 * zz1:+.5f}]')

# Area-law scan: strips of 1, 2, 3 rows (site = x*6 + y, so rows 0..w-1
# are sites [0, 6w)).  On the torus every strip cut has the same
# boundary LENGTH (two 6-site cuts); S2 should grow sub-linearly in
# strip width and saturate near the half cut — the area law with
# additive corrections, not a volume law.
for w in (1, 2, 3):
    s2, err = evaluate_renyi2(wf, params, list(range(6 * w)), cfg,
                              key=jax.random.key(30 + w))
    print(f'{f"Renyi-2 S2(strip {w}x6, {6*w} sites)":34s} '
          f'{s2:+.4f} +/- {err:.4f}', flush=True)
