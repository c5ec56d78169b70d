"""Independent cross-check of the measured 6x6 triplet gap (CPU, exact).

RESULTS.md reports Delta_1(6x6) = 0.2904 +/- 0.0004 from sector VMC
(round 4).  A 6x6 ED is out of reach (Sz=0 dim ~ 9e9), so this script
pins the number three independent ways, all computable exactly in-repo:

1. 4x4 ED tower: the lowest Sz=1 and Sz=2 sector energies at N=16 obey
   the Anderson tower E(S) - E0 = S(S+1)/(2*N*theta(L)) — the ratio
   Delta_2/Delta_1 must be ~3 (it is: 2.957), validating that the gap
   measured this way is the rotor-tower level, not an artifact.
2. Raw 1/N scaling of the 4x4 ED gap -> a LOWER-corridor estimate for
   6x6 (theta(L) decreases toward chi_perp as L grows, so the raw 1/N
   number underestimates the L=6 gap).
3. A 1/L-corrected fit: theta(L) = chi_inf * (1 + alpha/L) anchored at
   the 4x4 ED point with chi_inf = 0.065 (the QMC/series perpendicular
   susceptibility of the square-lattice AFM, Sandvik PRB 56, 11678) ->
   a predicted Delta_1(6x6) to compare against the VMC measurement.

The companion queue stage measures E(Sz=2) at 6x6 with the same sector
pipeline, giving the in-house Delta_2/Delta_1 ~ 3 check at the flagship
lattice itself.

Run: JAX_PLATFORMS=cpu PYTHONPATH=. \
    python examples/gap_tower_check.py
"""
import os
os.environ.setdefault('JAX_PLATFORMS', 'cpu')
import numpy as np

from cgs_vmc_jax import lattice
from cgs_vmc_jax.utils import ed

CHI_INF = 0.065            # chi_perp of the 2-D AFM (series/QMC)
VMC_GAP_6X6 = 0.2904       # RESULTS.md round-4 sector measurement
VMC_ERR_6X6 = 0.0004

bonds = lattice.square_lattice_bonds(4, 4)
e = {}
for n_down, s in [(8, 0), (7, 1), (6, 2)]:
    e[s], _ = ed.ground_state(16, bonds, j_x=-1.0, j_z=1.0, n_down=n_down)
    print(f'4x4 ED  Sz={s}: E = {e[s]:.6f}')

d1, d2 = e[1] - e[0], e[2] - e[0]
print(f'\nDelta_1(16) = {d1:.6f}   Delta_2(16) = {d2:.6f}')
print(f'tower ratio Delta_2/Delta_1 = {d2 / d1:.4f}  (Anderson tower: 3; '
      f'deviation {abs(d2 / d1 - 3) / 3:.1%})')

theta_16 = 2.0 / (2.0 * 16 * d1)  # S(S+1)=2 at S=1
print(f'\ntheta(L=4) = S(S+1)/(2*N*Delta_1) = {theta_16:.5f} '
      f'(vs chi_inf = {CHI_INF})')

raw = d1 * 16.0 / 36.0
alpha = 4.0 * (theta_16 / CHI_INF - 1.0)
theta_36 = CHI_INF * (1.0 + alpha / 6.0)
pred = 2.0 / (2.0 * 36 * theta_36)
print(f'\n6x6 predictions for Delta_1:')
print(f'  raw 1/N scaling of the 4x4 ED gap : {raw:.4f}  (lower corridor)')
print(f'  1/L-corrected theta(6) = {theta_36:.5f} -> Delta_1(36) = {pred:.4f}')
print(f'  VMC measurement (round 4)          : {VMC_GAP_6X6:.4f} '
      f'+/- {VMC_ERR_6X6:.4f}')
print(f'  agreement vs corrected prediction  : '
      f'{abs(VMC_GAP_6X6 - pred) / pred:.1%}')
print(f'\n6x6 tower expectation for the Sz=2 queue stage: '
      f'E(Sz=2)/N ~ {(-0.678872 * 36 + 3 * VMC_GAP_6X6) / 36:.6f} '
      f'(Delta_2 ~ 3*Delta_1 = {3 * VMC_GAP_6X6:.4f})')
