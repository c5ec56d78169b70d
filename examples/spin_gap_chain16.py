"""Spin gap of the N=16 AFM Heisenberg chain, two independent ways.

Physics cross-check of the two round-3 excitation capabilities: on a
bipartite AFM chain the first excitation is a triplet, so

  (a) direct ground-state search in the Sz=1 sector (config.total_sz2=2)
  (b) penalty orthogonalization against the trained ground state inside
      the Sz=0 sector ('ExcitedPenalty' optimizer)

must land on the SAME energy — the Sz=±1,0 components of one triplet —
and both are pinned against sector ED here (N=16: dim 12870 / 11440).

CPU-friendly (runs in a few minutes on the CPU):
  JAX_PLATFORMS=cpu PYTHONPATH=. python examples/spin_gap_chain16.py
"""

import os
import sys
import time

import numpy as np
import jax

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
from cgs_vmc_jax.optim.excited import PenaltyExcitedOptimizer
from cgs_vmc_jax.utils import ed

N = 16
JX = -1.0
BONDS = lattice.chain_bonds(N)
OUT = os.environ.get('GAP_OUT', '/tmp/spin_gap_chain16')


def base_config(**kwargs) -> Config:
    defaults = dict(
        num_sites=N, wavefunction_type='rbm', num_fc_layers=1,
        fc_layer_size=32, batch_size=512, num_batches_per_epoch=4,
        num_equilibration_sweeps=10, num_monte_carlo_sweeps=1,
        heisenberg_jx=JX, seed=7,
    )
    defaults.update(kwargs)
    return Config(**defaults)


def run(opt_name, config, epochs, lower_states=None, tail=40):
    wf = build_wavefunction(config)
    ham = HeisenbergHamiltonian(BONDS, JX, 1.0)
    if opt_name in ('ExcitedPenalty', 'ExcitedSR'):
        opt = GROUND_STATE_OPTIMIZERS[opt_name](wf, ham, config,
                                                lower_states=lower_states)
    else:
        opt = GROUND_STATE_OPTIMIZERS[opt_name](wf, ham, config)
    state = opt.init_state(jax.random.key(config.seed))
    epoch_fn = jax.jit(opt.epoch)
    t0 = time.time()
    energies, overlaps = [], []
    for i in range(epochs):
        state, metrics = epoch_fn(state)
        energies.append(float(metrics['energy']))
        if 'overlap' in metrics:
            overlaps.append(float(metrics['overlap']))
        if (i + 1) % 100 == 0:
            ov = f"  F={overlaps[-1]:.4f}" if overlaps else ''
            print(f'  epoch {i+1:4d}  E={energies[-1]:+.5f}{ov}  '
                  f'({time.time()-t0:.0f}s)', flush=True)
    tail_e = float(np.mean(energies[-tail:]))
    tail_sd = float(np.std(energies[-tail:]) / np.sqrt(tail))
    return wf, state, tail_e, tail_sd, (overlaps[-tail:] if overlaps else [])


def main():
    print(f'== ED oracles (N={N} chain, jx={JX})')
    mat0 = ed.heisenberg_matrix(N, BONDS, j_x=JX, n_down=N // 2)
    dense0 = mat0.toarray() if hasattr(mat0, 'toarray') else mat0
    vals0 = np.linalg.eigvalsh(dense0)
    e0_ed, e1_ed = float(vals0[0]), float(vals0[1])
    mat1 = ed.heisenberg_matrix(N, BONDS, j_x=JX, n_down=N // 2 - 1)
    dense1 = mat1.toarray() if hasattr(mat1, 'toarray') else mat1
    et_ed = float(np.linalg.eigvalsh(dense1)[0])
    print(f'  E0 = {e0_ed:.6f}   E1(Sz=0 sector) = {e1_ed:.6f}   '
          f'E_min(Sz=1 sector) = {et_ed:.6f}')
    print(f'  exact gap = {e1_ed - e0_ed:.6f} '
          f'(triplet check: |E1 - E_t| = {abs(e1_ed - et_ed):.2e})')

    print('== (0) RBM ground state, SR, Sz=0')
    g_cfg = base_config(
        wavefunction_optimizer_type='SR', optimizer='gradient',
        learning_rates=[0.05, 0.02], learning_rate_stops=[150],
        sr_diag_shift=1e-2)
    wf0, st0, e0, e0_sd, _ = run('SR', g_cfg, 400)
    print(f'  E0(VMC) = {e0:.5f} ± {e0_sd:.5f}  '
          f'rel {abs(e0 - e0_ed)/abs(e0_ed):.2e}')

    print('== (a) RBM lowest triplet, SR, Sz=1 sector (total_sz2=2)')
    t_cfg = base_config(
        total_sz2=2, wavefunction_optimizer_type='SR',
        optimizer='gradient', learning_rates=[0.05, 0.02],
        learning_rate_stops=[150], sr_diag_shift=1e-2, seed=8)
    _, _, et, et_sd, _ = run('SR', t_cfg, 400)
    print(f'  E_t(VMC) = {et:.5f} ± {et_sd:.5f}  '
          f'rel {abs(et - et_ed)/abs(et_ed):.2e}')

    print('== (b) complex(rbm x fc) first excited, ExcitedSR penalty, Sz=0')
    # A POSITIVE ansatz cannot represent the in-sector first excited
    # state (it changes sign even in the Marshall gauge; the best
    # positive state orthogonal to the ground state sits far above E1) —
    # the penalty method needs a sign-capable ansatz, so the modulus RBM
    # gets a phase network: complex(rbm x fully_connected).
    x_cfg = base_config(
        wavefunction_type='complex',
        composite_wavefunction_types=('rbm', 'fully_connected'),
        composite_output_activations=('exp', 'exp'),
        num_fc_layers=2, fc_layer_size=32,
        optimizer='gradient', learning_rates=[0.05, 0.02],
        learning_rate_stops=[400], sr_diag_shift=1e-2,
        orthogonality_penalty=5.0, seed=9)
    _, _, ex, ex_sd, ov = run('ExcitedSR', x_cfg, 600,
                              lower_states=[(wf0, st0.params)])
    f_tail = float(np.mean(ov)) if ov else float('nan')
    print(f'  E1(VMC) = {ex:.5f} ± {ex_sd:.5f}  '
          f'rel {abs(ex - e1_ed)/abs(e1_ed):.2e}   <F> = {f_tail:.4f}')

    gap_a = et - e0
    gap_b = ex - e0
    gap_ed = e1_ed - e0_ed
    print('== Summary')
    print(f'  gap (sector method)  = {gap_a:.5f}')
    print(f'  gap (penalty method) = {gap_b:.5f}')
    print(f'  gap (ED)             = {gap_ed:.5f}')
    print(f'  sector-vs-penalty agreement: '
          f'{abs(gap_a - gap_b):.5f} ({abs(gap_a - gap_b)/gap_ed:.1%} '
          f'of the gap)')


if __name__ == '__main__':
    main()
