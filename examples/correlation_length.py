"""Second-moment staggered correlation length from the committed S(q)
maps (pure post-processing — no accelerator, no sampling).

examples/staggered_flagship.py saves the full-Brillouin-zone
longitudinal structure factor S(q) for each flagship artifact
(artifacts/staggered_flagship.json).  The second-moment correlation
length around the ordering vector Q = (pi, pi),

    xi_2 = sqrt(S(Q)/S(Q + dq) - 1) / (2 sin(|dq|/2)),  dq = 2pi/L,

is the standard finite-size diagnostic: in a long-range-ordered ground
state S(Q) carries a Bragg weight ~ N m_s^2 while S(Q + dq) stays O(1),
so xi_2/L must GROW with L; a flat or falling xi_2/L says the states
carry less long-range order as L grows — the same conclusion the
(failed) m_s 1/L extrapolation and the exact 4x4 deficit measurement
(examples/order_param_4x4_check.py) point to, from an independent
estimator.  The reference framework has no momentum-space observables
at all (cgs_vmc/evaluation.py ships only the energy).

Usage: python examples/correlation_length.py
"""
import json

import numpy as np

SRC = 'artifacts/staggered_flagship.json'
data = json.load(open(SRC))
out = []
for r in data['rows']:
    L = r['L']
    bz = np.asarray(r['sq_map'])
    k = L // 2                      # q index of pi on the 2pi k/L grid
    s_q = bz[k, k]
    # average the four symmetry-equivalent nearest q-neighbours of Q
    s_nb = (bz[(k + 1) % L, k] + bz[(k - 1) % L, k]
            + bz[k, (k + 1) % L] + bz[k, (k - 1) % L]) / 4.0
    xi = np.sqrt(max(s_q / s_nb - 1.0, 0.0)) / (2 * np.sin(np.pi / L))
    out.append(dict(L=int(L), s_q=float(s_q), s_nb=float(s_nb),
                    xi=float(xi), xi_over_L=float(xi / L)))
    print(f'L={L:2d}: S(Q) = {s_q:.4f}   S(Q+dq) = {s_nb:.4f}   '
          f'xi_2 = {xi:.3f}   xi_2/L = {xi / L:.3f}')

# Real-space staggered correlator C~(r) = (-1)^(x+y) <Sz_0 Sz_r> by
# inverse FT of the S(q) grid (ifft2 carries the 1/N): C~(0) = 1/4
# exactly (estimator sanity), C~(1) reproduces the observable suite's
# independent SzSz(d=1) (L=6: 0.1129 vs 0.11296), and the large-r
# plateau is the order parameter m_s^2/3 per component.
for r, o in zip(data['rows'], out):
    L = r['L']
    bz = np.asarray(r['sq_map'])
    cr = np.real(np.fft.ifft2(bz))
    x = np.arange(L)
    cs = ((-1.0) ** np.add.outer(x, x)) * cr
    o['c_stag_axis'] = [float(cs[d, 0]) for d in range(L // 2 + 1)]
    o['c_stag_diag'] = [float(cs[d, d]) for d in range(L // 2 + 1)]
    print(f'L={L:2d}: staggered C(r) axis ' +
          ' '.join(f'{v:+.4f}' for v in o['c_stag_axis']))

with open('artifacts/correlation_length.json', 'w') as f:
    json.dump({'source': SRC, 'rows': out}, f)
print('wrote artifacts/correlation_length.json')
