"""Symmetry projection of wavefunctions: ψ_sym(R) = mean_g ψ(g·R).

NEW capability beyond the reference: quantum-number projection onto the
trivial representation of a lattice point group (+ optional global spin
flip).  For the trivial representation this is a variational improvement
for ground states in that sector (Rayleigh–Ritz over the symmetrized
subspace) and is standard practice for pushing conv-CGS accuracy on the
square-lattice Heisenberg benchmark.

Log-domain: the orbit average is a signed logsumexp over |G| transformed
configurations, evaluated in ONE batched forward pass of the wrapped
ansatz ([batch·|G|, n_sites]) — the same fused-evaluation pattern as the
local-energy estimator.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from cgs_vmc_jax.models.base import Params, Wavefunction
from cgs_vmc_jax.ops import logamp
from cgs_vmc_jax.ops.logamp import LogAmp


class SymmetrizedWavefunction(Wavefunction):
    """Orbit-averages a wrapped ansatz over site permutations.

    perms: [n_ops, n_sites] int32 — rows are permutations g with
        (g·R)[i] = R[perms[g, i]].
    spin_flip: also average over the global Z2 spin flip R -> -R (doubles
        the orbit; valid in the Sz = 0 sector).
    """

    def __init__(self, wf: Wavefunction, perms: np.ndarray,
                 spin_flip: bool = False,
                 name: str = 'symmetrized_wavefunction'):
        self.name = name
        self._wf = wf
        perms = np.asarray(perms, np.int32)
        if perms.ndim != 2:
            raise ValueError('perms must be [n_ops, n_sites]')
        # Kept as HOST numpy deliberately: numpy constants lower from host
        # memory without a device->host read during jit lowering, and
        # traced indexing accepts numpy index tables at zero cost.
        self.perms = perms
        self.spin_flip = spin_flip
        self.n_ops = perms.shape[0] * (2 if spin_flip else 1)

    def init(self, key: jax.Array) -> Params:
        return self._wf.init(key)

    def apply(self, params: Params, configs: jax.Array) -> LogAmp:
        batch, n_sites = configs.shape
        orbit = configs[:, self.perms]            # [batch, n_perm, n_sites]
        if self.spin_flip:
            orbit = jnp.concatenate([orbit, -orbit], axis=1)
        flat = orbit.reshape(batch * self.n_ops, n_sites)
        amp = self._wf.apply(params, flat)
        signs = amp.sign.reshape(batch, self.n_ops)
        logs = amp.log.reshape(batch, self.n_ops)
        avg = logamp.sum_terms(signs, logs, axis=-1)
        return LogAmp(avg.sign, avg.log - jnp.log(float(self.n_ops)))


def square_point_group(size_x: int, size_y: int) -> np.ndarray:
    """Site-permutation table of the square-lattice point group.

    Returns [8, n_sites] for size_x == size_y (C4v: rotations + 4
    reflections), else [4, n_sites] (C2v: identity, 180° rotation, x/y
    mirrors).  Site convention: site = x * size_y + y (matches the conv
    ansatz reshape).
    """
    n = size_x * size_y
    grid = np.arange(n).reshape(size_x, size_y)
    ops = [grid]
    if size_x == size_y:
        r90 = np.rot90(grid)
        ops += [r90, np.rot90(r90), np.rot90(np.rot90(r90))]
        ops += [grid.T, np.fliplr(grid), np.flipud(grid),
                np.fliplr(np.flipud(grid)).T]
    else:
        ops += [grid[::-1, ::-1], grid[::-1, :], grid[:, ::-1]]
    perms = np.stack([op.reshape(n) for op in ops])
    # Deduplicate (e.g. 1xL degenerate cases).
    perms = np.unique(perms, axis=0)
    return perms.astype(np.int32)


def maybe_symmetrize(wf: Wavefunction, config) -> Wavefunction:
    """Wraps `wf` per config.symmetrize_* flags (square lattices only)."""
    if not getattr(config, 'symmetrize', False):
        return wf
    if config.size_x <= 1 or config.size_y <= 1:
        raise ValueError('symmetrize requires a 2-D lattice '
                         '(size_x, size_y > 1)')
    perms = square_point_group(config.size_x, config.size_y)
    return SymmetrizedWavefunction(
        wf, perms, spin_flip=getattr(config, 'symmetrize_spin_flip', True))
