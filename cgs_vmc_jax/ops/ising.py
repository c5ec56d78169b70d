"""Transverse-field Ising model — a second Hamiltonian family.

BEYOND-REFERENCE capability: the reference implements exactly one operator
family (Heisenberg exchange, cgs_vmc/operators.py:128-287), and its
Sz-conserving sampler cannot even represent the TFIM's state space.  Here
the `LocalOperator` protocol (ops/heisenberg.py) makes the addition ~40
lines, and the single-spin-flip Metropolis move (sampler/metropolis.py,
``mc_move_type='flip'``) samples the full 2^N Hilbert space the model
requires.

Convention — Pauli matrices (sigma = 2S), the standard TFIM form:

    H = - J sum_{(i,j) in bonds} sigma^z_i sigma^z_j
        - h sum_i sigma^x_i

so for spin values s = ±1:
    diagonal(R)        = -J sum_b c_b s_i s_j
    <R^(i)|H|psi>-term = -h psi(R^(i)),  R^(i) = R with spin i flipped.

For J > 0 (ferromagnetic) and h > 0 every off-diagonal element is -h < 0,
so by Perron–Frobenius the ground state is positive in this basis —
representable by any positive ansatz (RBM/FC with exp output), no sign
gauge needed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from cgs_vmc_jax.ops.heisenberg import LocalOperator


class TransverseFieldIsingHamiltonian(LocalOperator):
    """H = -J sum_bonds sigma^z sigma^z - h sum_i sigma^x (Pauli convention).

    Args:
      bonds: [n_bonds, 2] int site pairs for the ZZ coupling.
      h_x: transverse field strength h.
      j_zz: ZZ coupling J (J > 0 ferromagnetic).
      sample_chunk: see LocalOperator (fan-out here is batch × n_sites).
      couplings: optional [n_bonds] per-bond factor multiplying J.
    """

    def __init__(self, bonds: np.ndarray, h_x: float = 1.0,
                 j_zz: float = 1.0, sample_chunk: int = 0,
                 couplings: Optional[np.ndarray] = None):
        bonds = np.asarray(bonds, dtype=np.int32)
        if bonds.ndim != 2 or bonds.shape[1] != 2:
            raise ValueError(f'bonds must be [n_bonds, 2], got {bonds.shape}')
        # Host numpy (not device arrays): see ops/heisenberg.py.
        self.bonds = bonds
        self.n_bonds = bonds.shape[0]
        self.h_x = float(h_x)
        self.j_zz = float(j_zz)
        self.sample_chunk = int(sample_chunk)
        if couplings is None:
            self.couplings = None
        else:
            couplings = np.asarray(couplings, np.float32).reshape(-1)
            if couplings.shape[0] != self.n_bonds:
                raise ValueError(
                    f'couplings must be [n_bonds={self.n_bonds}], '
                    f'got {couplings.shape}')
            self.couplings = couplings

    def diagonal(self, configs: jax.Array) -> jax.Array:
        """-J sum_b c_b s_i s_j, [batch]."""
        s_i = configs[:, self.bonds[:, 0]]
        s_j = configs[:, self.bonds[:, 1]]
        terms = s_i * s_j
        if self.couplings is not None:
            terms = terms * self.couplings
        return -self.j_zz * jnp.sum(terms, axis=-1)

    def connected(self, configs: jax.Array
                  ) -> Tuple[jax.Array, jax.Array]:
        """All single-spin-flip configurations, each with weight -h.

        Returns:
          flipped: [batch, n_sites, n_sites] — configs with site k flipped.
          weights: [batch, n_sites] — constant -h.
        """
        batch, n_sites = configs.shape
        sign_flip = 1.0 - 2.0 * jnp.eye(n_sites, dtype=configs.dtype)
        flipped = configs[:, None, :] * sign_flip[None]
        weights = jnp.full((batch, n_sites), -self.h_x, configs.dtype)
        return flipped, weights
