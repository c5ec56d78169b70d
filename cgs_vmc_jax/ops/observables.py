"""Additional observables beyond the Hamiltonian.

The reference's evaluator accepts any `Operator` (cgs_vmc/evaluation.py:77)
but ships only the Heisenberg operators; these fill in the standard
measurement set for spin systems.  All follow the Operator protocol so
`evaluate_operator` measures them with the same sampling machinery.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from cgs_vmc_jax.models.base import Params, Wavefunction
from cgs_vmc_jax.ops.heisenberg import Operator
from cgs_vmc_jax.ops.logamp import LogAmp


class SzSzCorrelation(Operator):
    """C = (1/|pairs|) Σ_(i,j) Sᶻᵢ Sᶻⱼ — diagonal in the computational
    basis, so the local value needs no extra wavefunction evaluations."""

    def __init__(self, pairs: Sequence[Tuple[int, int]]):
        pairs = np.asarray(pairs, dtype=np.int32)
        if pairs.ndim != 2 or pairs.shape[1] != 2:
            raise ValueError(f'pairs must be [n_pairs, 2], got {pairs.shape}')
        # Host numpy, not device-resident (DEVELOPMENT.md constant rule):
        # static indices lower from host memory unconditionally.
        self.pairs = pairs

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: jax.Array, amp: Optional[LogAmp] = None
                    ) -> jax.Array:
        del wf, params, amp  # diagonal observable
        s_i = configs[:, self.pairs[:, 0]]
        s_j = configs[:, self.pairs[:, 1]]
        return 0.25 * jnp.mean(s_i * s_j, axis=-1)


class SpinStructureFactor(Operator):
    """Momentum-resolved longitudinal structure factor

        S(q) = (1/N) ⟨ |Σᵢ e^{i q·rᵢ} Sᶻᵢ|² ⟩

    — diagonal in the computational basis.  For the AFM ordering vector
    (q = π on a chain, q = (π, π) on the square lattice) this is N times
    the staggered magnetization squared; generic q resolves the full
    spin-ordering pattern.  The reference has no momentum-space
    observables at all (cgs_vmc/evaluation.py ships only the energy).
    """

    def __init__(self, q: Sequence[float], positions: np.ndarray):
        """q: momentum vector [dim]; positions: site coordinates [N, dim]."""
        q = np.asarray(q, np.float64).reshape(-1)
        positions = np.asarray(positions, np.float64)
        if positions.ndim != 2 or positions.shape[1] != q.shape[0]:
            raise ValueError(
                f'positions must be [n_sites, {q.shape[0]}], '
                f'got {positions.shape}')
        phase = positions @ q                       # q·rᵢ, [n_sites]
        self.cos_qr = np.cos(phase).astype(np.float32)
        self.sin_qr = np.sin(phase).astype(np.float32)

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: jax.Array, amp: Optional[LogAmp] = None
                    ) -> jax.Array:
        del wf, params, amp  # diagonal observable
        n = configs.shape[-1]
        sz = 0.5 * configs
        re = jnp.sum(sz * self.cos_qr, axis=-1)
        im = jnp.sum(sz * self.sin_qr, axis=-1)
        return (re ** 2 + im ** 2) / n


class TransverseCorrelation(Operator):
    """C⊥ = (1/|pairs|) Σ_(i,j) ⟨SˣᵢSˣⱼ + SʸᵢSʸⱼ⟩ — the OFF-DIAGONAL
    spin-spin correlator: ½(S⁺ᵢS⁻ⱼ + S⁻ᵢS⁺ⱼ) exchanges antiparallel
    spins, so the local value needs amplitude ratios ψ(R_ij)/ψ(R),
    evaluated for all pairs in one fused forward pass exactly like the
    Heisenberg off-diagonal term (ops/heisenberg.py:82-115).  For the
    isotropic Heisenberg ground state ⟨C⊥⟩ = 2⟨SᶻSᶻ⟩ by SU(2) symmetry —
    the oracle the tests use."""

    def __init__(self, pairs: Sequence[Tuple[int, int]],
                 sample_chunk: int = 0,
                 pair_signs: Optional[np.ndarray] = None):
        """pair_signs: optional ±1 weight per pair — e.g. the Marshall
        sublattice product ε_i·ε_j, which converts the correlator measured
        in a gauge-rotated state (trained with jx < 0) into the PHYSICAL
        transverse correlator per pair (the gauge U = Π_B σᶻ flips Sx, Sy
        on sublattice B).  Implemented as per-bond couplings of the fused
        exchange kernel, so it is exact even when the signs are not
        uniform across pairs (mixed same-/cross-sublattice displacements)."""
        from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
        pairs = np.asarray(pairs, dtype=np.int32)
        couplings = None
        if pair_signs is not None:
            couplings = np.asarray(pair_signs, np.float64).reshape(-1)
            if couplings.shape[0] != pairs.shape[0]:
                raise ValueError(
                    f'pair_signs must have one entry per pair: '
                    f'{couplings.shape[0]} vs {pairs.shape[0]}')
        # Reuse the batched exchange kernel: jx=1 off-diagonal only, and
        # average instead of summing over "bonds".
        self._exchange = HeisenbergHamiltonian(
            pairs, j_x=1.0, j_z=0.0, sample_chunk=sample_chunk,
            couplings=couplings)
        self.n_pairs = pairs.shape[0]

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: jax.Array, amp: Optional[LogAmp] = None
                    ) -> jax.Array:
        return self._exchange.local_value(wf, params, configs,
                                          amp) / self.n_pairs


class TotalSpinSquared(Operator):
    """S_tot^2 = sum_ij S_i . S_j = (3N/4) + 2 sum_{i<j} S_i . S_j —
    the SU(2) Casimir.  A singlet ground state (the AFM Heisenberg case
    on any bipartite lattice) gives exactly 0; measuring it on a trained
    state quantifies the residual spin contamination, a physics
    diagnostic the energy alone cannot provide.

    Off-diagonal over ALL site pairs: implemented as a Heisenberg
    operator on the complete graph (the fused connected-config machinery
    handles the K = N(N-1)/2 fan-out; pass sample_chunk for large N).

    NOTE on gauge: S^2 does NOT commute with the Marshall rotation, so a
    state trained with heisenberg_jx = -1 must be measured with the
    exchange terms gauge-corrected per pair: cross-sublattice pairs flip
    sign (off-diagonal coupling -1), same-sublattice pairs don't.  Pass
    the ±1 site mask as `sublattice` and the correction is applied
    inside the fused kernel; omit it for states in the bare basis.
    """

    def __init__(self, n_sites: int, sample_chunk: int = 0,
                 sublattice: Optional[np.ndarray] = None):
        from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
        pairs = np.asarray(
            [(i, j) for i in range(n_sites) for j in range(i + 1, n_sites)],
            np.int32)
        offdiag = None
        if sublattice is not None:
            sub = np.asarray(sublattice, np.float32).reshape(-1)
            offdiag = sub[pairs[:, 0]] * sub[pairs[:, 1]]
        self.n_sites = n_sites
        self._heis = HeisenbergHamiltonian(
            pairs, 1.0, 1.0, sample_chunk=sample_chunk,
            offdiag_couplings=offdiag)

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: jax.Array, amp: Optional[LogAmp] = None
                    ) -> jax.Array:
        pair_sum = self._heis.local_value(wf, params, configs, amp)
        return 0.75 * self.n_sites + 2.0 * pair_sum


def chain_positions(n_sites: int) -> np.ndarray:
    """1-D chain site coordinates [N, 1] (unit spacing)."""
    return np.arange(n_sites, dtype=np.float64)[:, None]


def square_positions(size_x: int, size_y: int) -> np.ndarray:
    """Square-lattice site coordinates [N, 2], row-major (x slow, y fast) —
    matching the reference's flat-index convention
    (cgs_vmc/wavefunctions.py:560-566 reshape to [size_x, size_y])."""
    xs, ys = np.meshgrid(np.arange(size_x), np.arange(size_y), indexing='ij')
    return np.stack([xs.ravel(), ys.ravel()], axis=-1).astype(np.float64)


class StaggeredMagnetizationSquared(Operator):
    """(Σᵢ εᵢ Sᶻᵢ / N)² with εᵢ the ±1 sublattice sign — the standard AFM
    order parameter (diagonal)."""

    def __init__(self, sublattice: np.ndarray):
        self.sublattice = np.asarray(sublattice, np.float32)

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: jax.Array, amp: Optional[LogAmp] = None
                    ) -> jax.Array:
        del wf, params, amp
        n = configs.shape[-1]
        stag = jnp.sum(configs * self.sublattice * 0.5, axis=-1) / n
        return stag ** 2
