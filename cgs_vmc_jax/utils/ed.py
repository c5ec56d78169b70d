"""Exact diagonalization oracle for the Heisenberg model in a fixed Sz sector.

The reference has no testing or validation machinery at all (SURVEY.md §4);
this module provides the exactness oracle the physics affords: dense/sparse
sector Hamiltonians, exact ground states, and exact expectation values that
unit/integration tests and the FullVector ansatz check against.

Convention matches the reference operators (cgs_vmc/operators.py:137-169):
H = sum_bonds [ 0.25*jz*sigma_i*sigma_j  +  0.5*jx*(exchange term) ], i.e.
S_i.S_j with S = sigma/2 and transverse coupling jx, longitudinal jz.
"""

from __future__ import annotations

import numpy as np

from cgs_vmc_jax import basis as basis_lib


def heisenberg_matrix(
    n_sites: int,
    bonds: np.ndarray,
    j_x: float = 1.0,
    j_z: float = 1.0,
    n_down: int | None = None,
    sparse: bool | None = None,
    couplings: np.ndarray | None = None,
    offdiag_couplings: np.ndarray | None = None,
    twist_phases: np.ndarray | None = None,
):
    """Builds the sector Hamiltonian over `enumerate_sz_basis` ordering.

    offdiag_couplings, when given, replaces `couplings` in the exchange
    (off-diagonal) terms only — the ED mirror of
    HeisenbergHamiltonian(offdiag_couplings=...) for sublattice-gauged
    models (Marshall-gauged J1–J2).

    twist_phases, when given, applies twisted boundary conditions: the
    exchange on bond b becomes J_x/2 (e^{i d_b} S+_i S-_j + h.c.) with
    d_b = twist_phases[b] — the ED mirror of
    HeisenbergHamiltonian(twist_phases=...); the matrix is then complex
    Hermitian.

    Returns a scipy CSR matrix when `sparse` (default for dim > 4096),
    else a dense float64 (complex128 under twist) array.
    """
    states = basis_lib.enumerate_sz_basis(n_sites, n_down)
    dim = states.shape[0]
    if sparse is None:
        sparse = dim > 4096
    index = {s.astype(np.int8).tobytes(): r for r, s in enumerate(states)}
    bonds = np.asarray(bonds)
    if couplings is None:
        couplings = np.ones(bonds.shape[0], dtype=np.float64)
    couplings = np.asarray(couplings, np.float64).reshape(-1)
    if offdiag_couplings is None:
        offdiag_couplings = couplings
    offdiag_couplings = np.asarray(offdiag_couplings, np.float64).reshape(-1)
    if twist_phases is not None:
        twist_phases = np.asarray(twist_phases, np.float64).reshape(-1)

    rows, cols, vals = [], [], []
    diag = np.zeros(dim, dtype=np.float64)
    for r in range(dim):
        s = states[r].astype(np.int8)
        for b, (i, j) in enumerate(bonds):
            si, sj = int(s[i]), int(s[j])
            diag[r] += 0.25 * j_z * couplings[b] * si * sj
            if si != sj:
                flipped = s.copy()
                flipped[i], flipped[j] = sj, si
                c = index[flipped.tobytes()]
                rows.append(r)
                cols.append(c)
                val = 0.5 * j_x * offdiag_couplings[b]
                if twist_phases is not None:
                    # <r|H|c>: c = r with (i, j) exchanged; the S+_i S-_j
                    # e^{+i d_b} term connects when r has s_i = +1
                    # (matches HeisenbergHamiltonian.connected).
                    val = val * np.exp(0.5j * twist_phases[b] * (si - sj))
                vals.append(val)
    if sparse:
        import scipy.sparse as sp
        mat = sp.csr_matrix((vals, (rows, cols)), shape=(dim, dim))
        mat = mat + sp.diags(diag)
        return mat
    dtype = np.complex128 if twist_phases is not None else np.float64
    # Note: no duplicate (r, c) pairs occur for simple bond lists, but the
    # reference's 1-D chain of n=2 repeats a bond; accumulate to be safe.
    mat = np.zeros((dim, dim), dtype=dtype)
    if len(rows):
        np.add.at(mat, (np.asarray(rows), np.asarray(cols)),
                  np.asarray(vals, dtype=dtype))
    mat[np.arange(dim), np.arange(dim)] += diag
    return mat


def ground_state(
    n_sites: int,
    bonds: np.ndarray,
    j_x: float = 1.0,
    j_z: float = 1.0,
    n_down: int | None = None,
    couplings: np.ndarray | None = None,
    offdiag_couplings: np.ndarray | None = None,
    twist_phases: np.ndarray | None = None,
) -> tuple[float, np.ndarray]:
    """Exact ground-state (energy, sector vector)."""
    mat = heisenberg_matrix(n_sites, bonds, j_x, j_z, n_down,
                            couplings=couplings,
                            offdiag_couplings=offdiag_couplings,
                            twist_phases=twist_phases)
    if hasattr(mat, 'toarray') and mat.shape[0] > 4096:
        import scipy.sparse.linalg as spla
        vals, vecs = spla.eigsh(mat, k=1, which='SA')
        return float(vals[0]), vecs[:, 0]
    dense = mat.toarray() if hasattr(mat, 'toarray') else mat
    vals, vecs = np.linalg.eigh(dense)
    return float(vals[0]), vecs[:, 0]


def ising_matrix(
    n_sites: int,
    bonds: np.ndarray,
    h_x: float = 1.0,
    j_zz: float = 1.0,
    couplings: np.ndarray | None = None,
    sparse: bool | None = None,
):
    """Transverse-field Ising Hamiltonian over the FULL 2^N space.

    H = -J sum_bonds sz_i sz_j - h sum_i sx_i (Pauli convention, matching
    ops/ising.py).  Basis ordering matches `basis.enumerate_full_basis`:
    row index r holds spin +1 at site k iff bit k of r is set.  Returns a
    scipy CSR matrix when `sparse` (default for dim > 4096, reaching 4x4
    and beyond), else a dense float64 array.
    """
    dim = 2 ** n_sites
    if sparse is None:
        sparse = dim > 4096
    bonds = np.asarray(bonds)
    if couplings is None:
        couplings = np.ones(bonds.shape[0], dtype=np.float64)
    couplings = np.asarray(couplings, np.float64).reshape(-1)

    r = np.arange(dim, dtype=np.int64)
    diag = np.zeros(dim, dtype=np.float64)
    for b, (i, j) in enumerate(bonds):
        s_i = 2.0 * ((r >> int(i)) & 1) - 1.0
        s_j = 2.0 * ((r >> int(j)) & 1) - 1.0
        diag += -j_zz * couplings[b] * s_i * s_j
    if sparse:
        import scipy.sparse as sp
        rows = np.tile(r, n_sites)
        cols = np.concatenate([r ^ (1 << k) for k in range(n_sites)])
        offdiag = sp.csr_matrix(
            (np.full(dim * n_sites, -h_x), (rows, cols)), shape=(dim, dim))
        return offdiag + sp.diags(diag)
    mat = np.zeros((dim, dim), dtype=np.float64)
    mat[r, r] = diag
    for k in range(n_sites):
        mat[r, r ^ (1 << k)] += -h_x
    return mat


def ising_ground_state(
    n_sites: int,
    bonds: np.ndarray,
    h_x: float = 1.0,
    j_zz: float = 1.0,
    couplings: np.ndarray | None = None,
) -> tuple[float, np.ndarray]:
    """Exact TFIM ground state (energy, full-space vector)."""
    mat = ising_matrix(n_sites, bonds, h_x, j_zz, couplings)
    if hasattr(mat, 'toarray'):
        import scipy.sparse.linalg as spla
        vals, vecs = spla.eigsh(mat, k=1, which='SA')
        return float(vals[0]), vecs[:, 0]
    vals, vecs = np.linalg.eigh(mat)
    return float(vals[0]), vecs[:, 0]


def rayleigh_quotient(
    vector: np.ndarray,
    n_sites: int,
    bonds: np.ndarray,
    j_x: float = 1.0,
    j_z: float = 1.0,
    n_down: int | None = None,
) -> float:
    """<v|H|v> / <v|v> for a sector vector (gradient-check oracle)."""
    mat = heisenberg_matrix(n_sites, bonds, j_x, j_z, n_down)
    hv = mat @ vector
    return float(vector @ hv / (vector @ vector))
