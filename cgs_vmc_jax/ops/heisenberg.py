"""Heisenberg operators with batched connected-configuration evaluation.

Re-design of the reference operator stack (cgs_vmc/operators.py:13-287).
The reference evaluated ONE wavefunction forward pass per bond
(operators.py:241-247), replicating the network graph n_bonds times; here
all spin-exchanged configurations are generated as one
[batch, n_bonds, n_sites] tensor with pure arithmetic (no scatters) and
log-amplitudes are evaluated in a single fused forward pass over
[batch * n_bonds, n_sites] — the SURVEY.md §7.3 north-star requirement.

Conventions (operators.py:154-169):
  diagonal  <R|Sz_i Sz_j|R>            = 0.25 * j_z * s_i * s_j
  off-diag  <R|Sx_i Sx_j + Sy_i Sy_j|psi> = 0.5 * j_x * [s_i != s_j] * psi(R_ij)
with R_ij = R with spins i,j exchanged, so the local value is
  E_loc(R) = sum_b 0.25*j_z*s_i*s_j + 0.5*j_x*mask_b * psi(R_b)/psi(R),
and the amplitude ratio is sign_b*sign * exp(log_b - log) — overflow-free.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from cgs_vmc_jax.models.base import Params, TransformedWavefunction, Wavefunction
from cgs_vmc_jax.ops import logamp
from cgs_vmc_jax.ops.logamp import LogAmp


class Operator:
    """Quantum operator protocol (reference operators.py:13-87), log-domain.

    local_value: E_loc(R) = <R|O|psi>/<R|psi>            -> [batch]
    apply_in_place: <R|O|psi> as a LogAmp                 -> LogAmp
    apply: O|psi> wrapped as a Wavefunction.
    """

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: jax.Array, amp: Optional[LogAmp] = None
                    ) -> jax.Array:
        raise NotImplementedError

    def apply_in_place(self, wf: Wavefunction, params: Params,
                       configs: jax.Array, amp: Optional[LogAmp] = None
                       ) -> LogAmp:
        raise NotImplementedError

    def apply(self, wf: Wavefunction) -> Wavefunction:
        raise NotImplementedError


class LocalOperator(Operator):
    """Base for operators given by a diagonal plus a sparse connected set:

        <R|O|psi> = diag(R)·psi(R) + sum_k w_k(R)·psi(R_k),

    where subclasses supply ``diagonal(configs) -> [batch]`` and
    ``connected(configs) -> (configs_k [batch, K, n_sites],
    weights [batch, K])``.  The base provides the fused single-forward
    local value (SURVEY.md §7.3: ONE [batch·K] pass instead of the
    reference's per-term graph replication, operators.py:241-247), the
    sample-chunked variant, and the Operator protocol methods.

    sample_chunk: when > 0, the fused connected-configuration forward pass
    is evaluated `sample_chunk` samples at a time via `lax.map` — the
    fan-out is batch × K configurations (× the symmetry-orbit size for
    projected ansatzes), which can exceed device memory for large lattices.
    """

    sample_chunk: int = 0

    def diagonal(self, configs: jax.Array) -> jax.Array:
        raise NotImplementedError

    def connected(self, configs: jax.Array) -> Tuple[jax.Array, jax.Array]:
        raise NotImplementedError

    def _offdiag_ratio_sum(self, wf: Wavefunction, params: Params,
                           configs: jax.Array, amp: LogAmp) -> jax.Array:
        """sum_k w_k * psi(R_k)/psi(R) in one fused forward pass, [batch]."""
        batch, n_sites = configs.shape
        flipped, weights = self.connected(configs)
        n_conn = flipped.shape[1]
        flat = flipped.reshape(batch * n_conn, n_sites)
        amp_f = wf.apply(params, flat)
        log_f = amp_f.log.reshape(batch, n_conn)
        sign_f = amp_f.sign.reshape(batch, n_conn)
        ratios = (sign_f * amp.sign[:, None]
                  * jnp.exp(log_f - amp.log[:, None]))
        return jnp.sum(weights * ratios, axis=-1)

    def local_value(self, wf: Wavefunction, params: Params,
                    configs: jax.Array, amp: Optional[LogAmp] = None
                    ) -> jax.Array:
        chunk = self.sample_chunk
        if chunk and configs.shape[0] > chunk:
            # Pad to a chunk multiple (repeating the first sample) rather
            # than silently falling back to the full fan-out the chunking
            # exists to prevent; padded results are dropped.
            batch = configs.shape[0]
            n_chunks = -(-batch // chunk)
            pad = n_chunks * chunk - batch

            def pad_chunks(x):
                if pad:
                    filler = jnp.broadcast_to(x[:1], (pad,) + x.shape[1:])
                    x = jnp.concatenate([x, filler], axis=0)
                return x.reshape((n_chunks, chunk) + x.shape[1:])

            slices = pad_chunks(configs)
            if amp is None:
                def one_chunk(c):
                    a = wf.apply(params, c)
                    return self.diagonal(c) + self._offdiag_ratio_sum(
                        wf, params, c, a)

                return jax.lax.map(one_chunk, slices).reshape(-1)[:batch]

            # Thread the caller's denominator amplitudes through instead of
            # recomputing psi(R) per chunk (the epoch already evaluated
            # them for the sampler cache / SR residuals).
            amp_chunks = (pad_chunks(amp.sign), pad_chunks(amp.log))

            def one_chunk_amp(args):
                c, sign, log = args
                return self.diagonal(c) + self._offdiag_ratio_sum(
                    wf, params, c, LogAmp(sign, log))

            return jax.lax.map(
                one_chunk_amp,
                (slices, amp_chunks[0], amp_chunks[1])).reshape(-1)[:batch]
        if amp is None:
            amp = wf.apply(params, configs)
        return self.diagonal(configs) + self._offdiag_ratio_sum(
            wf, params, configs, amp)

    def apply_in_place(self, wf: Wavefunction, params: Params,
                       configs: jax.Array, amp: Optional[LogAmp] = None
                       ) -> LogAmp:
        """<R|O|psi> = psi(R) * O_loc(R) as a LogAmp."""
        if amp is None:
            amp = wf.apply(params, configs)
        o_loc = self.local_value(wf, params, configs, amp)
        return LogAmp(amp.sign * jnp.sign(o_loc),
                      amp.log + jnp.log(jnp.abs(o_loc)))

    def apply(self, wf: Wavefunction) -> Wavefunction:
        def transform(params: Params, configs: jax.Array) -> LogAmp:
            return self.apply_in_place(wf, params, configs)
        return TransformedWavefunction(transform, wf, name='o_applied')


class HeisenbergHamiltonian(LocalOperator):
    """H = sum_{(i,j) in bonds} J_z Sz_i Sz_j + J_x (Sx_i Sx_j + Sy_i Sy_j)."""

    def __init__(self, bonds: np.ndarray, j_x: float = 1.0, j_z: float = 1.0,
                 sample_chunk: int = 0,
                 couplings: Optional[np.ndarray] = None,
                 offdiag_couplings: Optional[np.ndarray] = None,
                 twist_phases: Optional[np.ndarray] = None):
        """couplings: optional [n_bonds] per-bond factor J_b multiplying
        both the diagonal and off-diagonal matrix elements (J1–J2 and
        arbitrary weighted lattices; the reference's J.txt carried bare
        bond indices only, cgs_vmc/run_training.py:105-107).

        offdiag_couplings: optional [n_bonds] factor that REPLACES
        ``couplings`` in the off-diagonal (exchange) terms only, leaving
        the diagonal Sz·Sz couplings as given.  This expresses
        sublattice-gauged Hamiltonians whose off-diagonal signs differ
        per bond — e.g. the Marshall-gauged J1–J2 model, where rotating
        sublattice A by pi about z flips the exchange sign on
        (bipartite-connecting) J1 bonds but not on (same-sublattice) J2
        bonds: diagonal (J1, J2), off-diagonal (−J1, +J2).  The gauge is
        a unitary, so the spectrum is identical (tests/test_j1j2.py) but
        the ground state is far closer to positive, which positive or
        phase-augmented ansatzes represent much more easily."""
        bonds = np.asarray(bonds, dtype=np.int32)
        if bonds.ndim != 2 or bonds.shape[1] != 2:
            raise ValueError(f'bonds must be [n_bonds, 2], got {bonds.shape}')
        # Bond/coupling tables stay HOST numpy: numpy constants lower from
        # host memory with no device->host read at jit-lowering time (see
        # models/symmetry.py).
        self.bonds = bonds
        self.n_bonds = bonds.shape[0]
        self.j_x = float(j_x)
        self.j_z = float(j_z)
        self.sample_chunk = int(sample_chunk)

        def _check(arr, name):
            if arr is None:
                return None
            arr = np.asarray(arr, np.float32).reshape(-1)
            if arr.shape[0] != self.n_bonds:
                raise ValueError(
                    f'{name} must be [n_bonds={self.n_bonds}], '
                    f'got {arr.shape}')
            return arr

        self.couplings = _check(couplings, 'couplings')
        self.offdiag_couplings = _check(offdiag_couplings,
                                        'offdiag_couplings')
        # Twisted boundary conditions (spin stiffness): per-bond gauge
        # phase delta_b = theta_i - theta_j.  The exchange term becomes
        #   J_x/2 (e^{i delta_b} S+_i S-_j + e^{-i delta_b} S-_i S+_j),
        # so the connected weight picks up exp(i delta_b (s_i - s_j)/2)
        # and local values are COMPLEX.  E(phi) curvature at phi=0 gives
        # the spin stiffness rho_s = N/L^2 * d2(E/N)/dphi2 — a standard
        # superfluid-density-style observable the reference lacks
        # (lattice.twist_phases builds uniform-gradient phase tables).
        self.twist_phases = _check(twist_phases, 'twist_phases')

    # ------------------------------------------------------------------

    def diagonal(self, configs: jax.Array) -> jax.Array:
        """Sum of Sz Sz matrix elements, [batch]."""
        s_i = configs[:, self.bonds[:, 0]]
        s_j = configs[:, self.bonds[:, 1]]
        terms = s_i * s_j
        if self.couplings is not None:
            terms = terms * self.couplings
        return 0.25 * self.j_z * jnp.sum(terms, axis=-1)

    def connected(self, configs: jax.Array
                  ) -> Tuple[jax.Array, jax.Array]:
        """All spin-exchanged configurations and their matrix elements.

        Returns:
          flipped: [batch, n_bonds, n_sites] — configs with bond b's spins
              exchanged (identical to configs where the bond is parallel).
          weights: [batch, n_bonds] — 0.5*j_x where antiparallel, else 0.
        """
        n_sites = configs.shape[-1]
        s_i = configs[:, self.bonds[:, 0]]  # [batch, n_bonds]
        s_j = configs[:, self.bonds[:, 1]]
        onehot_i = jax.nn.one_hot(self.bonds[:, 0], n_sites,
                                  dtype=configs.dtype)
        onehot_j = jax.nn.one_hot(self.bonds[:, 1], n_sites,
                                  dtype=configs.dtype)
        delta = (s_j - s_i)[..., None] * onehot_i[None] \
            + (s_i - s_j)[..., None] * onehot_j[None]
        flipped = configs[:, None, :] + delta
        weights = 0.5 * self.j_x * (s_i * s_j < 0).astype(configs.dtype)
        offdiag = (self.offdiag_couplings
                   if self.offdiag_couplings is not None else self.couplings)
        if offdiag is not None:
            weights = weights * offdiag
        if self.twist_phases is not None:
            # <R|H|R_b> for antiparallel (s_i, s_j): the S+_i S-_j term
            # connects when s_i = +1 (it raises i in R_b), giving
            # e^{+i delta_b}; the conjugate term when s_i = -1.
            weights = weights * jnp.exp(
                0.5j * self.twist_phases * (s_i - s_j))
        return flipped, weights


class HeisenbergBond(HeisenbergHamiltonian):
    """A single S_i . S_j bond (reference operators.py:128-209)."""

    def __init__(self, bond: Tuple[int, int], j_x: float = 1.0,
                 j_z: float = 1.0):
        super().__init__(np.asarray([bond], dtype=np.int32), j_x, j_z)


def ite_target(hamiltonian: HeisenbergHamiltonian, wf: Wavefunction,
               beta: float) -> Wavefunction:
    """(1 - beta*H)|psi> as a wavefunction — the IT-SWO supervisor target
    (reference training.py:663-666 built it from apply_in_place)."""
    def transform(params: Params, configs: jax.Array) -> LogAmp:
        amp = wf.apply(params, configs)
        e_loc = hamiltonian.local_value(wf, params, configs, amp)
        factor = 1.0 - beta * e_loc
        return LogAmp(amp.sign * jnp.sign(factor),
                      amp.log + jnp.log(jnp.abs(factor)))
    return TransformedWavefunction(transform, wf, name='ite_target')
