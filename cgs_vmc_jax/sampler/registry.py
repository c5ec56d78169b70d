"""Fast-path sampler registry: delta-logpsi-style dispatch by ansatz.

SURVEY.md §7 asked for an incremental-amplitude fast-path protocol "from
day one"; rounds 1-2 instead grew an if-chain in optim/common.py.  This
registry replaces it: each fast path is an entry with its own
``supports(wf, config)`` predicate and ``make(wf, config)`` factory, and
third-party ansatzes register theirs with :func:`register_fast_path`
without touching framework code.

Entries are consulted in DESCENDING priority; the first whose
``supports`` returns True wins, and the generic per-chain Metropolis
sampler (priority -inf, always supported) is the fallback.  Built-in
priorities encode the round-2 dispatch semantics exactly:

====================  ========  =====================================
entry                 priority  condition
====================  ========  =====================================
mtm                        100  config.mtm_candidates > 1 (explicit)
exact_autoregressive        95  AutoregressiveSpinModel (exact draws)
mps_env                     90  config.mps_incremental_sweeps (opt-in)
rbm_pallas                  50  pure RBM + GPU backend + use_fast_sampler
jastrow_delta               45  plain Jastrow + use_fast_sampler
pbdg_sherman_morrison       40  ProjectedBDG + use_fast_sampler
generic                   -inf  always
====================  ========  =====================================

Explicit knobs outrank automatic dispatch; automatic dispatch ranks by
measured speedup (RESULTS.md throughput table).

On FullyConnectedNNB there is deliberately NO incremental entry: the
backflow matrix M(R) is emitted by an MLP of the FULL configuration
(reference wavefunctions.py:931-998), so a single pair exchange moves
every entry of M — the det update is not low-rank in any basis, unlike
ProjectedBDG whose pairing matrix is configuration-independent and only
has its row/column selection change.  Any "fast" path would still pay
the full MLP forward per proposal; the measured ceiling of skipping only
the slogdet is below 1.6x (see tests/test_registry.py::
test_nnb_rank1_justification, which times the MLP-emission vs slogdet
split), not worth a second amplitude code path that can drift.
"""

from __future__ import annotations

import bisect
from typing import Callable, List, NamedTuple, Optional

import jax

from cgs_vmc_jax.models.base import Wavefunction

# sweeps_fn(params, sampler_state, num_sweeps) -> sampler_state
SweepsFn = Callable[..., object]


class FastPath(NamedTuple):
    name: str
    priority: float
    supports: Callable[[Wavefunction, object], bool]
    make: Callable[[Wavefunction, object], SweepsFn]


_REGISTRY: List[FastPath] = []


def register_fast_path(name: str, *, priority: float,
                       supports: Callable[[Wavefunction, object], bool],
                       make: Callable[[Wavefunction, object], SweepsFn],
                       ) -> None:
    """Registers a sampler fast path (idempotent by name: re-registering
    an existing name replaces it, so modules can be reloaded)."""
    global _REGISTRY
    _REGISTRY = [e for e in _REGISTRY if e.name != name]
    entry = FastPath(name, float(priority), supports, make)
    # Keep descending priority; stable for equal priorities.
    keys = [-e.priority for e in _REGISTRY]
    _REGISTRY.insert(bisect.bisect_right(keys, -entry.priority), entry)


def registered_fast_paths() -> List[FastPath]:
    return list(_REGISTRY)


def resolve_sweeps_fn(wf: Wavefunction, config) -> SweepsFn:
    """Highest-priority supporting fast path, else the generic sampler.

    With a non-exchange move type (config.mc_move_type='flip') every
    built-in fast path declines — they all implement incremental updates
    of the Sz-conserving pair exchange — and the generic sampler runs the
    configured move.
    """
    for entry in _REGISTRY:
        if entry.supports(wf, config):
            return entry.make(wf, config)
    from cgs_vmc_jax.sampler import metropolis as mp
    move = mp.move_type(config)

    def generic(params, state, num_sweeps):
        return mp.run_sweeps(wf, params, state, num_sweeps, move)
    return generic


def resolved_name(wf: Wavefunction, config) -> str:
    """Which entry resolve_sweeps_fn would pick (for logs/tests)."""
    for entry in _REGISTRY:
        if entry.supports(wf, config):
            return entry.name
    return 'generic'


def _exchange_only(config) -> bool:
    from cgs_vmc_jax.sampler import metropolis as mp
    return mp.move_type(config) == 'exchange'


# ---------------------------------------------------------------------------
# Built-in fast paths (the round-2 dispatch order, see module docstring).

def _register_builtins() -> None:
    def pt_supports(wf, config):
        # Parallel tempering replaces the whole sweep discipline (replica
        # ladder + swap rounds), so the explicit knob outranks every
        # single-temperature path; it composes with either move type.
        n = getattr(config, 'pt_replicas', 0)
        return bool(n and n >= 2)

    def pt_make(wf, config):
        from cgs_vmc_jax.sampler import metropolis as mp
        from cgs_vmc_jax.sampler import tempering
        move = mp.move_type(config)

        def sweeps(params, state, num_sweeps):
            return tempering.run_sweeps(wf, params, state, num_sweeps,
                                        move=move)
        return sweeps

    register_fast_path('tempering', priority=150,
                       supports=pt_supports, make=pt_make)

    def mtm_supports(wf, config):
        if not _exchange_only(config):
            return False
        k = getattr(config, 'mtm_candidates', 0)
        return bool(k and k > 1)

    def mtm_make(wf, config):
        from cgs_vmc_jax.sampler import mtm
        k = config.mtm_candidates

        def sweeps(params, state, num_sweeps):
            return mtm.run_sweeps(wf, params, state, num_sweeps, k=k)
        return sweeps

    register_fast_path('mtm', priority=100,
                       supports=mtm_supports, make=mtm_make)

    def ar_supports(wf, config):
        # Exact ancestral sampling replaces Metropolis for autoregressive
        # ansatzes — but only within the move semantics it reproduces:
        # the AR conditionals are Sz=0-sector-projected, i.e. the
        # exchange-move state space.  A 'flip' (full 2^N space) config
        # must fall through to the generic sampler, and the
        # use_fast_sampler knob must be able to force the Metropolis
        # baseline (same contract as every other automatic entry).
        if not _exchange_only(config):
            return False
        if getattr(config, 'total_sz2', 0):
            # AR conditionals are Sz=0-sector-projected.
            return False
        if not getattr(config, 'use_fast_sampler', True):
            return False
        from cgs_vmc_jax.sampler import fast_ar
        return fast_ar.supports(wf)

    def ar_make(wf, config):
        from cgs_vmc_jax.sampler import fast_ar

        def sweeps(params, state, num_sweeps):
            return fast_ar.run_sweeps(wf, params, state, num_sweeps)
        return sweeps

    register_fast_path('exact_autoregressive', priority=95,
                       supports=ar_supports, make=ar_make)

    def mps_supports(wf, config):
        if not _exchange_only(config):
            return False
        if not getattr(config, 'mps_incremental_sweeps', False):
            return False
        from cgs_vmc_jax.sampler import fast_mps
        return fast_mps.supports(wf)

    def mps_make(wf, config):
        from cgs_vmc_jax.sampler import fast_mps

        def sweeps(params, state, num_sweeps):
            return fast_mps.run_sweeps(wf, params, state, num_sweeps)
        return sweeps

    register_fast_path('mps_env', priority=90,
                       supports=mps_supports, make=mps_make)

    def rbm_supports(wf, config):
        # The fused kernel is compiled for the GPU (Pallas-Triton); other
        # backends take the generic path.
        if not _exchange_only(config):
            return False
        if getattr(config, 'total_sz2', 0):
            # kernels.sample_picks ranks exactly n_sites//2 down spins.
            return False
        if not getattr(config, 'use_fast_sampler', True):
            return False
        if jax.default_backend() != 'gpu':
            return False
        from cgs_vmc_jax.sampler import fast_rbm
        return fast_rbm.supports(wf)

    def rbm_make(wf, config):
        from cgs_vmc_jax.sampler import fast_rbm

        def sweeps(params, state, num_sweeps):
            return fast_rbm.run_sweeps(wf, params, state, num_sweeps)
        return sweeps

    register_fast_path('rbm_pallas', priority=50,
                       supports=rbm_supports, make=rbm_make)

    def jastrow_supports(wf, config):
        # Exact O(n) delta for the quadratic form: pure XLA, every backend.
        if not _exchange_only(config):
            return False
        if not getattr(config, 'use_fast_sampler', True):
            return False
        from cgs_vmc_jax.sampler import fast_jastrow
        return fast_jastrow.supports(wf)

    def jastrow_make(wf, config):
        from cgs_vmc_jax.sampler import fast_jastrow

        def sweeps(params, state, num_sweeps):
            return fast_jastrow.run_sweeps(wf, params, state, num_sweeps)
        return sweeps

    register_fast_path('jastrow_delta', priority=45,
                       supports=jastrow_supports, make=jastrow_make)

    def pbdg_supports(wf, config):
        # Pure-XLA incremental path: beneficial on every backend.
        if not _exchange_only(config):
            return False
        if getattr(config, 'total_sz2', 0):
            # The pairing submatrix is n/2 x n/2 (half-filling; the
            # ProjectedBDG ansatz itself assumes the Sz=0 sector).
            return False
        if not getattr(config, 'use_fast_sampler', True):
            return False
        from cgs_vmc_jax.sampler import fast_pbdg
        return fast_pbdg.supports(wf)

    def pbdg_make(wf, config):
        from cgs_vmc_jax.sampler import fast_pbdg

        def sweeps(params, state, num_sweeps):
            return fast_pbdg.run_sweeps(wf, params, state, num_sweeps)
        return sweeps

    register_fast_path('pbdg_sherman_morrison', priority=40,
                       supports=pbdg_supports, make=pbdg_make)


_register_builtins()
