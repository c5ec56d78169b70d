"""Environment-cached adjacent-exchange MPS sampler (fast_mps)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import basis
from cgs_vmc_jax.models.mps import MatrixProductState
from cgs_vmc_jax.sampler import fast_mps, metropolis

N = 8
D = 4
CHAINS = 32


def _setup(seed=0, chains=CHAINS):
    wf = MatrixProductState(N, D)
    params = wf.init(jax.random.key(seed))
    state = metropolis.init_sampler(jax.random.key(seed + 1), wf, params,
                                    N, chains)
    return wf, params, state


def _reference_sweeps(wf, params, configs, u_all):
    """Sequential oracle: the SAME ordered adjacent-exchange schedule and
    acceptance rule, but every amplitude from the full wf.apply forward —
    consuming the same uniforms, so trajectories must match the
    environment-cached implementation exactly."""
    configs = np.asarray(configs).copy()
    n_chains, n = configs.shape

    def amp2(cfgs):
        a = wf.apply(params, jnp.asarray(cfgs))
        return np.exp(2 * np.asarray(a.log, np.float64))

    for sweep in range(u_all.shape[0]):
        for k in range(n - 1):
            u = np.asarray(u_all[sweep, k], np.float64)
            swapped = configs.copy()
            swapped[:, [k, k + 1]] = swapped[:, [k + 1, k]]
            cur2 = amp2(configs)
            new2 = amp2(swapped)
            active = configs[:, k] != configs[:, k + 1]
            accept = active & (new2 > u * cur2)
            configs[accept] = swapped[accept]
    return configs


@pytest.mark.slow
def test_matches_full_forward_oracle():
    """Same uniforms => identical trajectories (cached environments vs
    full recomputation)."""
    wf, params, state = _setup(seed=2)
    num_sweeps = 3
    key0 = state.keys[0]
    k_u, _ = jax.random.split(key0)
    u_all = jax.random.uniform(k_u, (num_sweeps, N - 1, CHAINS),
                               jnp.float32)

    out = fast_mps.run_sweeps(wf, params, state, num_sweeps)
    expected = _reference_sweeps(wf, params, state.configs, u_all)
    np.testing.assert_array_equal(np.asarray(out.configs), expected)


def test_invariants_and_cache_refresh():
    wf, params, state = _setup(seed=5)
    out = fast_mps.run_sweeps(wf, params, state, 4)
    arr = np.asarray(out.configs)
    assert set(np.unique(arr)) <= {-1.0, 1.0}
    np.testing.assert_array_equal(arr.sum(axis=1), np.zeros(CHAINS))
    amp = wf.apply(params, out.configs)
    np.testing.assert_allclose(np.asarray(out.log_amp),
                               np.asarray(amp.log), rtol=1e-6)
    # Active proposals only (round-2 advisor): parallel-spin bonds are
    # no-ops and are NOT counted, so acceptance rates are comparable
    # with the always-active generic/fast_rbm samplers.
    total_bonds = CHAINS * 4 * (N - 1)
    assert 0 < float(out.num_proposed.sum()) < total_bonds
    assert float(out.num_accepted.sum()) <= float(out.num_proposed.sum())


@pytest.mark.slow
def test_fast_mps_samples_born_distribution():
    """Ordered adjacent-exchange sweeps preserve |ψ|² (TV vs exact)."""
    wf, params, _ = _setup(seed=7)
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    amp = wf.apply(params, states)
    log = np.asarray(amp.log, np.float64)
    exact = np.exp(2 * (log - log.max()))
    exact /= exact.sum()

    chains = 256
    state = metropolis.init_sampler(jax.random.key(11), wf, params, N,
                                    chains)
    top, bot = basis.make_lin_tables(N)
    top, bot = jnp.asarray(top), jnp.asarray(bot)
    all_lin = np.asarray(basis.lin_index(states, top, bot))
    enum_of_lin = np.empty_like(all_lin)
    enum_of_lin[all_lin] = np.arange(len(all_lin))

    run = jax.jit(lambda s: fast_mps.run_sweeps(wf, params, s, 3))
    counts = np.zeros(states.shape[0])
    for it in range(60):
        state = run(state)
        if it >= 12:
            idx = np.asarray(basis.lin_index(state.configs, top, bot))
            np.add.at(counts, enum_of_lin[idx], 1)
    empirical = counts / counts.sum()
    tv = 0.5 * np.abs(empirical - exact).sum()
    assert tv < 0.08, f'TV distance {tv} too large'


def test_dispatch_opt_in():
    from cgs_vmc_jax.config import Config
    from cgs_vmc_jax.optim import common
    wf, params, state = _setup(seed=9)
    cfg = Config(num_sites=N, wavefunction_type='mps', bond_dimension=D,
                 mps_incremental_sweeps=True)
    sweeps = common.make_sweeps_fn(wf, cfg)
    out = sweeps(params, state, 2)
    assert 0 < float(out.num_proposed.sum()) <= CHAINS * 2 * (N - 1)
    # Default (opt-in off) uses the generic sampler: N proposals/sweep.
    sweeps_off = common.make_sweeps_fn(wf, cfg.replace(
        mps_incremental_sweeps=False))
    out2 = sweeps_off(params, state, 2)
    assert float(out2.num_proposed.sum()) == CHAINS * 2 * N


def test_fast_mps_advances_all_chain_keys():
    """Round-3 RNG contract: the fast path must advance EVERY chain's key
    (see metropolis.advance_chain_keys)."""
    wf, params, state = _setup(seed=3)
    before = np.asarray(jax.random.key_data(state.keys))
    out = fast_mps.run_sweeps(wf, params, state, 1)
    after = np.asarray(jax.random.key_data(out.keys))
    assert (before != after).any(axis=-1).all()
    assert len({tuple(k) for k in after.tolist()}) == after.shape[0]
