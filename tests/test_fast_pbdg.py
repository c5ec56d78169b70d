"""Sherman–Morrison incremental sampler for ProjectedBDG (fast_pbdg)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import basis
from cgs_vmc_jax.models.determinant import ProjectedBDG
from cgs_vmc_jax.sampler import fast_pbdg, metropolis

N = 8
CHAINS = 64


def _setup(seed=0, chains=CHAINS):
    wf = ProjectedBDG(N)
    params = wf.init(jax.random.key(seed))
    state = metropolis.init_sampler(jax.random.key(seed + 1), wf, params,
                                    N, chains)
    return wf, params, state


@pytest.mark.slow
def test_sherman_morrison_ratio_matches_full_recompute():
    """The rank-2 determinant-lemma ratio must equal |det M'|/|det M| from
    scratch for random exchange moves."""
    wf, params, state = _setup()
    pairing = params['pairing']
    configs = state.configs
    up, down, inv = fast_pbdg._build_cache(pairing, configs)
    half = N // 2
    rng = np.random.default_rng(3)

    def logabsdet(cfgs):
        return wf.apply(params, cfgs).log

    base = np.asarray(logabsdet(configs))
    for _ in range(10):
        r = jnp.asarray(rng.integers(0, half, CHAINS), jnp.int32)
        c = jnp.asarray(rng.integers(0, half, CHAINS), jnp.int32)
        chain = jnp.arange(CHAINS)
        i = up[chain, r]
        j = down[chain, c]
        flipped = configs.at[chain, i].set(-1.0).at[chain, j].set(1.0)
        expected = np.asarray(logabsdet(flipped)) - base

        # Reproduce the kernel's two rank-1 steps.
        new_row = jnp.take_along_axis(pairing[j], down, axis=1)
        inv_col_r = inv[chain, :, r]
        ratio1 = jnp.sum(new_row * inv_col_r, axis=-1)
        w = jnp.einsum('bk,bkm->bm', new_row, inv)
        w = w - (jnp.arange(half)[None] == r[:, None])
        inv1 = inv - inv_col_r[:, :, None] * (
            w / ratio1[:, None])[:, None, :]
        v = jnp.take_along_axis(pairing[:, i].T, up, axis=1)
        v = jnp.where(jnp.arange(half)[None] == r[:, None],
                      pairing[j, i][:, None], v)
        inv1_v = jnp.einsum('brc,bc->br', inv1, v)
        ratio2 = inv1_v[chain, c]
        ratio = np.asarray(ratio1 * ratio2)
        np.testing.assert_allclose(np.log(np.abs(ratio)), expected,
                                   rtol=2e-3, atol=2e-3)


def test_fast_pbdg_invariants():
    wf, params, state = _setup(seed=4)
    out = fast_pbdg.run_sweeps(wf, params, state, 5)
    arr = np.asarray(out.configs)
    assert set(np.unique(arr)) <= {-1.0, 1.0}
    np.testing.assert_array_equal(arr.sum(axis=1), np.zeros(CHAINS))
    # Amplitude cache written from the exact forward.
    amp = wf.apply(params, out.configs)
    np.testing.assert_allclose(np.asarray(out.log_amp), np.asarray(amp.log),
                               rtol=1e-6)
    acc = float(out.num_accepted.sum() / out.num_proposed.sum())
    assert 0.01 < acc <= 1.0


@pytest.mark.slow
def test_fast_pbdg_samples_born_distribution():
    """Incremental chains sample the SAME |ψ|² as the generic full-forward
    sampler (TV distance vs exact enumeration)."""
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

    run = jax.jit(lambda s: fast_pbdg.run_sweeps(wf, params, s, 2))
    counts = np.zeros(states.shape[0])
    for it in range(60):
        state = run(state)
        if it >= 12:
            idx = np.asarray(basis.lin_index(state.configs, top, bot))
            np.add.at(counts, enum_of_lin[idx], 1)
    empirical = counts / counts.sum()
    tv = 0.5 * np.abs(empirical - exact).sum()
    assert tv < 0.08, f'TV distance {tv} too large'


def test_dispatch_selects_fast_pbdg():
    from cgs_vmc_jax.config import Config
    from cgs_vmc_jax.optim import common
    wf, params, state = _setup(seed=9)
    cfg = Config(num_sites=N, wavefunction_type='pbdg')
    sweeps = common.make_sweeps_fn(wf, cfg)
    out = sweeps(params, state, 2)
    assert float(out.num_proposed.sum()) == CHAINS * 2 * N
    # And the knob turns it off.
    cfg_off = cfg.replace(use_fast_sampler=False)
    sweeps_off = common.make_sweeps_fn(wf, cfg_off)
    out2 = sweeps_off(params, state, 1)
    assert out2.configs.shape == state.configs.shape


@pytest.mark.slow
def test_pbdg_fast_path_trains_end_to_end():
    """EnergyGradient with the ProjectedBDG ansatz runs its epochs through
    the Sherman-Morrison sweeps (make_sweeps_fn dispatch) and descends."""
    import numpy as np
    from cgs_vmc_jax import lattice
    from cgs_vmc_jax.config import Config
    from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
    from cgs_vmc_jax.optim.energy_gradient import EnergyGradientOptimizer

    config = Config(num_sites=N, wavefunction_type='pbdg',
                    batch_size=128, num_batches_per_epoch=4,
                    num_equilibration_sweeps=4, num_monte_carlo_sweeps=1,
                    optimizer='adam', learning_rates=[0.02],
                    learning_rate_stops=[], heisenberg_jx=-1.0, seed=13)
    wf = ProjectedBDG(N)
    ham = HeisenbergHamiltonian(lattice.chain_bonds(N), -1.0, 1.0)
    opt = EnergyGradientOptimizer(wf, ham, config)
    state = opt.init_state(jax.random.key(13))
    epoch = jax.jit(opt.epoch)
    energies = []
    for _ in range(30):
        state, metrics = epoch(state)
        energies.append(float(metrics['energy']))
    assert np.isfinite(energies).all()
    assert np.mean(energies[-5:]) < np.mean(energies[:5]) - 0.3
    assert 0.01 < float(metrics['acceptance_rate']) <= 1.0


def test_fast_pbdg_advances_all_chain_keys():
    """Round-3 RNG contract: the fast path must advance EVERY chain's key
    (see metropolis.advance_chain_keys)."""
    wf, params, state = _setup(seed=3)
    before = np.asarray(jax.random.key_data(state.keys))
    out = fast_pbdg.run_sweeps(wf, params, state, 1)
    after = np.asarray(jax.random.key_data(out.keys))
    assert (before != after).any(axis=-1).all()
    assert len({tuple(k) for k in after.tolist()}) == after.shape[0]
