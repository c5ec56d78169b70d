"""Tests for the fused RBM sweep kernel (Pallas interpreter on CPU), its
plain-XLA twin, and the wrapper's padding and tiling of chains."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import basis, gpu_checks
from cgs_vmc_jax.sampler import kernels

N = 8
H = 16
CHAINS = 32

INTERPRETED = functools.partial(kernels.rbm_sweeps, interpret=True)
IMPLS = {'kernel': INTERPRETED, 'xla': kernels.rbm_sweeps_xla}


def _rbm_params(key, scale=0.3, n=N, h=H):
    k1, k2, k3 = jax.random.split(key, 3)
    w = scale * jax.random.normal(k1, (n, h), jnp.float32)
    b = scale * jax.random.normal(k2, (h,), jnp.float32)
    a = scale * jax.random.normal(k3, (n,), jnp.float32)
    return w, b, a


def _log_psi(w, b, a, configs):
    theta = configs @ w + b
    ax = jnp.abs(theta)
    log_cosh = ax + jnp.log1p(jnp.exp(-2 * ax)) - jnp.log(2.0)
    return configs @ a + jnp.sum(log_cosh, axis=-1)


def _run(w, b, a, configs, picks, key):
    return INTERPRETED(w, b, a, configs, picks, key)


def _assert_matches_reference(out, ref):
    np.testing.assert_array_equal(np.asarray(out.configs),
                                  np.asarray(ref.configs))
    np.testing.assert_array_equal(np.asarray(out.num_accepted),
                                  np.asarray(ref.num_accepted))
    np.testing.assert_allclose(np.asarray(out.log_amp),
                               np.asarray(ref.log_amp), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize('impl', sorted(IMPLS))
def test_kernel_matches_reference_exactly(impl):
    """Same picks + same uniforms => identical trajectories (the
    incremental updates vs the oracle's full recomputation)."""
    w, b, a = _rbm_params(jax.random.key(0))
    configs = basis.random_configurations(jax.random.key(1), N, CHAINS)
    picks = kernels.sample_picks(jax.random.key(2), 64, N, CHAINS)
    key = jax.random.key(3)

    out = IMPLS[impl](w, b, a, configs, picks, key)
    ref = kernels.rbm_sweeps_reference(w, b, a, configs, picks, key)
    _assert_matches_reference(out, ref)
    assert float(ref.num_accepted.sum()) > 0


def test_theta_and_logamp_caches_consistent():
    """Returned θ/logψ caches must equal a full recomputation."""
    w, b, a = _rbm_params(jax.random.key(4))
    configs = basis.random_configurations(jax.random.key(5), N, CHAINS)
    picks = kernels.sample_picks(jax.random.key(6), 64, N, CHAINS)
    out = _run(w, b, a, configs, picks, jax.random.key(7))

    np.testing.assert_allclose(
        np.asarray(out.theta), np.asarray(out.configs @ w + b),
        rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(out.log_amp),
        np.asarray(_log_psi(w, b, a, out.configs)),
        rtol=1e-4, atol=1e-4)


def test_moves_conserve_sz():
    w, b, a = _rbm_params(jax.random.key(8))
    configs = basis.random_configurations(jax.random.key(9), N, CHAINS)
    picks = kernels.sample_picks(jax.random.key(10), 100, N, CHAINS)
    out = _run(w, b, a, configs, picks, jax.random.key(11))
    arr = np.asarray(out.configs)
    assert set(np.unique(arr)) <= {-1.0, 1.0}
    np.testing.assert_array_equal(arr.sum(axis=1), np.zeros(CHAINS))


def test_always_reject():
    """A deeply peaked wavefunction rejects every move away from the
    current configs: state must be unchanged."""
    w = jnp.zeros((N, H))
    b = jnp.zeros((H,))
    configs = basis.random_configurations(jax.random.key(12), N, CHAINS)
    a = 50.0 * configs[0]
    same = jnp.tile(configs[0][None, :], (CHAINS, 1))
    picks = kernels.sample_picks(jax.random.key(13), 50, N, CHAINS)
    out = _run(w, b, a, same, picks, jax.random.key(14))
    np.testing.assert_array_equal(np.asarray(out.configs), np.asarray(same))
    assert float(out.num_accepted.sum()) == 0.0


def test_picks_are_per_chain_independent():
    """Shared pairs would couple chains through common random numbers.
    The rank picks must differ ACROSS chains within a step, and two
    chains started from the same config with the same wavefunction must
    follow different trajectories."""
    picks = np.asarray(kernels.sample_picks(jax.random.key(20), 40, N, 64))
    # At least one step where not all chains share the same pick.
    per_step_unique = [len(np.unique(picks[t, :, 0])) for t in range(40)]
    assert max(per_step_unique) > 1

    w, b, a = _rbm_params(jax.random.key(21), scale=0.1)
    start = basis.random_configurations(jax.random.key(22), N, 1)
    same = jnp.tile(start, (CHAINS, 1))
    picks = kernels.sample_picks(jax.random.key(23), 4 * N, N, CHAINS)
    out = _run(w, b, a, same, picks, jax.random.key(24))
    arr = np.asarray(out.configs)
    assert np.unique(arr, axis=0).shape[0] > 1


@pytest.mark.parametrize('n_chains,block', [(13, 4), (5, 8), (6, 1)])
def test_wrapper_pads_sites_hidden_and_partial_blocks(n_chains, block):
    """10 sites and 12 hidden units pad to 16 (Triton blocks are powers
    of two); chains that do not fill the last block pad with spin-free
    rows that never move.  Results must still match the oracle."""
    n_sites, hidden = 10, 12
    w, b, a = _rbm_params(jax.random.key(30), n=n_sites, h=hidden)
    configs = basis.random_configurations(jax.random.key(31), n_sites,
                                          n_chains)
    picks = kernels.sample_picks(jax.random.key(32), 3 * n_sites, n_sites,
                                 n_chains)
    key = jax.random.key(33)
    out = kernels._rbm_sweeps_pallas(w, b, a, configs, picks, key,
                                     block_chains=block, interpret=True)
    assert out.configs.shape == (n_chains, n_sites)
    assert out.theta.shape == (n_chains, hidden)
    assert out.num_accepted.shape == (n_chains,)
    ref = kernels.rbm_sweeps_reference(w, b, a, configs, picks, key)
    _assert_matches_reference(out, ref)


def test_block_size_does_not_change_trajectories():
    """Chains share nothing, so how they are tiled over programs must not
    change a single bit of the result."""
    w, b, a = _rbm_params(jax.random.key(50))
    configs = basis.random_configurations(jax.random.key(51), N, 16)
    picks = kernels.sample_picks(jax.random.key(52), 48, N, 16)
    key = jax.random.key(53)
    runs = [kernels._rbm_sweeps_pallas(w, b, a, configs, picks, key,
                                       block_chains=block, interpret=True)
            for block in (1, 4, 16)]
    for out in runs[1:]:
        np.testing.assert_array_equal(np.asarray(out.configs),
                                      np.asarray(runs[0].configs))
        np.testing.assert_array_equal(np.asarray(out.num_accepted),
                                      np.asarray(runs[0].num_accepted))


def test_off_sector_ranks_are_no_ops():
    """A rank beyond a chain's spin counts (a chain from another Sz
    sector) must leave that chain untouched, not flip a single spin."""
    w, b, a = _rbm_params(jax.random.key(60))
    configs = jnp.ones((4, N)).at[:, 0].set(-1.0)     # one down spin
    picks = jnp.stack([jnp.ones((20, 4), jnp.int32),   # 2nd down: absent
                       jnp.zeros((20, 4), jnp.int32)], axis=-1)
    for impl in IMPLS.values():
        out = impl(w, b, a, configs, picks, jax.random.key(61))
        np.testing.assert_array_equal(np.asarray(out.configs),
                                      np.asarray(configs))
        assert float(out.num_accepted.sum()) == 0.0


@pytest.mark.gpu
@pytest.mark.parametrize('impl', ['kernel', 'xla'])
def test_compiled_kernel_matches_reference_at_bench_width(gpu, impl):
    """The compiled GPU kernel (and plain XLA) at 36 sites, H=64, 2048
    chains, bitwise against the oracle (chip_smoke.py phase 3a)."""
    fn = {'kernel': kernels.rbm_sweeps, 'xla': kernels.rbm_sweeps_xla}[impl]
    gpu_checks.rbm_kernel_parity(fn)


@pytest.mark.slow
def test_cross_chain_batch_mean_variance():
    """Independence oracle: the variance of the cross-chain batch mean of
    an observable must match the independent-chain prediction
    var(mean) ≈ var(single chain) / n_chains (within MC error).  Under a
    shared-pair schedule chains would be positively correlated and this
    ratio would inflate."""
    w, b, a = _rbm_params(jax.random.key(30), scale=0.15)
    chains = 512
    configs = basis.random_configurations(jax.random.key(31), N, chains)
    # Equilibrate.
    picks = kernels.sample_picks(jax.random.key(32), 20 * N, N, chains)
    configs = _run(w, b, a, configs, picks, jax.random.key(33)).configs
    # Collect batch means of a spin-pair observable over repeated blocks.
    batch_means = []
    values = []
    for it in range(30):
        picks = kernels.sample_picks(jax.random.key(40 + 2 * it), 2 * N, N,
                                     chains)
        out = _run(w, b, a, configs, picks, jax.random.key(41 + 2 * it))
        configs = out.configs
        obs = np.asarray(configs[:, 0] * configs[:, 1])   # per-chain ±1
        batch_means.append(obs.mean())
        values.append(obs)
    values = np.concatenate(values)
    var_single = values.var()
    var_mean = np.var(batch_means, ddof=1)
    # Independent chains: var_mean ≈ var_single / chains (decorrelated
    # blocks).  Allow generous slack for autocorrelation noise, but a
    # shared-schedule coupling inflates this by O(chains), not O(1).
    assert var_mean < 6.0 * var_single / chains, (
        f'batch-mean variance {var_mean:.3e} vs independent prediction '
        f'{var_single / chains:.3e} — chains look correlated')


@pytest.mark.slow
def test_kernel_samples_born_distribution():
    """Kernel chains sample |ψ|² of the RBM (TV distance vs exact)."""
    w, b, a = _rbm_params(jax.random.key(15), scale=0.15)
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    log_psi = _log_psi(w, b, a, states)
    exact = np.exp(2 * np.asarray(log_psi - log_psi.max(), np.float64))
    exact /= exact.sum()

    chains = 256
    configs = basis.random_configurations(jax.random.key(16), N, chains)
    top, bot = basis.make_lin_tables(N)
    top, bot = jnp.asarray(top), jnp.asarray(bot)
    lin_of_enum = np.asarray(basis.lin_index(states, top, bot))
    enum_of_lin = np.empty_like(lin_of_enum)
    enum_of_lin[lin_of_enum] = np.arange(len(lin_of_enum))

    counts = np.zeros(states.shape[0])
    for it in range(50):
        picks = kernels.sample_picks(jax.random.key(2 * it), 2 * N, N,
                                     chains)
        out = _run(w, b, a, configs, picks, jax.random.key(2 * it + 1))
        configs = out.configs
        if it >= 10:  # discard equilibration
            idx = np.asarray(basis.lin_index(configs, top, bot))
            np.add.at(counts, enum_of_lin[idx], 1)
    empirical = counts / counts.sum()
    tv = 0.5 * np.abs(empirical - exact).sum()
    assert tv < 0.08, f'TV distance {tv} too large'
