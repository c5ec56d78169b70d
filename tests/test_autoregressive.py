"""Autoregressive (MADE) ansatz: exact normalization, exact sampling,
autoregressive masking, registry dispatch, and MCMC-free training.

The normalization oracle is the whole point: sum over the full Sz=0
sector of |psi|^2 must be EXACTLY one (up to f32 rounding) — no other
ansatz in the framework has this property.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import basis, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.models.autoregressive import AutoregressiveSpinModel
from cgs_vmc_jax.sampler import fast_ar, metropolis, registry

N = 8


def _setup(seed=0, n=N, hidden=16, layers=1):
    wf = AutoregressiveSpinModel(n, hidden=hidden, num_hidden_layers=layers)
    params = wf.init(jax.random.key(seed))
    # Non-trivial weights (init is near-flat).
    params = jax.tree.map(
        lambda p: p + 0.4 * jax.random.normal(
            jax.random.key(hash(p.shape) % 1000), p.shape), params)
    return wf, params


def test_normalized_on_sector():
    """sum_{s in Sz=0} |psi(s)|^2 == 1 exactly."""
    for layers in (1, 2):
        wf, params = _setup(seed=1, layers=layers)
        states = jnp.asarray(basis.enumerate_sz_basis(N))
        log = np.asarray(wf.apply(params, states).log, np.float64)
        total = np.exp(2 * log).sum()
        np.testing.assert_allclose(total, 1.0, rtol=1e-5)


def test_autoregressive_masking():
    """logit_i must not depend on s_j for j >= i."""
    wf, params = _setup(seed=2, layers=2)
    s = jnp.asarray(basis.random_configurations(jax.random.key(3), N, 4))
    base = np.asarray(wf._logits(params, s))
    for i in range(N):
        flipped = s.at[:, i].multiply(-1.0)
        out = np.asarray(wf._logits(params, flipped))
        # logits at sites <= i unchanged (site i's logit excludes s_i).
        np.testing.assert_allclose(out[:, :i + 1], base[:, :i + 1],
                                   atol=1e-6)


def test_sample_log_prob_consistency():
    """Sampled configs are in-sector and apply() equals the ancestral
    chain rule (already implied by construction; checked numerically by
    re-deriving log p from the conditionals)."""
    wf, params = _setup(seed=4)
    keys = jax.random.split(jax.random.key(5), 64)
    configs = wf.sample(params, keys)
    assert set(np.unique(np.asarray(configs))) <= {-1.0, 1.0}
    np.testing.assert_array_equal(np.asarray(configs.sum(-1)),
                                  np.zeros(64))
    log_p = np.asarray(
        wf._conditional_log_p(params, configs).sum(-1), np.float64)
    log_amp = np.asarray(wf.apply(params, configs).log, np.float64)
    np.testing.assert_allclose(log_amp, 0.5 * log_p, rtol=1e-6)


def test_sampling_matches_born_distribution():
    """i.i.d. ancestral draws reproduce |psi|^2 over the enumerated
    sector (tight TV bound — there is no autocorrelation)."""
    wf, params = _setup(seed=6)
    states = jnp.asarray(basis.enumerate_sz_basis(N))
    log = np.asarray(wf.apply(params, states).log, np.float64)
    exact = np.exp(2 * log)   # already normalized

    top, bot = basis.make_lin_tables(N)
    all_lin = np.asarray(basis.lin_index(states, top, bot))
    enum_of_lin = np.empty_like(all_lin)
    enum_of_lin[all_lin] = np.arange(len(all_lin))

    draws = 20000
    keys = jax.random.split(jax.random.key(7), draws)
    configs = wf.sample(params, keys)
    idx = np.asarray(basis.lin_index(configs, top, bot))
    counts = np.zeros(states.shape[0])
    np.add.at(counts, enum_of_lin[idx], 1)
    empirical = counts / draws
    tv = 0.5 * np.abs(empirical - exact).sum()
    assert tv < 0.03, f'TV distance {tv} too large for i.i.d. draws'


def test_dispatch_and_sweeps_adapter():
    wf, params = _setup(seed=8)
    cfg = Config(num_sites=N, wavefunction_type='made')
    assert registry.resolved_name(wf, cfg) == 'exact_autoregressive'
    state = metropolis.init_sampler(jax.random.key(9), wf, params, N, 32)
    out = fast_ar.run_sweeps(wf, params, state, 5)
    # Fresh draws with exact amplitudes and acceptance 1.0.
    np.testing.assert_allclose(
        np.asarray(out.log_amp),
        np.asarray(wf.apply(params, out.configs).log), rtol=1e-6)
    assert float(metropolis.acceptance_rate(out)) == 1.0
    # Keys advanced.
    assert not np.any(np.asarray(jax.random.key_data(out.keys))
                      == np.asarray(jax.random.key_data(state.keys)))


@pytest.mark.slow
def test_made_trains_mcmc_free():
    """SR on the Marshall-gauged N=8 chain with exact sampling: every
    epoch's samples are i.i.d. from |psi|^2; energy descends to within
    a few % of ED."""
    from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
    from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
    from cgs_vmc_jax.utils import ed

    cfg = Config(num_sites=N, wavefunction_type='made',
                 num_fc_layers=1, fc_layer_size=32,
                 wavefunction_optimizer_type='SR',
                 batch_size=256, num_batches_per_epoch=1,
                 num_equilibration_sweeps=1, num_monte_carlo_sweeps=1,
                 learning_rates=[0.1, 0.05, 0.02],
                 learning_rate_stops=[80, 140],
                 optimizer='gradient', heisenberg_jx=-1.0,
                 sr_diag_shift=1e-3, sr_solver='dense',
                 sr_delta_clip=1.0, seed=1)
    wf = build_wavefunction(cfg)
    ham = HeisenbergHamiltonian(lattice.chain_bonds(N), -1.0, 1.0)
    opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
    state = opt.init_state(jax.random.key(cfg.seed))
    epoch = jax.jit(opt.epoch)
    energies = []
    for _ in range(200):
        state, metrics = epoch(state)
        energies.append(float(metrics['energy']))
    e0, _ = ed.ground_state(N, lattice.chain_bonds(N), -1.0, 1.0)
    late = np.mean(energies[-10:])
    rel = abs(late - e0) / abs(e0)
    # Measured 2e-4 at these settings; generous headroom.
    assert rel < 0.01, f'MADE SR stalled at rel err {rel}'
    assert float(metrics['acceptance_rate']) == 1.0


@pytest.mark.slow
def test_complex_made_modulus_exact_sampling_frustrated():
    """MCMC-free FRUSTRATED VMC: complex(made modulus x fc phase) draws
    exactly from |psi|^2 = exp(2 log_modulus) (phase never enters the
    sampler); the complex energy-gradient path with adam descends to the
    Majumdar-Ghosh energy on the J1-J2 chain at j2=0.5 (E0 = -3N/8).
    (adam is the robust optimizer for this composite: measured rel err
    6-8e-4 across seeds at 400 epochs, where minSR sits on a chaotic
    mode-collapse boundary for the normalized AR modulus.)"""
    from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
    from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS

    n = 8
    cfg = Config(
        num_sites=n, wavefunction_type='complex',
        composite_wavefunction_types=('made', 'fully_connected'),
        num_fc_layers=1, fc_layer_size=32,
        heisenberg_j2=0.5,
        batch_size=256, num_batches_per_epoch=4,
        num_equilibration_sweeps=1, num_monte_carlo_sweeps=1,
        optimizer='adam', learning_rates=[0.01], learning_rate_stops=[],
        seed=7)
    wf = build_wavefunction(cfg)
    assert registry.resolved_name(wf, cfg) == 'exact_autoregressive'

    bonds, mask = lattice.j1j2_chain_bonds(n)
    couplings = (1.0 - mask) + 0.5 * mask
    ham = HeisenbergHamiltonian(bonds, couplings=couplings)
    opt = GROUND_STATE_OPTIMIZERS['EnergyGradient'](wf, ham, cfg)
    state = opt.init_state(jax.random.key(cfg.seed))
    epoch = jax.jit(lambda s: opt.epoch(s))
    energies = []
    for _ in range(400):
        state, metrics = epoch(state)
        energies.append(float(metrics['energy']))
    e0 = -3.0 * n / 8.0
    final = np.mean(energies[-10:])
    assert abs(final - e0) / abs(e0) < 0.02, f'E={final} vs {e0}'
    assert float(metrics['acceptance_rate']) == 1.0


def test_ar_dispatch_respects_knobs():
    """use_fast_sampler=False and non-exchange moves fall through to the
    generic sampler (the AR conditionals are Sz-sector-projected, so a
    full-space 'flip' config must not be silently replaced)."""
    wf, params = _setup(seed=12)
    base = Config(num_sites=N, wavefunction_type='made')
    assert registry.resolved_name(wf, base) == 'exact_autoregressive'
    assert registry.resolved_name(
        wf, base.replace(use_fast_sampler=False)) == 'generic'
    assert registry.resolved_name(
        wf, base.replace(mc_move_type='flip')) == 'generic'


def test_ar_zero_sweeps_still_redraws():
    """sweeps(..., 0) must NOT be a no-op for the exact sampler: epoch
    loops call it between batch collections, and an unchanged state would
    silently duplicate batches."""
    wf, params = _setup(seed=13)
    state = metropolis.init_sampler(jax.random.key(14), wf, params, N, 16)
    out = fast_ar.run_sweeps(wf, params, state, 0)
    assert not np.array_equal(np.asarray(out.configs),
                              np.asarray(state.configs))


# ---------------------------------------------------------------------------
# PixelCNN (2-D masked-conv autoregressive, models/pixelcnn.py): same
# exactness oracles as MADE — normalization + causality are inherited
# properties but the masks are new code.

def _setup_pixelcnn(seed=0, sx=4, sy=2, layers=2, filters=6):
    from cgs_vmc_jax.models.pixelcnn import MaskedConv2DAutoregressive
    wf = MaskedConv2DAutoregressive(sx, sy, num_layers=layers,
                                    num_filters=filters, kernel_size=3)
    params = wf.init(jax.random.key(seed))
    params = jax.tree.map(
        lambda p: p + 0.3 * jax.random.normal(
            jax.random.key(hash(p.shape) % 997), p.shape), params)
    return wf, params


def test_pixelcnn_normalized_on_sector():
    wf, params = _setup_pixelcnn(seed=1)
    states = jnp.asarray(basis.enumerate_sz_basis(8))
    log = np.asarray(wf.apply(params, states).log, np.float64)
    np.testing.assert_allclose(np.exp(2 * log).sum(), 1.0, rtol=1e-5)


def test_pixelcnn_raster_causality():
    """logit_i must not depend on s_j for j >= i in raster order
    (site = x*size_y + y) — the mask-A/mask-B construction."""
    wf, params = _setup_pixelcnn(seed=2, sx=4, sy=4, layers=3)
    n = 16
    s = jnp.asarray(basis.random_configurations(jax.random.key(3), n, 4))
    base = np.asarray(wf._logits(params, s))
    for j in range(n):
        flipped = s.at[:, j].multiply(-1.0)
        out = np.asarray(wf._logits(params, flipped))
        np.testing.assert_allclose(out[:, :j + 1], base[:, :j + 1],
                                   atol=1e-6)


def test_pixelcnn_sampling_and_dispatch():
    wf, params = _setup_pixelcnn(seed=4)
    cfg = Config(num_sites=8, size_x=4, size_y=2,
                 wavefunction_type='pixelcnn', num_conv_layers=2,
                 num_conv_filters=6, kernel_size=3)
    assert registry.resolved_name(wf, cfg) == 'exact_autoregressive'
    keys = jax.random.split(jax.random.key(5), 256)
    configs = wf.sample(params, keys)
    np.testing.assert_array_equal(np.asarray(configs.sum(-1)),
                                  np.zeros(256))
    # Draws match |psi|^2 over the enumerated sector.
    states = jnp.asarray(basis.enumerate_sz_basis(8))
    log = np.asarray(wf.apply(params, states).log, np.float64)
    exact = np.exp(2 * log)
    top, bot = basis.make_lin_tables(8)
    all_lin = np.asarray(basis.lin_index(states, top, bot))
    enum_of_lin = np.empty_like(all_lin)
    enum_of_lin[all_lin] = np.arange(len(all_lin))
    draws = 8000
    keys = jax.random.split(jax.random.key(6), draws)
    idx = np.asarray(basis.lin_index(wf.sample(params, keys), top, bot))
    counts = np.zeros(states.shape[0])
    np.add.at(counts, enum_of_lin[idx], 1)
    tv = 0.5 * np.abs(counts / draws - exact).sum()
    assert tv < 0.05, f'TV distance {tv}'


@pytest.mark.slow
def test_pixelcnn_trains_on_4x4():
    """MCMC-free SR on the Marshall-gauged 4x4 square lattice."""
    from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
    from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
    from cgs_vmc_jax.utils import ed

    cfg = Config(num_sites=16, size_x=4, size_y=4,
                 wavefunction_type='pixelcnn', num_conv_layers=3,
                 num_conv_filters=12, kernel_size=3,
                 wavefunction_optimizer_type='SR',
                 batch_size=256, num_batches_per_epoch=1,
                 num_equilibration_sweeps=1, num_monte_carlo_sweeps=1,
                 learning_rates=[0.1, 0.05, 0.02],
                 learning_rate_stops=[80, 140],
                 optimizer='gradient', heisenberg_jx=-1.0,
                 sr_diag_shift=1e-3, sr_solver='dense',
                 sr_delta_clip=1.0, seed=1)
    wf = build_wavefunction(cfg)
    ham = HeisenbergHamiltonian(lattice.square_lattice_bonds(4, 4),
                                -1.0, 1.0)
    opt = GROUND_STATE_OPTIMIZERS['SR'](wf, ham, cfg)
    state = opt.init_state(jax.random.key(cfg.seed))
    epoch = jax.jit(opt.epoch)
    energies = []
    for _ in range(200):
        state, metrics = epoch(state)
        energies.append(float(metrics['energy']))
    e0, _ = ed.ground_state(16, lattice.square_lattice_bonds(4, 4),
                            -1.0, 1.0)
    late = np.mean(energies[-10:])
    rel = abs(late - e0) / abs(e0)
    # Measured 0.038 at 200 epochs (modest net, blind-spot context);
    # the bound guards learning, not a variational floor.
    assert rel < 0.06, f'pixelcnn SR stalled at rel err {rel}'


def test_incremental_sampler_matches_generic():
    """The O(hidden)-per-site incremental path (1 hidden layer) must draw
    the SAME configurations as the full-forward generic path for the same
    keys — the conditionals are algebraically identical."""
    wf, params = _setup(seed=15, hidden=32, layers=1)
    keys = jax.random.split(jax.random.key(16), 512)
    inc = np.asarray(wf._sample_incremental(params, keys))
    gen = np.asarray(wf._sample_generic(params, keys))
    agree = np.mean(np.all(inc == gen, axis=-1))
    # f32 reassociation can flip a knife-edge Bernoulli draw on rare
    # chains; demand near-total agreement.
    assert agree > 0.99, f'incremental/generic agreement {agree}'
    assert wf.sample(params, keys).shape == (512, N)
