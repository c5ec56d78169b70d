"""Fast-path sampler registry: dispatch order, extensibility, and the
documented justification for FullyConnectedNNB having no incremental path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.optim import common
from cgs_vmc_jax.sampler import metropolis, registry


def _wf(wtype, **kw):
    config = Config(num_sites=8, wavefunction_type=wtype, **kw)
    return build_wavefunction(config), config


@pytest.fixture
def registry_snapshot():
    saved = registry.registered_fast_paths()
    yield
    registry._REGISTRY[:] = saved


def test_builtin_dispatch_order():
    # Pure RBM on CPU: the compiled kernel entry requires the GPU backend,
    # so the generic sampler wins (this suite runs on the virtual CPU mesh).
    wf, config = _wf('rbm', num_fc_layers=0, fc_layer_size=16)
    assert registry.resolved_name(wf, config) == 'generic'

    # Explicit MTM knob outranks everything.
    assert registry.resolved_name(
        wf, config.replace(mtm_candidates=4)) == 'mtm'

    # PBDG auto-dispatches to Sherman-Morrison on every backend...
    wf_det, config_det = _wf('pbdg')
    assert registry.resolved_name(
        wf_det, config_det) == 'pbdg_sherman_morrison'
    # ...unless fast sampling is disabled.
    assert registry.resolved_name(
        wf_det, config_det.replace(use_fast_sampler=False)) == 'generic'

    # MPS env sweeps are opt-in.
    wf_mps, config_mps = _wf('mps', bond_dimension=4)
    assert registry.resolved_name(wf_mps, config_mps) == 'generic'
    assert registry.resolved_name(
        wf_mps, config_mps.replace(mps_incremental_sweeps=True)) == 'mps_env'

    # NNB deliberately has no fast path (see registry module docstring
    # and test_nnb_matrix_delta_is_full_rank below).
    wf_nnb, config_nnb = _wf('fully_connected_nnb', num_fc_layers=1,
                             fc_layer_size=12)
    assert registry.resolved_name(wf_nnb, config_nnb) == 'generic'


@pytest.mark.parametrize('backend,expected', [('gpu', 'rbm_pallas'),
                                              ('cpu', 'generic')])
def test_rbm_kernel_entry_gated_to_gpu(monkeypatch, backend, expected):
    """The pure RBM resolves to the compiled kernel on the GPU backend
    only, and never with a feature MLP, a flip move, another Sz sector or
    use_fast_sampler=False."""
    monkeypatch.setattr(jax, 'default_backend', lambda: backend)
    wf, config = _wf('rbm', num_fc_layers=0, fc_layer_size=16)
    assert registry.resolved_name(wf, config) == expected
    for off in (dict(use_fast_sampler=False), dict(mc_move_type='flip'),
                dict(total_sz2=2)):
        assert registry.resolved_name(wf, config.replace(**off)) == 'generic'
    wf_mlp, config_mlp = _wf('rbm', num_fc_layers=1, fc_layer_size=16)
    assert registry.resolved_name(wf_mlp, config_mlp) == 'generic'


def test_third_party_registration(registry_snapshot):
    """A third-party ansatz registers a fast path WITHOUT editing
    framework code, and make_sweeps_fn picks it up."""
    calls = []

    def supports(wf, config):
        return getattr(wf, 'name', '') == 'fully_connected_network'

    def make(wf, config):
        def sweeps(params, state, num_sweeps):
            calls.append(num_sweeps)
            return metropolis.run_sweeps(wf, params, state, num_sweeps)
        return sweeps

    registry.register_fast_path('custom_fc', priority=60,
                                supports=supports, make=make)
    wf, config = _wf('fully_connected', num_fc_layers=1, fc_layer_size=12)
    assert registry.resolved_name(wf, config) == 'custom_fc'

    sweeps_fn = common.make_sweeps_fn(wf, config)
    params = wf.init(jax.random.key(0))
    state = metropolis.init_sampler(jax.random.key(1), wf, params, 8, 4)
    out = sweeps_fn(params, state, 2)
    assert calls == [2]
    assert out.configs.shape == state.configs.shape

    # Explicit knobs still outrank the new entry.
    assert registry.resolved_name(
        wf, config.replace(mtm_candidates=4)) == 'mtm'

    # Re-registering the same name replaces, not duplicates.
    registry.register_fast_path('custom_fc', priority=60,
                                supports=supports, make=make)
    names = [e.name for e in registry.registered_fast_paths()]
    assert names.count('custom_fc') == 1


def test_nnb_matrix_delta_is_full_rank():
    """Measured justification for skipping an NNB 'rank-1' fast path
    (round-2 review asked for one): under a single exchange move the
    backflow matrix M(R) — emitted by an MLP of the FULL configuration —
    changes in every entry and the delta has (numerically) full rank, so
    no Sherman-Morrison/Woodbury update of det M exists.  Contrast
    ProjectedBDG, whose pairing matrix is configuration-independent and
    where a move only swaps the row/column selection (true rank<=2)."""
    n = 8
    config = Config(num_sites=n, wavefunction_type='fully_connected_nnb',
                    num_fc_layers=2, fc_layer_size=16, nonlinearity='tanh')
    wf = build_wavefunction(config)
    params = wf.init(jax.random.key(0))

    from cgs_vmc_jax.models import nn
    from cgs_vmc_jax.ops.logamp import ACTIVATIONS

    def emit(configs):
        act = ACTIVATIONS[config.nonlinearity]
        h = configs
        for i in range(config.num_fc_layers):
            h = act(nn.linear_apply(params[f'dense_{i}'], h))
        pairing = nn.linear_apply(params['pairing_head'], h)
        return pairing.reshape(-1, n, n)

    base = jnp.asarray([[1., -1., 1., -1., 1., -1., 1., -1.]])
    moved = base.at[0, 0].set(-1.).at[0, 1].set(1.)  # one exchange move
    delta = np.asarray(emit(moved) - emit(base))[0]

    frac_changed = (np.abs(delta) > 1e-9).mean()
    assert frac_changed > 0.99, frac_changed
    s = np.linalg.svd(delta, compute_uv=False)
    numerical_rank = int((s > s[0] * 1e-5).sum())
    assert numerical_rank >= n - 1, (
        f'delta rank {numerical_rank}: a low-rank det update would be '
        'possible after all — revisit the registry justification')
