"""Config round-trips, overrides, and full-state checkpointing."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import lattice
from cgs_vmc_jax.config import Config, parse_overrides
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import EnergyGradientOptimizer
from cgs_vmc_jax.utils import checkpoint as ckpt_lib


def test_config_json_roundtrip(tmp_path):
    config = Config(num_sites=12, wavefunction_type='conv_1d',
                    learning_rates=[1e-2, 1e-3],
                    composite_wavefunction_types=('rbm', 'mps'))
    path = str(tmp_path / 'config.json')
    config.save(path)
    loaded = Config.load(path)
    assert loaded == config
    assert isinstance(loaded.composite_wavefunction_types, tuple)


def test_parse_overrides_types():
    config = Config()
    out = parse_overrides(
        config,
        'num_sites=16,heisenberg_jx=-1.0,wavefunction_type=rbm,'
        'learning_rates=[0.01;0.001],learning_rate_stops=[100]')
    assert out == {
        'num_sites': 16, 'heisenberg_jx': -1.0,
        'wavefunction_type': 'rbm',
        'learning_rates': [0.01, 0.001], 'learning_rate_stops': [100],
    }
    new = config.parse('num_sites=16')
    assert new.num_sites == 16 and config.num_sites == 40


def test_parse_overrides_unknown_field():
    with pytest.raises(ValueError, match='Unknown config field'):
        Config().parse('nope=1')


def _make_state(seed=0):
    config = Config(num_sites=8, wavefunction_type='rbm', num_fc_layers=1,
                    fc_layer_size=8, batch_size=16, num_batches_per_epoch=2,
                    num_equilibration_sweeps=1, heisenberg_jx=-1.0)
    wf = build_wavefunction(config)
    ham = HeisenbergHamiltonian(lattice.chain_bonds(8), -1.0, 1.0)
    opt = EnergyGradientOptimizer(wf, ham, config)
    return config, wf, opt, opt.init_state(jax.random.key(seed))


def test_checkpoint_roundtrip_full_state(tmp_path):
    directory = str(tmp_path)
    _, _, opt, state = _make_state()
    state, _ = jax.jit(opt.epoch)(state)

    ckpt_lib.save_checkpoint(directory, state, epoch=1)
    template = _make_state(seed=99)[3]  # different values, same structure
    restored = ckpt_lib.restore_checkpoint(
        ckpt_lib.latest_checkpoint(directory), template)

    for a, b in zip(jax.tree.leaves(state.params),
                    jax.tree.leaves(restored.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # Sampler state (configs + RNG keys) round-trips too — the reference
    # dropped it on resume (SURVEY.md §5.4).
    np.testing.assert_array_equal(np.asarray(state.sampler.configs),
                                  np.asarray(restored.sampler.configs))
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(state.sampler.keys)),
        np.asarray(jax.random.key_data(restored.sampler.keys)))
    assert int(restored.epoch) == int(state.epoch)


@pytest.mark.slow
def test_orbax_backend_roundtrip(tmp_path):
    """The orbax backend round-trips the full TrainState (incl. PRNG
    keys) and interoperates with latest_checkpoint/restore dispatch."""
    directory = str(tmp_path)
    _, _, opt, state = _make_state()
    state, _ = jax.jit(opt.epoch)(state)

    path = ckpt_lib.save_checkpoint(directory, state, epoch=2,
                                    backend='orbax')
    assert path.endswith('.orbax')
    assert ckpt_lib.latest_checkpoint(directory) == path
    template = _make_state(seed=99)[3]
    restored = ckpt_lib.restore_checkpoint(path, template)

    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(a))
            if ckpt_lib._is_key_array(a) else np.asarray(a),
            np.asarray(jax.random.key_data(b))
            if ckpt_lib._is_key_array(b) else np.asarray(b))

    # Mixed-backend rotation: newest (by epoch) wins regardless of backend.
    ckpt_lib.save_checkpoint(directory, state, epoch=3, backend='msgpack')
    assert ckpt_lib.latest_checkpoint(directory).endswith('.msgpack')


def test_resume_is_bit_exact(tmp_path):
    """Epoch after save/restore == epoch without the round-trip."""
    directory = str(tmp_path)
    _, _, opt, state = _make_state()
    epoch_fn = jax.jit(opt.epoch)
    state, _ = epoch_fn(state)

    ckpt_lib.save_checkpoint(directory, state, epoch=1)
    direct, _ = epoch_fn(state)

    template = _make_state(seed=99)[3]
    restored = ckpt_lib.restore_checkpoint(
        ckpt_lib.latest_checkpoint(directory), template)
    resumed, _ = epoch_fn(restored)

    for a, b in zip(jax.tree.leaves(direct.params),
                    jax.tree.leaves(resumed.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(direct.sampler.configs),
                                  np.asarray(resumed.sampler.configs))


def test_checkpoint_rotation(tmp_path):
    directory = str(tmp_path)
    _, _, _, state = _make_state()
    for epoch in range(8):
        ckpt_lib.save_checkpoint(directory, state, epoch, max_to_keep=3)
    import glob, os
    files = sorted(glob.glob(os.path.join(directory, 'ckpt_epoch_*')))
    assert len(files) == 3
    assert ckpt_lib.checkpoint_epoch(
        ckpt_lib.latest_checkpoint(directory)) == 7


def test_params_only_roundtrip(tmp_path):
    _, wf, _, state = _make_state()
    path = ckpt_lib.save_params_only(str(tmp_path), state.params, 'target')
    template = wf.init(jax.random.key(123))
    restored = ckpt_lib.restore_params_only(path, template)
    for a, b in zip(jax.tree.leaves(state.params), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_epoch_keyed_lr_schedule():
    """Piecewise-constant LR keyed on the EPOCH counter regardless of
    update cadence (reference training.py:86-91)."""
    import jax.numpy as jnp
    from cgs_vmc_jax.optim.common import make_optax_optimizer

    config = Config(learning_rates=[1e-3, 1e-4, 2e-5, 1e-5],
                    learning_rate_stops=[300, 600, 1000])
    opt = make_optax_optimizer(config)
    assert float(opt.learning_rate(jnp.int32(0))) == pytest.approx(1e-3)
    assert float(opt.learning_rate(jnp.int32(299))) == pytest.approx(1e-3)
    assert float(opt.learning_rate(jnp.int32(300))) == pytest.approx(1e-4)
    assert float(opt.learning_rate(jnp.int32(999))) == pytest.approx(2e-5)
    assert float(opt.learning_rate(jnp.int32(5000))) == pytest.approx(1e-5)


def test_lr_schedule_validation():
    with pytest.raises(ValueError, match='one more entry'):
        from cgs_vmc_jax.optim.common import make_optax_optimizer
        make_optax_optimizer(Config(learning_rates=[1e-3],
                                    learning_rate_stops=[10]))
