"""The in-repo msgpack codec: byte-identical to flax's format, lossless on
full train states, and enough for the CLI without flax installed."""

import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cgs_vmc_jax import gpu_checks, lattice
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.models import build_wavefunction
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import GROUND_STATE_OPTIMIZERS
from cgs_vmc_jax.utils import checkpoint, codec, compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _train_state(optimizer='SR'):
    cfg = Config(num_sites=8, wavefunction_type='rbm', num_fc_layers=1,
                 fc_layer_size=8, batch_size=16, optimizer='adam',
                 wavefunction_optimizer_type=optimizer)
    wf = build_wavefunction(cfg)
    ham = HeisenbergHamiltonian(lattice.chain_bonds(8), -1.0, 1.0)
    opt = GROUND_STATE_OPTIMIZERS[optimizer](wf, ham, cfg)
    return opt.init_state(jax.random.key(0))


def _assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        if checkpoint._is_key_array(x):
            x, y = jax.random.key_data(x), jax.random.key_data(y)
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize('optimizer', ['SR', 'EnergyGradient'])
def test_train_state_round_trip(tmp_path, optimizer):
    """A full TrainState (params, optax state, sampler configs and typed
    PRNG keys, epoch, extras) survives save and restore bit-exactly."""
    state = _train_state(optimizer)
    path = checkpoint.save_checkpoint(str(tmp_path), state, 3)
    restored = checkpoint.restore_checkpoint(path, state)
    _assert_trees_equal(restored, state)
    assert checkpoint.checkpoint_epoch(path) == 3


def _misc_tree():
    return {'ints': [0, 127, 128, 255, 256, 65535, 65536, 2 ** 33, -1,
                     -32, -33, -128, -129, -40000, -2 ** 40],
            'floats': (1.5, -0.0, float('inf')),
            'flags': [True, False, None],
            'text': ['', 'x' * 31, 'y' * 32, 'z' * 300],
            'complex': complex(1.0, -2.0),
            'scalars': [np.float32(3.0), np.int64(-7), np.bool_(True)],
            'arrays': [np.zeros((0,), np.float32), np.arange(6, dtype=np.int8),
                       np.ones((2, 3), np.complex64),
                       np.arange(70000, dtype=np.uint8),
                       jnp.ones((4,), jnp.bfloat16)]}


@pytest.mark.parametrize('case', ['train_state', 'misc', 'params'])
def test_bytes_identical_to_flax(case):
    flax_serialization = pytest.importorskip('flax.serialization')
    if case == 'train_state':
        tree = jax.device_get(checkpoint._encode_keys(_train_state()))
    elif case == 'misc':
        tree = _misc_tree()
    else:
        tree = jax.device_get(gpu_checks.flagship_wavefunction()[1])
    data = codec.to_bytes(tree)
    assert data == flax_serialization.to_bytes(tree)
    _assert_trees_equal(codec.from_bytes(tree, data),
                        flax_serialization.from_bytes(tree, data))


def test_committed_artifacts_reencode_byte_identically():
    """Every committed artifact decodes and re-encodes to the same bytes."""
    names = sorted(f for f in os.listdir(os.path.join(REPO, 'artifacts'))
                   if f.endswith('.msgpack'))
    assert names
    for name in names:
        with open(os.path.join(REPO, 'artifacts', name), 'rb') as f:
            data = f.read()
        assert codec.to_bytes(codec.msgpack_restore(data)) == data, name


def test_flagship_artifact_loads_into_template():
    wf, params = gpu_checks.flagship_wavefunction()
    template = wf.init(jax.random.key(0))
    assert jax.tree.structure(params) == jax.tree.structure(template)
    for p, t in zip(jax.tree.leaves(params), jax.tree.leaves(template)):
        assert p.shape == t.shape and p.dtype == t.dtype
    assert any(not np.allclose(p, t) for p, t in
               zip(jax.tree.leaves(params), jax.tree.leaves(template)))


def test_mismatched_template_is_an_error():
    state = _train_state()
    data = codec.to_bytes(jax.device_get(state.params))
    with pytest.raises(ValueError):
        codec.from_bytes({'other': 0}, data)
    with pytest.raises(ValueError):
        codec.msgpack_restore(data + b'\x00')


def test_cli_trains_without_flax(tmp_path):
    """`cgs train` and `cgs eval` import and run with flax (and orbax)
    unavailable."""
    script = (
        'import sys\n'
        "sys.modules['flax'] = None\n"
        "sys.modules['orbax'] = None\n"
        'from cgs_vmc_jax import cli\n'
        "args = ['--checkpoint_dir', sys.argv[1], '--num_sites', '8',\n"
        "        '--wavefunction_type', 'rbm', '--override',\n"
        "        'num_epochs=2,batch_size=8,num_batches_per_epoch=1,'\n"
        "        'num_equilibration_sweeps=1,num_fc_layers=0,'\n"
        "        'fc_layer_size=4,num_evaluation_samples=2']\n"
        "assert cli.main(['train'] + args) == 0\n"
        "assert cli.main(['eval'] + args) == 0\n"
        "assert 'flax' not in [m.split('.')[0] for m, v in\n"
        '                      sys.modules.items() if v is not None]\n')
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, '-c', script, str(tmp_path)],
                            env=env, capture_output=True, text=True,
                            timeout=600, cwd=REPO)
    assert result.returncode == 0, result.stderr[-3000:]
    assert (tmp_path / 'ckpt_epoch_2.msgpack').exists()
    assert 'Energy' in result.stdout


def test_orbax_backend_names_its_extra(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'orbax', None)
    with pytest.raises(ImportError, match=r'\.\[orbax\]'):
        checkpoint.save_checkpoint(str(tmp_path), {'x': np.zeros(2)}, 0,
                                   backend='orbax')


def test_compile_cache_respects_environment(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, 'update',
                        lambda name, value: calls.append((name, value)))
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', '/elsewhere/cache')
    assert compile_cache.configure() == '/elsewhere/cache'
    assert calls == []
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR')
    path = compile_cache.configure()
    assert path == os.path.join(REPO, '.jax_cache')
    assert calls == [('jax_compilation_cache_dir', path)]
