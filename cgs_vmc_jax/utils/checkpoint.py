"""Checkpointing: full train-state serialization with rotation.

The reference checkpointed ONLY trainable variables via tf.train.Saver
(max_to_keep=5) and silently dropped sampler state and the non-trainable
norm shift on resume (cgs_vmc/run_training.py:134-139; SURVEY.md §5.4).
Here the ENTIRE TrainState pytree — params, optimizer state, sampler
configs/RNG/stats, epoch counter, optimizer extras — round-trips, so a
resumed run continues bit-exactly.

Two backends (config.checkpoint_backend):
 * 'msgpack' (default): one file per checkpoint in the flax msgpack
   format (utils/codec.py) — simple, portable, append-friendly for
   artifact hand-off.
 * 'orbax': orbax.checkpoint StandardCheckpointer directories — async-
   capable, sharding-aware restore for large multi-host states.  Needs
   the optional `orbax` extra (pip install .[orbax]).
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Optional

import jax
import numpy as np

from cgs_vmc_jax.utils import codec


_CKPT_RE = re.compile(r'ckpt_epoch_(\d+)\.msgpack$')
_ORBAX_RE = re.compile(r'ckpt_epoch_(\d+)\.orbax$')


def _is_key_array(x) -> bool:
    return isinstance(x, jax.Array) and jax.dtypes.issubdtype(
        x.dtype, jax.dtypes.prng_key)


def _encode_keys(tree: Any) -> Any:
    """Typed PRNG key arrays -> raw uint32 key data (msgpack-friendly)."""
    return jax.tree.map(
        lambda x: {'__prng_key_data__': np.asarray(jax.random.key_data(x))}
        if _is_key_array(x) else x,
        tree, is_leaf=_is_key_array)


def _decode_keys(tree: Any, template: Any) -> Any:
    def restore(leaf_t, leaf):
        if _is_key_array(leaf_t):
            data = leaf['__prng_key_data__'] if isinstance(leaf, dict) \
                else leaf
            impl = jax.random.key_impl(leaf_t)
            return jax.random.wrap_key_data(
                jax.numpy.asarray(data), impl=impl)
        return leaf
    return jax.tree.map(restore, template, tree,
                        is_leaf=lambda x: _is_key_array(x))


def _orbax():
    try:
        import orbax.checkpoint as ocp
    except ImportError as err:
        raise ImportError(
            "checkpoint_backend='orbax' needs the optional orbax extra: "
            'pip install .[orbax]') from err
    return ocp


def _all_checkpoints(directory: str):
    """Sorted (epoch, path) pairs across both backends."""
    found = []
    for p in glob.glob(os.path.join(directory, 'ckpt_epoch_*')):
        m = _CKPT_RE.search(p) or _ORBAX_RE.search(p)
        if m:
            found.append((int(m.group(1)), p))
    return sorted(found)


def save_checkpoint(directory: str, state: Any, epoch: int,
                    max_to_keep: int = 5, backend: str = 'msgpack') -> str:
    """Writes ckpt_epoch_{epoch}.{msgpack|orbax} and rotates old ones."""
    os.makedirs(directory, exist_ok=True)
    if backend == 'orbax':
        import shutil
        ocp = _orbax()
        path = os.path.abspath(
            os.path.join(directory, f'ckpt_epoch_{epoch}.orbax'))
        if os.path.exists(path):
            shutil.rmtree(path)
        with ocp.StandardCheckpointer() as checkpointer:
            checkpointer.save(path, jax.device_get(_encode_keys(state)))
    elif backend == 'msgpack':
        path = os.path.join(directory, f'ckpt_epoch_{epoch}.msgpack')
        host_state = jax.device_get(_encode_keys(state))
        payload = codec.to_bytes(host_state)
        tmp = path + '.tmp'
        with open(tmp, 'wb') as f:
            f.write(payload)
        os.replace(tmp, path)
    else:
        raise ValueError(f'Unknown checkpoint backend {backend!r} '
                         "(known: 'msgpack', 'orbax')")

    checkpoints = _all_checkpoints(directory)
    for _, old in checkpoints[:-max_to_keep] if max_to_keep else []:
        if os.path.isdir(old):
            import shutil
            shutil.rmtree(old)
        else:
            os.remove(old)
    return path


def latest_checkpoint(directory: str) -> Optional[str]:
    checkpoints = _all_checkpoints(directory)
    return checkpoints[-1][1] if checkpoints else None


def restore_checkpoint(path: str, template: Any) -> Any:
    """Restores a state pytree saved by save_checkpoint (either backend).

    `template` must be a structurally identical state (e.g. from
    optimizer.init_state with the same config) providing shapes/dtypes.
    """
    if path.endswith('.orbax'):
        ocp = _orbax()
        encoded_template = jax.device_get(_encode_keys(template))
        abstract = jax.tree.map(ocp.utils.to_shape_dtype_struct,
                                encoded_template)
        with ocp.StandardCheckpointer() as checkpointer:
            restored = checkpointer.restore(os.path.abspath(path), abstract)
        return _decode_keys(restored, template)
    with open(path, 'rb') as f:
        payload = f.read()
    encoded_template = jax.device_get(_encode_keys(template))
    try:
        restored = codec.from_bytes(encoded_template, payload)
    except Exception as err:
        raise ValueError(
            f'checkpoint {path!r} does not match the TrainState template '
            'built from this config — it was saved with a different '
            'config or framework version.  Known break: BasisIterSWO '
            'checkpoints saved before the dummy-sampler width change '
            '(1 -> 256 chains) no longer restore as full TrainStates; '
            'recover the weights with '
            'checkpoint.restore_params_from_checkpoint(path, params) '
            f'instead.  Underlying error: {err}') from err
    return _decode_keys(restored, template)


def save_params_only(directory: str, params: Any, name: str) -> str:
    """Standalone parameter snapshot (the supervisor hand-off format:
    the reference restored a fixed target from a different run's
    checkpoint dir, cgs_vmc/run_supervised_training.py:125-127)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f'{name}.msgpack')
    with open(path, 'wb') as f:
        f.write(codec.to_bytes(jax.device_get(params)))
    return path


def restore_params_only(path: str, template: Any) -> Any:
    with open(path, 'rb') as f:
        return codec.from_bytes(jax.device_get(template), f.read())


def restore_params_from_checkpoint(path: str, params_template: Any) -> Any:
    """Extracts ONLY the wavefunction parameters from a full-TrainState
    checkpoint (either backend), without needing a structurally matching
    TrainState template.

    This is how the reference's evaluator could evaluate ANY run — ground-
    state or supervised — regardless of which optimizer produced it: it
    restored trainable variables only (cgs_vmc/run_energy_evaluation.py:
    76-83).  Our full-state checkpoints additionally carry optimizer state
    and sampler state whose structure depends on the optimizer; by reading
    the raw state dict and deserializing just the 'params' subtree onto a
    template built from the wavefunction alone, evaluation works on any
    checkpoint (including distilled/supervised runs, whose TrainState a
    ground-state init_state cannot reproduce).
    """
    if path.endswith('.orbax'):
        ocp = _orbax()
        with ocp.PyTreeCheckpointer() as checkpointer:
            raw = checkpointer.restore(os.path.abspath(path))
    else:
        with open(path, 'rb') as f:
            raw = codec.msgpack_restore(f.read())
    if 'params' not in raw:
        raise ValueError(
            f'{path!r} does not contain a top-level params subtree '
            f'(keys: {sorted(raw)})')
    return codec.from_state_dict(
        jax.device_get(params_template), raw['params'])


def restore_ema_from_checkpoint(path: str, params_template: Any) -> Any:
    """Extracts the Polyak/EMA-averaged wavefunction parameters
    (TrainState.extra['ema_params'], written when the run trained with
    config.param_ema_decay > 0) from a full-TrainState checkpoint."""
    if path.endswith('.orbax'):
        ocp = _orbax()
        with ocp.PyTreeCheckpointer() as checkpointer:
            raw = checkpointer.restore(os.path.abspath(path))
    else:
        with open(path, 'rb') as f:
            raw = codec.msgpack_restore(f.read())
    ema = raw.get('extra', {}).get('ema_params')
    if ema is None:
        raise ValueError(
            f'{path!r} carries no EMA parameters — the run was trained '
            f'with param_ema_decay=0')
    return codec.from_state_dict(
        jax.device_get(params_template), ema)


def save_config(directory: str, config) -> None:
    os.makedirs(directory, exist_ok=True)
    config.save(os.path.join(directory, 'config.json'))


def checkpoint_epoch(path: str) -> int:
    match = _CKPT_RE.search(path) or _ORBAX_RE.search(path)
    if not match:
        raise ValueError(f'Not a checkpoint path: {path}')
    return int(match.group(1))
