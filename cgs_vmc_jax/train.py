"""Training drivers: ground-state optimization and supervised distillation.

Functional re-design of the reference pipelines
(cgs_vmc/run_training.py:73-160, cgs_vmc/run_supervised_training.py) around
a single compiled epoch function: build ansatz + Hamiltonian + optimizer,
jit (optionally shard_map over a chain-sharded mesh), then a thin Python
loop of epoch calls with checkpointing and a metrics stream.
"""

from __future__ import annotations

import os
from typing import Optional

import jax
import jax.numpy as jnp

from cgs_vmc_jax import lattice, models
from cgs_vmc_jax.config import Config
from cgs_vmc_jax.ops.heisenberg import HeisenbergHamiltonian
from cgs_vmc_jax.optim import (
    GROUND_STATE_OPTIMIZERS,
    SUPERVISED_OPTIMIZERS,
    TrainState,
)
from cgs_vmc_jax.parallel import mesh as mesh_lib
from cgs_vmc_jax.utils import checkpoint as ckpt_lib
from cgs_vmc_jax.utils.metrics import MetricsLogger
from cgs_vmc_jax.utils.profiling import maybe_trace


def build_hamiltonian(config: Config):
    """Hamiltonian-family dispatch + bond resolution.

    Bonds mirror the reference (run_training.py:103-109): J-file if
    present, else the lattice implied by the config.  Families:
    'heisenberg' (the reference's only operator) and 'ising'
    (transverse-field Ising, ops/ising.py).  Also validates move-set
    ergodicity: Heisenberg sampling must conserve Sz ('exchange'), the
    TFIM must not ('flip') — a mismatched move set silently samples the
    wrong state space, so it is an error, not a warning.
    """
    j_file = config.j_file_path
    if not j_file and config.checkpoint_dir:
        candidate = os.path.join(config.checkpoint_dir, 'J.txt')
        if os.path.exists(candidate):
            j_file = candidate
    if j_file:
        bonds, couplings = lattice.load_bonds_and_couplings(j_file)
    else:
        bonds, couplings = lattice.bonds_and_couplings_for_config(config)

    family = getattr(config, 'hamiltonian_type', 'heisenberg') or 'heisenberg'
    move = getattr(config, 'mc_move_type', 'exchange') or 'exchange'
    if family == 'heisenberg':
        if move != 'exchange':
            raise ValueError(
                "hamiltonian_type='heisenberg' requires "
                "mc_move_type='exchange': single-spin flips leave the "
                f'Sz sector the Heisenberg ground state lives in (got '
                f'{move!r})')
        offdiag = None
        if getattr(config, 'heisenberg_marshall_gauge', False):
            if j_file or not getattr(config, 'heisenberg_j2', 0.0):
                raise ValueError(
                    'heisenberg_marshall_gauge applies to the built-in '
                    'J1-J2 lattices (heisenberg_j2 != 0, no j_file_path); '
                    'for pure nearest-neighbour bipartite lattices use '
                    'heisenberg_jx=-1 as the reference did')
            bonds, couplings, offdiag = lattice.j1j2_marshall_gauged(config)
        twist = None
        if getattr(config, 'twist_phi', 0.0):
            # twist_phases assigns each site the coordinate x = site %
            # size_x (or site itself on a chain); that map is only valid
            # for the built-in chain/square indexing.  Honeycomb/kagome/
            # triangular generators and arbitrary J-files have their own
            # site orderings, so silently treating them as a chain would
            # produce unphysical phases — refuse instead.
            lattice_type = getattr(config, 'lattice_type', '') or ''
            if lattice_type not in ('', 'auto', 'chain', 'square'):
                raise ValueError(
                    f'twist_phi is only supported on the built-in chain/'
                    f'square geometries (site index = x + size_x*y); got '
                    f'lattice_type={lattice_type!r}.  Pass explicit '
                    'twist_phases to HeisenbergHamiltonian for other '
                    'geometries.')
            if j_file:
                raise ValueError(
                    'twist_phi cannot be combined with j_file_path: the '
                    'bond file carries no site-coordinate information, '
                    'so per-bond twist phases cannot be derived.  Build '
                    'the Hamiltonian directly with explicit twist_phases.')
            # Geometry resolution mirrors bonds_and_couplings_for_config:
            # square iff size_x*size_y == num_sites with both > 1, else a
            # chain indexed site = x (size_y = 1).
            is_square = (config.size_x > 1 and config.size_y > 1 and
                         config.size_x * config.size_y == config.num_sites)
            size_x = config.size_x if is_square else config.num_sites
            size_y = config.size_y if is_square else 1
            twist = lattice.twist_phases(
                config.num_sites, bonds, config.twist_phi,
                size_x=size_x, size_y=size_y,
                direction=getattr(config, 'twist_direction', 'x'))
        return HeisenbergHamiltonian(
            bonds, config.heisenberg_jx, config.heisenberg_jz,
            sample_chunk=getattr(config, 'energy_chunk_samples', 0),
            couplings=couplings, offdiag_couplings=offdiag,
            twist_phases=twist)
    if family == 'ising':
        if move != 'flip':
            raise ValueError(
                "hamiltonian_type='ising' requires mc_move_type='flip': "
                'the TFIM does not conserve Sz, so the Sz-conserving '
                f'exchange move is non-ergodic for it (got {move!r})')
        from cgs_vmc_jax.ops.ising import TransverseFieldIsingHamiltonian
        return TransverseFieldIsingHamiltonian(
            bonds, h_x=config.ising_h, j_zz=config.ising_j,
            sample_chunk=getattr(config, 'energy_chunk_samples', 0),
            couplings=couplings)
    raise ValueError(f'Unknown hamiltonian_type {family!r}; '
                     "known: ['heisenberg', 'ising']")


def _ema_wrap(epoch, decay: float):
    """Tracks an exponential moving average of params across epochs.

    The slot lives in TrainState.extra['ema_params'] (see
    `_maybe_add_ema_slot`); the wrapper re-adds it after the inner epoch
    because some optimizers rebuild `extra` with their own keys.  Polyak
    averaging smooths the SR/SGD iterate noise out of the final weights —
    evaluate them with `cgs eval --ema`.
    """
    def fn(state, axis_name=None):
        ema = state.extra['ema_params']
        new_state, metrics = epoch(state, axis_name=axis_name)
        new_ema = jax.tree.map(
            lambda e, p: decay * e + (1.0 - decay) * p,
            ema, new_state.params)
        new_state = new_state._replace(
            extra={**new_state.extra, 'ema_params': new_ema})
        return new_state, metrics
    return fn


def _maybe_add_ema_slot(state: TrainState, config: Config) -> TrainState:
    """Adds the EMA params slot when param_ema_decay > 0 (before any
    checkpoint restore, so resume templates match)."""
    decay = getattr(config, 'param_ema_decay', 0.0)
    if not decay or 'ema_params' in state.extra:
        return state
    ema = jax.tree.map(jnp.copy, state.params)
    return state._replace(extra={**state.extra, 'ema_params': ema})


def _restore_for_resume(latest: str, state: TrainState,
                        config: Config) -> TrainState:
    """restore_checkpoint, tolerating an EMA slot newly enabled on an
    existing run: old checkpoints have no extra['ema_params'], so the
    slotted template fails structure matching — restore onto the
    slotless template instead and start the average at the restored
    params."""
    try:
        return ckpt_lib.restore_checkpoint(latest, state)
    except (ValueError, KeyError):
        decay = getattr(config, 'param_ema_decay', 0.0)
        if not decay or 'ema_params' not in state.extra:
            raise
        base_extra = {k: v for k, v in state.extra.items()
                      if k != 'ema_params'}
        restored = ckpt_lib.restore_checkpoint(
            latest, state._replace(extra=base_extra))
        ema = jax.tree.map(jnp.copy, restored.params)
        return restored._replace(
            extra={**restored.extra, 'ema_params': ema})


def _scan_epochs(epoch, k: int):
    """k epochs as ONE traced program; metrics gain a leading [k] axis.

    One dispatch per k epochs amortizes host->device launch latency;
    the scanned program is otherwise identical to k sequential
    epoch calls — same per-epoch metrics, same RNG/sampler threading.
    """
    def fn(state, axis_name=None):
        def body(s, _):
            return epoch(s, axis_name=axis_name)
        return jax.lax.scan(body, state, None, length=k)
    return fn


def _make_epoch_fn(optimizer, state: TrainState, config: Config,
                   epochs_per_call: int = 1):
    """Returns (epoch_fn, maybe_sharded_state).

    num_devices == 1: plain jit, no collectives.
    num_devices  > 1: shard_map over a 'chains' mesh with pmean'd moments.
    epochs_per_call > 1: the jitted program runs that many epochs per
    dispatch (metrics stacked along a leading axis).
    """
    epoch = optimizer.epoch
    decay = getattr(config, 'param_ema_decay', 0.0)
    if decay:
        epoch = _ema_wrap(epoch, decay)
    if epochs_per_call > 1:
        epoch = _scan_epochs(epoch, epochs_per_call)
    if config.num_devices <= 1:
        # Donate the incoming TrainState: the old state is dead after each
        # epoch, so XLA can reuse its memory for the new one.
        def single(state):
            return epoch(state)
        return jax.jit(single, donate_argnums=(0,)), state

    device_mesh = mesh_lib.make_mesh(config.num_devices)
    _, metric_template = jax.eval_shape(lambda s: epoch(s), state)
    fn = mesh_lib.sharded_epoch_fn(
        epoch, device_mesh, state, list(metric_template))
    return fn, mesh_lib.shard_train_state(state, device_mesh)


def _init_ground_state(config: Config, seed_offset: int = 0):
    wf = models.build_wavefunction(config)
    hamiltonian = build_hamiltonian(config)
    opt_name = config.wavefunction_optimizer_type or 'ITSWO'
    if opt_name not in GROUND_STATE_OPTIMIZERS:
        raise ValueError(
            f'Unknown ground-state optimizer {opt_name!r}; '
            f'known: {sorted(GROUND_STATE_OPTIMIZERS)}')
    optimizer = GROUND_STATE_OPTIMIZERS[opt_name](wf, hamiltonian, config)
    key = jax.random.key(config.seed + seed_offset)
    n_local = config.batch_size
    state = optimizer.init_state(key, n_local)
    return wf, hamiltonian, optimizer, state


def train(config: Config, resume: bool = False,
          logger: Optional[MetricsLogger] = None) -> TrainState:
    """Ground-state optimization pipeline (reference run_training.py).

    Saves config.json + rotating full-state checkpoints; appends per-epoch
    metrics; returns the final TrainState.
    """
    wf, _, optimizer, state = _init_ground_state(config)
    state = _maybe_add_ema_slot(state, config)
    out_dir = config.checkpoint_dir
    if out_dir:
        ckpt_lib.save_config(out_dir, config)

    start_epoch = 0
    if resume and out_dir:
        latest = ckpt_lib.latest_checkpoint(out_dir)
        if latest:
            state = _restore_for_resume(latest, state, config)
            start_epoch = ckpt_lib.checkpoint_epoch(latest)
            print(f'Resumed from {latest} (epoch {start_epoch})')

    k = max(1, getattr(config, 'epochs_per_call', 1))
    epoch_fn, state = _make_epoch_fn(optimizer, state, config,
                                     epochs_per_call=k)
    tail_fn = None  # lazily compiled single-epoch program for the remainder
    logger = logger or MetricsLogger(out_dir)

    epoch = start_epoch
    while epoch < config.num_epochs:
        if epoch + k <= config.num_epochs:
            step, fn = k, epoch_fn
        else:  # remainder shorter than k: per-epoch program
            if tail_fn is None:
                tail_fn, _ = _make_epoch_fn(optimizer, state, config)
            step, fn = 1, tail_fn
        # First block boundary at-or-after each checkpoint_frequency
        # multiple (reduces to `epoch % freq == 0` when k == 1).
        if out_dir and epoch % config.checkpoint_frequency < step:
            ckpt_lib.save_checkpoint(out_dir, state, epoch,
                                     config.max_checkpoints_to_keep,
                                     backend=config.checkpoint_backend)
        # Trace the second call (the first pays compilation).
        trace_dir = (config.profile_dir
                     if config.profile_dir and epoch == start_epoch + k
                     else None)
        with maybe_trace(trace_dir):
            state, metrics = fn(state)
            jax.block_until_ready(metrics)
        if step == 1:
            logger.log(epoch + 1, metrics)
        else:
            for j in range(step):
                logger.log(epoch + j + 1,
                           jax.tree.map(lambda x: x[j], metrics))
        epoch += step

    if out_dir:
        ckpt_lib.save_checkpoint(out_dir, state, config.num_epochs,
                                 config.max_checkpoints_to_keep,
                                 backend=config.checkpoint_backend)
    return state


def distill(config: Config, resume: bool = False,
            target_params=None, target_wf=None,
            logger: Optional[MetricsLogger] = None) -> TrainState:
    """Supervised distillation pipeline (reference run_supervised_training):
    load the supervisor's config + checkpoint from ``config.supervisor_dir``,
    build the frozen target, train the student.

    target_params/target_wf may be passed directly (tests, in-process use);
    otherwise they are restored from supervisor_dir.
    """
    if target_wf is None or target_params is None:
        sup_config = Config.load(
            os.path.join(config.supervisor_dir, 'config.json'))
        target_wf = models.build_wavefunction(sup_config)
        latest = ckpt_lib.latest_checkpoint(config.supervisor_dir)
        if latest is None:
            raise FileNotFoundError(
                f'No checkpoint in supervisor_dir {config.supervisor_dir!r}')
        # Supervisor checkpoints store a full TrainState; pull params out.
        opt_name = sup_config.wavefunction_optimizer_type or 'ITSWO'
        sup_ham = build_hamiltonian(sup_config)
        sup_opt = GROUND_STATE_OPTIMIZERS[opt_name](
            target_wf, sup_ham, sup_config)
        sup_state = sup_opt.init_state(jax.random.key(0))
        sup_state = ckpt_lib.restore_checkpoint(latest, sup_state)
        target_params = sup_state.params

    wf = models.build_wavefunction(config)
    opt_name = config.wavefunction_optimizer_type or 'SWO'
    if opt_name not in SUPERVISED_OPTIMIZERS:
        raise ValueError(
            f'Unknown supervised optimizer {opt_name!r}; '
            f'known: {sorted(SUPERVISED_OPTIMIZERS)}')
    optimizer = SUPERVISED_OPTIMIZERS[opt_name](wf, target_wf, config)

    key = jax.random.key(config.seed)
    state = optimizer.init_state(key, target_params, config.batch_size)
    state = _maybe_add_ema_slot(state, config)

    out_dir = config.checkpoint_dir
    if out_dir:
        ckpt_lib.save_config(out_dir, config)

    start_epoch = 0
    if resume and out_dir:
        latest = ckpt_lib.latest_checkpoint(out_dir)
        if latest:
            state = _restore_for_resume(latest, state, config)
            start_epoch = ckpt_lib.checkpoint_epoch(latest)
            print(f'Resumed from {latest} (epoch {start_epoch})')

    epoch_fn, state = _make_epoch_fn(optimizer, state, config)
    logger = logger or MetricsLogger(out_dir, primary='loss')

    for epoch in range(start_epoch, config.num_epochs):
        state, metrics = epoch_fn(state)
        if out_dir and (epoch + 1) % config.checkpoint_frequency == 0:
            ckpt_lib.save_checkpoint(out_dir, state, epoch + 1,
                                     config.max_checkpoints_to_keep,
                                     backend=config.checkpoint_backend)
        logger.log(epoch + 1, metrics)
    return state
