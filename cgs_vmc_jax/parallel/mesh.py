"""Device mesh + chain-sharding utilities.

The reference is single-process single-device; its only parallel axis is a
batch of Markov chains inside one graph (SURVEY.md §2.7).  Here that axis is
promoted to a first-class mesh axis ``'chains'``: sampler state shards
across devices, parameters replicate, and every estimator moment is a
`pmean` over the mesh — the epoch function runs under `shard_map` so
collectives are explicit and the same code path serves 1 device or many.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cgs_vmc_jax.optim.common import TrainState

CHAINS_AXIS = 'chains'


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> int:
    """Multi-host (DCN) initialization for evaluation farms / big sweeps.

    Call ONCE per process before any other JAX operation; afterwards
    `jax.devices()` spans every host and `make_mesh()` builds a global
    chains mesh — Markov chains are embarrassingly parallel, so the only
    cross-host traffic is the pmean of estimator moments (SURVEY.md §2.7:
    the reference had no communication backend at all).  Arguments default
    to cluster auto-detection (GKE/Slurm env vars).  Returns the process
    index.
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs['coordinator_address'] = coordinator_address
    if num_processes is not None:
        kwargs['num_processes'] = num_processes
    if process_id is not None:
        kwargs['process_id'] = process_id
    jax.distributed.initialize(**kwargs)
    return jax.process_index()


def make_mesh(num_devices: Optional[int] = None) -> Mesh:
    """1-D mesh over the first `num_devices` devices (global devices when
    `initialize_distributed` has run; local otherwise)."""
    devices = jax.devices()
    if num_devices is None:
        num_devices = len(devices)
    if num_devices > len(devices):
        raise ValueError(
            f'Requested {num_devices} devices, have {len(devices)}')
    return Mesh(np.asarray(devices[:num_devices]), (CHAINS_AXIS,))


def chains_per_device(batch_size: int, mesh: Mesh) -> int:
    n = mesh.shape[CHAINS_AXIS]
    if batch_size % n:
        raise ValueError(
            f'batch_size={batch_size} not divisible by mesh size {n}')
    return batch_size // n


def train_state_specs(state: TrainState) -> TrainState:
    """PartitionSpecs for a TrainState: sampler leaves shard on their
    leading (chain) axis, everything else replicates.  SamplerStates held
    in ``extra`` — directly (DualSamplingSWO's target sampler) or inside
    lists/tuples (the excited-state optimizers' frozen lower-state
    samplers) — also shard."""
    from cgs_vmc_jax.sampler.metropolis import SamplerState

    def extra_spec(value):
        if isinstance(value, SamplerState):
            return jax.tree.map(lambda _: P(CHAINS_AXIS), value)
        if isinstance(value, (list, tuple)):
            return type(value)(extra_spec(v) for v in value)
        return jax.tree.map(lambda _: P(), value)

    sampler_specs = jax.tree.map(lambda _: P(CHAINS_AXIS), state.sampler)
    extra_specs = {name: extra_spec(value)
                   for name, value in state.extra.items()}
    return TrainState(
        params=jax.tree.map(lambda _: P(), state.params),
        opt_state=jax.tree.map(lambda _: P(), state.opt_state),
        sampler=sampler_specs,
        epoch=P(),
        extra=extra_specs,
    )


def sharded_epoch_fn(epoch_fn: Callable, mesh: Mesh, state: TrainState,
                     metric_names) -> Callable:
    """Wraps `epoch_fn(state, axis_name)` in shard_map over the mesh.

    epoch_fn must pmean its moments over CHAINS_AXIS (all optimizers here
    do); outputs are then replicated params + sharded sampler state.
    """
    specs = train_state_specs(state)
    metric_specs = {name: P() for name in metric_names}

    fn = partial(epoch_fn, axis_name=CHAINS_AXIS)
    mapped = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(specs,),
        out_specs=(specs, metric_specs),
        check_vma=False,
    )
    return jax.jit(mapped)


def shard_train_state(state: TrainState, mesh: Mesh) -> TrainState:
    """Places a host TrainState onto the mesh with the canonical shardings."""
    specs = train_state_specs(state)
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)),
        state, specs)
