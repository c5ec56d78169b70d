"""Child process for the 2-process DCN smoke test (test_multihost.py).

Usage: python _dcn_child.py <process_id> <coordinator_address>

Each process contributes 2 virtual CPU devices; after
`initialize_distributed` the global mesh spans 4 devices across the two
processes and a pmean over the chains axis is a genuine cross-process
collective (the code path the reference never had, SURVEY.md §2.7).
"""
import os
import sys

proc_id = int(sys.argv[1])
coordinator = sys.argv[2]
os.environ['JAX_PLATFORMS'] = 'cpu'
os.environ['XLA_FLAGS'] = (
    os.environ.get('XLA_FLAGS', '')
    + ' --xla_force_host_platform_device_count=2').strip()

from cgs_vmc_jax.parallel import mesh as mesh_lib  # noqa: E402

idx = mesh_lib.initialize_distributed(
    coordinator_address=coordinator, num_processes=2, process_id=proc_id)
assert idx == proc_id, (idx, proc_id)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4, jax.device_count()
assert jax.local_device_count() == 2

mesh = mesh_lib.make_mesh()
assert mesh.shape[mesh_lib.CHAINS_AXIS] == 4

# Each process contributes its process index; the pmean over the global
# chains axis must see both hosts' data: mean([0, 0, 1, 1]) = 0.5.
local = jnp.full((jax.local_device_count(),), float(proc_id), jnp.float32)
global_arr = multihost_utils.host_local_array_to_global_array(
    local, mesh, P(mesh_lib.CHAINS_AXIS))

fn = jax.jit(jax.shard_map(
    lambda v: jax.lax.pmean(jnp.sum(v), mesh_lib.CHAINS_AXIS),
    mesh=mesh, in_specs=(P(mesh_lib.CHAINS_AXIS),), out_specs=P()))
out = float(fn(global_arr))
assert abs(out - 0.5) < 1e-6, out
print(f'DCN_SMOKE_OK process={proc_id} pmean={out}', flush=True)
