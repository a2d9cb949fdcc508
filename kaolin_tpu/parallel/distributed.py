"""Multi-host (multi-process) execution.

The reference has no distributed layer at all (SURVEY.md §2.3 — no
torch.distributed / NCCL anywhere); this is the scale-out design for
driver config #5 (multi-host inverse rendering: views sharded over all
devices of all hosts, parameters replicated, gradient ``psum`` within a
host and across hosts).

Usage (one call per process, before any jax computation):

    from kaolin_tpu.parallel import distributed as D
    D.initialize(coordinator_address="host0:1234",
                 num_processes=2, process_id=i)
    mesh = D.make_global_mesh()          # all devices, ('data',)
    views = D.host_local_array(mesh, per_host_views)  # global array
    step = multi_view_grad(loss_fn, mesh)             # parallel/sharding

The CPU test path (``tests/test_multihost.py``) launches 2 processes
with ``--xla_force_host_platform_device_count`` and checks the psum'd
loss/grads agree across processes.
"""

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ['initialize', 'is_initialized', 'make_global_mesh',
           'host_local_array', 'process_index', 'process_count']

_initialized = False


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, local_device_ids=None):
    """Connect this process to the cluster (``jax.distributed``).

    On CPU/GPU clusters pass all arguments explicitly (nothing tells JAX
    of the cluster).  Idempotent: safe to call once per process.
    """
    global _initialized
    if _initialized:
        return
    kwargs = {}
    if coordinator_address is not None:
        kwargs['coordinator_address'] = coordinator_address
    if num_processes is not None:
        kwargs['num_processes'] = num_processes
    if process_id is not None:
        kwargs['process_id'] = process_id
    if local_device_ids is not None:
        kwargs['local_device_ids'] = local_device_ids
    jax.distributed.initialize(**kwargs)
    _initialized = True


def is_initialized():
    return _initialized


def process_index():
    return jax.process_index()


def process_count():
    return jax.process_count()


def make_global_mesh(axis_names=('data',), axis_shapes=None):
    """Device mesh over ALL devices of ALL processes.

    With the default single ``'data'`` axis, devices are laid out
    process-major so that a view batch sharded on ``data`` keeps each
    host's shard on its local devices: the gradient ``psum`` then reduces
    within a host first and crosses hosts only once per host pair.

    For an explicit host/device split use
    ``axis_names=('host', 'device'), axis_shapes=(num_processes, -1)``
    and shard batch-like axes over ``('host', 'device')``.
    """
    devices = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    if axis_shapes is None:
        axis_shapes = (len(devices),) if len(axis_names) == 1 else None
    if axis_shapes is None:
        raise ValueError("axis_shapes required for multi-axis meshes")
    shapes = list(axis_shapes)
    if -1 in shapes:
        known = int(np.prod([s for s in shapes if s != -1]))
        shapes[shapes.index(-1)] = len(devices) // known
    arr = np.asarray(devices).reshape(shapes)
    return Mesh(arr, axis_names)


def host_local_array(mesh, host_local_data, axis='data'):
    """Build a global jax.Array from per-host data shards.

    Each process passes only ITS slice of the global batch (leading
    axis); the result is a global array sharded over ``axis`` with no
    cross-host transfer — the replacement for a distributed data loader.
    """
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree_util.tree_map(
        lambda x: jax.make_array_from_process_local_data(
            sharding, np.asarray(x)), host_local_data)
