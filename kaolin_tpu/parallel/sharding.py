"""Device-mesh + sharding helpers for multi-chip rendering.

The reference has no multi-GPU layer (SURVEY.md §2.3) — this module is the
scale-out design: rays / pixels / views are sharded over a
``jax.sharding.Mesh``; mesh/texture/lighting parameters are replicated and
their gradients are ``psum``-reduced across devices, overlapped with the
backward pass by XLA.
"""

import functools
from typing import Optional, Sequence

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ['make_mesh', 'shard_views', 'replicate', 'multi_view_grad']


def make_mesh(axis_shapes: Sequence[int] = None,
              axis_names: Sequence[str] = ('data',),
              devices=None) -> Mesh:
    """Create a device mesh.

    Args:
        axis_shapes: sizes per axis (default: all devices on one axis).
        axis_names: names per axis (default ('data',)).
        devices: devices to use (default all).

    Returns:
        jax.sharding.Mesh.
    """
    if devices is None:
        devices = jax.devices()
    if axis_shapes is None:
        axis_shapes = (len(devices),)
    need = int(np.prod(axis_shapes))
    if need > len(devices):
        raise ValueError(
            f"mesh shape {tuple(axis_shapes)} needs {need} devices, "
            f"only {len(devices)} available")
    arr = np.asarray(devices[:need]).reshape(axis_shapes)
    return Mesh(arr, axis_names)


def shard_views(mesh: Mesh, tree, axis: str = 'data'):
    """Place the leading (view/batch) axis of every leaf on a mesh axis."""
    sharding = NamedSharding(mesh, P(axis))
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), tree)


def replicate(mesh: Mesh, tree):
    """Replicate every leaf across the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(
        lambda x: jax.device_put(x, sharding), tree)


def multi_view_grad(loss_fn, mesh: Mesh, axis: str = 'data'):
    """Build a sharded grad function for multi-view optimization.

    ``loss_fn(params, views) -> scalar`` is evaluated per shard of views
    (leading axis sharded over ``axis``); the total loss and parameter
    gradients are psum-reduced across the mesh.

    Returns:
        ``fn(params, views) -> (loss, grads)`` with replicated outputs.
    """
    def local_loss(params, views):
        value, grads = jax.value_and_grad(loss_fn)(params, views)
        value = jax.lax.psum(value, axis)
        grads = jax.lax.psum(grads, axis)
        return value, grads

    return jax.shard_map(
        local_loss, mesh=mesh,
        in_specs=(P(), P(axis)),
        out_specs=(P(), P()),
        check_vma=False)
