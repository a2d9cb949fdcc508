"""SPC ray tracing into a per-ray k-buffer.

Parity target: ``kaolin/render/spc/raytrace.py:31`` +
``kaolin/csrc/render/spc/raytrace_cuda.cu:485-607`` (reference) — the hit
set and per-ray near-to-far ordering of :func:`~kaolin_tpu.render.spc.
raytrace.unbatched_raytrace`, repacked from packed nuggets into a dense
per-ray k-buffer (:class:`CoherentHits`): the natural layout for the
volume-rendering consumers (``exponential_integration`` over a fixed k
axis, NGLOD-style), with exact per-ray hit counts and a saturation flag.
:func:`hits_to_nuggets` converts back to the packed nugget format.
"""

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from kaolin_tpu.render.spc.raytrace import unbatched_raytrace

__all__ = ['CoherentHits', 'unbatched_raytrace_coherent', 'hits_to_nuggets']

_INF = jnp.inf


class CoherentHits(NamedTuple):
    """Per-ray k-buffer of voxel intersections, near-to-far.

    Attributes:
        t_near: (num_rays, knum) f32 entry depths, inf-padded.
        t_far: (num_rays, knum) f32 exit depths, inf-padded.
        pidx: (num_rays, knum) int32 point-hierarchy indices, -1-padded.
        count: (num_rays,) int32 exact per-ray hit count (can exceed
            ``knum``; the buffer then holds the nearest ``knum``).
        saturated: () bool — True if the traversal overflowed its nugget
            capacity (hits were dropped) or any ray's hits overflowed
            ``knum``.
    """
    t_near: jnp.ndarray
    t_far: jnp.ndarray
    pidx: jnp.ndarray
    count: jnp.ndarray
    saturated: jnp.ndarray


def unbatched_raytrace_coherent(octree, point_hierarchy, pyramid, exsum,
                                origin, direction, level, knum=64,
                                max_nuggets=None):
    """Trace rays against an SPC octree into a per-ray k-buffer.

    Same inputs as :func:`~kaolin_tpu.render.spc.raytrace.
    unbatched_raytrace`, whose level-synchronous BFS does the traversal.
    Returns a :class:`CoherentHits` k-buffer instead of packed nuggets (see
    :func:`hits_to_nuggets`).

    Args:
        origin, direction: (num_rays, 3).
        level: target octree level.
        knum: per-ray hit capacity.
        max_nuggets: nugget capacity of the traversal.

    Notes:
        ``pyramid`` must be host-resident (numpy): the target level's
        point count is a static shape.  Do not trace through it.
    """
    pyramid = np.asarray(pyramid)     # raises if traced — intentional
    ridx, pidx, depths, info = unbatched_raytrace(
        octree, point_hierarchy, pyramid, exsum, origin, direction,
        level, with_exit=True, max_nuggets=max_nuggets, trim=False,
        return_info=True)
    return _nuggets_to_hits(ridx, pidx, depths, info, origin.shape[0], knum)


@functools.partial(jax.jit, static_argnames=('num_rays', 'knum'))
def _nuggets_to_hits(ridx, pidx, depths, info, num_rays, knum):
    """Packed ray-major nuggets -> :class:`CoherentHits` k-buffer."""
    live = ridx >= 0
    r = jnp.where(live, ridx, num_rays)
    count = jnp.zeros((num_rays + 1,), jnp.int32).at[r].add(1)
    start = jnp.cumsum(count) - count
    slot = jnp.arange(ridx.shape[0], dtype=jnp.int32) - start[r]
    slot = jnp.where(live & (slot < knum), slot, knum)

    def place(x, fill):
        buf = jnp.full((num_rays + 1, knum + 1), fill, x.dtype)
        return buf.at[r, slot].set(x)[:num_rays, :knum]

    count = count[:num_rays]
    return CoherentHits(
        place(depths[:, 0], _INF), place(depths[:, 1], _INF),
        place(pidx, -1), count,
        info.saturated | jnp.any(count > knum))


def hits_to_nuggets(hits, trim=True):
    """Convert a :class:`CoherentHits` k-buffer to the packed nugget
    format of ``unbatched_raytrace``: (ridx, pidx, depths (n, 2)).

    Order matches: ray-major, near-to-far within each ray.
    """
    N, K = hits.pidx.shape
    live = (hits.pidx >= 0).reshape(-1)
    ridx = jnp.broadcast_to(
        jnp.arange(N, dtype=jnp.int32)[:, None], (N, K)).reshape(-1)
    pidx = hits.pidx.reshape(-1)
    t_in = hits.t_near.reshape(-1)
    t_out = hits.t_far.reshape(-1)
    n = N * K
    dst = jnp.where(live, jnp.cumsum(live.astype(jnp.int32)) - 1, n)

    def pack(x, fill):
        return jnp.full((n,), fill, x.dtype).at[dst].set(
            x, mode='drop', unique_indices=True)

    ridx = pack(ridx, -1)
    pidx = pack(pidx, -1)
    depths = jnp.stack([pack(t_in, 0.), pack(t_out, 0.)], axis=-1)
    if trim:
        cnt = int(jnp.sum(live.astype(jnp.int32)))
        ridx, pidx, depths = ridx[:cnt], pidx[:cnt], depths[:cnt]
    return ridx, pidx, depths
