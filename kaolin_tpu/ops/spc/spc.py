"""SPC (structured point cloud) core ops: scan, points, query, dual.

Parity: ``kaolin/ops/spc/spc.py`` + CUDA kernels
``kaolin/csrc/ops/spc/`` (reference).

Split:

* octree **construction/scanning** (data-dependent shapes) is host numpy —
  these are build-time preprocessing steps (``scan_octrees.cu:34-114``,
  ``generate_points.cu:28-81`` replaced by vectorized numpy).
* **query** (the ``identify`` octree walk, ``spc_utils.cuh:32-106``) is a
  vmapped jnp gather loop over levels — jit-able, static shapes.
* **to_dense** is a jnp scatter (backward = gather, by autodiff).
"""

import numpy as np
import jax
import jax.numpy as jnp

from kaolin_tpu.ops.spc.points import (points_to_corners, points_to_morton,
                                       morton_to_points, quantize_points)

__all__ = [
    'scan_octrees',
    'generate_points',
    'to_dense',
    'feature_grids_to_spc',
    'unbatched_query',
    'unbatched_get_level_points',
    'unbatched_make_dual',
    'unbatched_make_trinkets',
]

KAOLIN_SPC_MAX_LEVELS = 15  # reference spc_math.h:37


def scan_octrees(octrees, lengths):
    """Scan a batch of octrees: popcounts, exclusive sums, pyramids.

    Parity: ``kaolin/ops/spc/spc.py:40`` / ``scan_octrees.cu:34-114``.

    Args:
        octrees: packed uint8 byte array of all octrees.
        lengths: (B,) bytes per octree (host array).

    Returns:
        (max_level, pyramids, exsum):
            - max_level (int): depth of the octrees.
            - pyramids: (B, 2, max_level + 2) int32 jnp array;
              ``[b, 0, l]`` = points at level l, ``[b, 1, l]`` = prefix.
            - exsum: (num_bytes + B,) int32 jnp array; per octree, a leading
              0 followed by the inclusive popcount sum.
    """
    octrees_np = np.asarray(octrees)
    lengths_np = np.asarray(lengths)
    B = lengths_np.shape[0]
    counts = np.bitwise_count(octrees_np).astype(np.int32) if hasattr(
        np, 'bitwise_count') else np.unpackbits(
        octrees_np[:, None], axis=1).sum(1).astype(np.int32)

    exsums = []
    pyramids = []
    max_level = 0
    start = 0
    for b in range(B):
        osize = int(lengths_np[b])
        c = counts[start:start + osize]
        ex = np.zeros(osize + 1, dtype=np.int32)
        np.cumsum(c, out=ex[1:])
        exsums.append(ex)
        # walk level sizes: nodes at level l+1 = total children through the
        # level-l bytes; cumulative bytes through level l = 1 + prev_sum
        # (scan_octrees.cu:96-108)
        sizes = [1]
        total, prev_sum = 1, 0
        while total <= osize:
            curr_sum = int(ex[prev_sum + 1])
            lsize = curr_sum - prev_sum
            prev_sum = curr_sum
            sizes.append(lsize)
            total += lsize
        pyramids.append(sizes)
        max_level = max(max_level, len(sizes) - 1)
        start += osize

    pyr = np.zeros((B, 2, max_level + 2), dtype=np.int32)
    for b, sizes in enumerate(pyramids):
        pyr[b, 0, :len(sizes)] = sizes
        pyr[b, 1, 1:len(sizes) + 1] = np.cumsum(sizes)
    return max_level, jnp.asarray(pyr), jnp.asarray(np.concatenate(exsums))


def generate_points(octrees, pyramids, exsum):
    """Decode octrees into point hierarchies (host numpy expansion).

    Parity: ``kaolin/ops/spc/spc.py:75`` / ``generate_points.cu:28-81``.

    Returns:
        (total_points, 3) int16 jnp array: concatenated per-octree point
        hierarchies (level 0 root .. max_level leaves, BFS order).
    """
    octrees_np = np.asarray(octrees)
    pyr = np.asarray(pyramids)
    B = pyr.shape[0]
    out = []
    start = 0
    child_offsets = np.stack([(np.arange(8) >> 2) & 1,
                              (np.arange(8) >> 1) & 1,
                              np.arange(8) & 1], axis=-1).astype(np.int32)
    for b in range(B):
        sizes = pyr[b, 0]
        # depth L: levels 0..L hold points; bytes exist for levels 0..L-1
        L = int(np.max(np.nonzero(sizes)[0])) if sizes.any() else 0
        pts = [np.zeros((1, 3), dtype=np.int32)]
        cursor = start
        for level in range(L):
            nbytes = int(sizes[level])
            level_bytes = octrees_np[cursor:cursor + nbytes]
            cursor += nbytes
            bits = np.unpackbits(level_bytes[:, None], axis=1,
                                 bitorder='little').astype(bool)  # (n, 8)
            parent_idx, child_idx = np.nonzero(bits)
            children = pts[level][parent_idx] * 2 + child_offsets[child_idx]
            pts.append(children.astype(np.int32))
        out.append(np.concatenate(pts, axis=0).astype(np.int16))
        start = cursor
    return jnp.asarray(np.concatenate(out, axis=0))


def unbatched_get_level_points(point_hierarchy, pyramid, level):
    """Points of one level.  Parity: ``kaolin/ops/spc/spc.py:302``."""
    pyramid = np.asarray(pyramid)
    return point_hierarchy[int(pyramid[1, level]):int(pyramid[1, level + 1])]


def unbatched_query(octree, exsum, query_coords, level, with_parents=False):
    """Query point-hierarchy indices for coordinates (jit-able).

    Vectorized ``identify`` walk (``spc_utils.cuh:32-106``): per level,
    select the child octant from the coordinate bits, check the occupancy
    byte, and advance via the exclusive-sum indirection.

    Parity: ``kaolin/ops/spc/spc.py:252``.

    Args:
        octree: (num_bytes,) uint8.
        exsum: (num_bytes + 1,) int32 (leading 0 + inclusive sums).
        query_coords: (N, 3); float in [-1, 1] or int in [0, 2^level).
        level: target level.
        with_parents: return the whole path (N, level+1).

    Returns:
        (N,) or (N, level+1) int32 indices into the point hierarchy
        (-1 = miss).
    """
    octree = jnp.asarray(octree)
    exsum = jnp.asarray(exsum)
    if jnp.issubdtype(query_coords.dtype, jnp.floating):
        coords = quantize_points(query_coords, level).astype(jnp.int32)
    else:
        coords = query_coords.astype(jnp.int32)
    maxval = (1 << level) - 1
    in_bounds = jnp.all((coords >= 0) & (coords <= maxval), axis=-1)

    N = coords.shape[0]
    ord0 = jnp.zeros((N,), dtype=jnp.int32)
    alive0 = in_bounds
    path = [jnp.where(in_bounds, 0, -1)] if with_parents else None

    ord_, alive = ord0, alive0
    for l in range(level):
        depth = level - l - 1
        cbits = (coords >> depth) & 1  # (N, 3)
        child_idx = (cbits[:, 0] << 2) | (cbits[:, 1] << 1) | cbits[:, 2]
        bits = octree[jnp.clip(ord_, 0, octree.shape[0] - 1)].astype(
            jnp.int32)
        hit = (bits >> child_idx) & 1
        # popcount of bits below/including child — inclusive rank
        masked = bits & ((2 << child_idx) - 1)
        cnt = jax.lax.population_count(
            masked.astype(jnp.uint32)).astype(jnp.int32)
        new_ord = exsum[jnp.clip(ord_, 0, exsum.shape[0] - 1)] + cnt
        alive = alive & (hit == 1)
        ord_ = jnp.where(alive, new_ord, ord_)
        if with_parents:
            path.append(jnp.where(alive, ord_, -1))
    result = jnp.where(alive, ord_, -1)
    if with_parents:
        path[-1] = result
        return jnp.stack(path, axis=-1)
    return result


def to_dense(point_hierarchies, pyramids, input, level=-1, **kwargs):
    """Scatter SPC features into a dense (B, C, 2^l, 2^l, 2^l) grid.

    Differentiable w.r.t. ``input`` (backward = gather, via autodiff) —
    replaces ``feature_grids_cuda.cu:28-62``.

    Parity: ``kaolin/ops/spc/spc.py:122``.

    Args:
        point_hierarchies: packed (total_points, 3) int coords.
        pyramids: (B, 2, max_level + 2) int32.
        input: (total_points_at_level, C) features, concatenated per batch.
        level: level to densify (-1 = deepest).

    Returns:
        (B, C, 2^l, 2^l, 2^l) dense grid.
    """
    pyr = np.asarray(pyramids)
    B = pyr.shape[0]
    max_level = pyr.shape[2] - 2
    if level < 0:
        level = max_level
    res = 2 ** level
    C = input.shape[-1]
    out = jnp.zeros((B, C, res, res, res), dtype=input.dtype)
    in_start = 0
    hier_start = 0
    for b in range(B):
        lo = hier_start + int(pyr[b, 1, level])
        hi = hier_start + int(pyr[b, 1, level + 1])
        pts = point_hierarchies[lo:hi].astype(jnp.int32)
        n = hi - lo
        feats = input[in_start:in_start + n]
        # advanced indices separated by a slice put the point axis first:
        # the target slice has shape (n, C)
        out = out.at[b, :, pts[:, 0], pts[:, 1], pts[:, 2]].set(feats)
        in_start += n
        hier_start += int(pyr[b, 1, max_level + 1])
    return out


def feature_grids_to_spc(feature_grids, masks=None):
    """Convert dense feature grids to SPC (host-side construction).

    Parity: ``kaolin/ops/spc/spc.py:173``.

    Args:
        feature_grids: (B, C, X, Y, Z) features.
        masks: optional (B, X, Y, Z) bool occupancy (default: any feature
            != 0).

    Returns:
        (octrees, lengths, coalescent_features): packed uint8 octrees,
        (B,) int32 lengths, and packed features of occupied voxels in
        morton order.
    """
    from kaolin_tpu.ops.spc.points import unbatched_points_to_octree
    grids = np.asarray(feature_grids)
    B, C = grids.shape[:2]
    res = grids.shape[2]
    level = int(np.log2(res))
    if masks is None:
        masks = np.any(grids != 0, axis=1)
    else:
        masks = np.asarray(masks).astype(bool)
    octrees, lengths, feats = [], [], []
    for b in range(B):
        coords = np.stack(np.nonzero(masks[b]), axis=-1)
        morton = points_to_morton(coords)
        order = np.argsort(morton)
        coords = coords[order]
        octree = np.asarray(unbatched_points_to_octree(coords, level))
        octrees.append(octree)
        lengths.append(octree.shape[0])
        # numpy advanced-indexing puts the point axis first: (n, C)
        feats.append(grids[b, :, coords[:, 0], coords[:, 1], coords[:, 2]])
    return (jnp.asarray(np.concatenate(octrees)),
            np.asarray(lengths, dtype=np.int32),
            jnp.asarray(np.concatenate(feats, axis=0)))


def unbatched_make_dual(point_hierarchy, pyramid):
    """Dual octree: corners of all voxels per level (host numpy).

    Parity: ``kaolin/ops/spc/spc.py:322``.

    Returns:
        (point_hierarchy_dual (num_dual, 3) int16,
         pyramid_dual (2, max_level + 2) int32).
    """
    pyr = np.asarray(pyramid)
    num_levels = pyr.shape[1] - 1
    dual_points = []
    sizes = []
    ph = np.asarray(point_hierarchy)
    for lvl in range(num_levels):
        pts = ph[int(pyr[1, lvl]):int(pyr[1, lvl + 1])]
        corners = np.asarray(points_to_corners(pts)).reshape(-1, 3)
        morton = np.unique(points_to_morton(corners))
        dual_points.append(morton_to_points(morton))
        sizes.append(dual_points[-1].shape[0])
    pyramid_dual = np.zeros((2, num_levels + 1), dtype=np.int32)
    pyramid_dual[0, :num_levels] = sizes
    pyramid_dual[1, 1:num_levels + 1] = np.cumsum(sizes)
    return (jnp.asarray(np.concatenate(dual_points, axis=0)),
            jnp.asarray(pyramid_dual))


def unbatched_make_trinkets(point_hierarchy, pyramid, point_hierarchy_dual,
                            pyramid_dual):
    """Indirection pointers from primary voxels to their 8 dual corners.

    The reference builds a python dict LUT over morton codes
    (``kaolin/ops/spc/spc.py:429-469``); here a sorted-morton searchsorted
    does the lookup vectorized.

    Returns:
        (trinkets (num_points, 8) int32 — level-local indices into the dual,
         parents (num_points,) int32 — global indices of parent voxels).
    """
    pyr = np.asarray(pyramid)
    pyr_dual = np.asarray(pyramid_dual)
    ph = np.asarray(point_hierarchy)
    phd = np.asarray(point_hierarchy_dual)
    num_levels = min(pyr.shape[1] - 1, pyr_dual.shape[1] - 1)
    trinkets = []
    parents = []
    for lvl in range(num_levels):
        pts = ph[int(pyr[1, lvl]):int(pyr[1, lvl + 1])]
        corners = np.asarray(points_to_corners(pts)).reshape(-1, 3)
        mt_src = points_to_morton(corners)
        pts_dual = phd[int(pyr_dual[1, lvl]):int(pyr_dual[1, lvl + 1])]
        mt_dest = points_to_morton(pts_dual)  # sorted by construction
        idx = np.searchsorted(mt_dest, mt_src)
        trinkets.append(idx.reshape(-1, 8).astype(np.int32))

        if lvl == 0:
            parents.append(np.array([-1], dtype=np.int32))
        else:
            parent_pts = pts // 2
            mt_parent = points_to_morton(parent_pts)
            pts_prev = ph[int(pyr[1, lvl - 1]):int(pyr[1, lvl])]
            mt_prev = points_to_morton(pts_prev)
            pidx = np.searchsorted(mt_prev, mt_parent)
            parents.append(pidx.astype(np.int32) + int(pyr[1, lvl - 1]))
    return (jnp.asarray(np.concatenate(trinkets, axis=0)),
            jnp.asarray(np.concatenate(parents)))
