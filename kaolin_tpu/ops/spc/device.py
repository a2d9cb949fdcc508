"""Device-side (jit-able) SPC octree construction.

The host-numpy builders in :mod:`kaolin_tpu.ops.spc.spc` /
:mod:`kaolin_tpu.ops.conversions.trianglemesh` are fine for offline
preprocessing, but driver config #3 (mesh -> level-10 SPC -> raytrace)
wants the build on-device.  This module provides static-shape XLA
equivalents (SURVEY.md §7 M2 plan; parity:
``kaolin/csrc/ops/spc/spc_cuda.cu:33-181`` and
``mesh_to_spc_cuda.cu:309-456``):

* all state is padded to static capacities with validity masks;
* compaction is gather-based (cumsum + searchsorted) — no scatters;
* octree bytes come from segment *sums* over morton-sorted voxels (after
  dedup each (parent, child) pair is unique, so OR == sum of distinct
  child bits);
* morton codes are two-word ``(hi, lo)`` int32 pairs
  (:func:`morton2_i32`), covering the reference's full level range
  (<= 15, ``spc_math.h:37``) without int64.

Everything returns (padded arrays, counts); trim on host if dynamic
shapes are wanted.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ['morton_i32', 'points_to_octree_device', 'pack_octree_device',
           'mesh_to_spc_device']

_OFFS = np.stack([(np.arange(8) >> 2) & 1, (np.arange(8) >> 1) & 1,
                  np.arange(8) & 1], axis=-1).astype(np.int32)


def _spread3(x):
    """Interleave the low 10 bits of x with two zero bits (int32)."""
    x = x & 0x3ff
    x = (x | (x << 16)) & jnp.int32(0x30000ff)
    x = (x | (x << 8)) & jnp.int32(0x300f00f)
    x = (x | (x << 4)) & jnp.int32(0x30c30c3)
    x = (x | (x << 2)) & jnp.int32(0x9249249)
    return x


def morton_i32(points):
    """Morton codes of (..., 3) int coords, valid through level 10."""
    p = points.astype(jnp.int32)
    return (_spread3(p[..., 0]) << 2) | (_spread3(p[..., 1]) << 1) \
        | _spread3(p[..., 2])


def morton2_i32(points):
    """Two-word morton codes valid through level 15 (the reference's
    ``KAOLIN_SPC_MAX_LEVELS``, ``spc_math.h:37``): returns ``(hi, lo)``
    int32 words holding bits [30, 45) and [0, 30) of the 45-bit code —
    jnp has no int64 by default, so the code is a lexicographically
    ordered pair instead."""
    p = points.astype(jnp.int32)
    lo = (_spread3(p[..., 0]) << 2) | (_spread3(p[..., 1]) << 1) \
        | _spread3(p[..., 2])
    ph = (p >> 10) & 0x1f
    hi = (_spread3(ph[..., 0]) << 2) | (_spread3(ph[..., 1]) << 1) \
        | _spread3(ph[..., 2])
    return hi, lo


def _morton2_parent(hi, lo):
    """Shift a two-word morton code right by one level (>> 3)."""
    return hi >> 3, ((hi & 7) << 27) | ((lo >> 3) & 0x7ffffff)


def _compact(keep, arrays, cap):
    """Order-preserving compaction of rows where ``keep`` is True.

    Gather-only (cumsum + searchsorted), no scatter.

    Returns (compacted arrays padded to ``cap``, count, valid mask).
    """
    cs = jnp.cumsum(keep.astype(jnp.int32))
    total = cs[-1]
    j = jnp.arange(cap, dtype=jnp.int32)
    src = jnp.searchsorted(cs, j + 1, side='left').astype(jnp.int32)
    src = jnp.clip(src, 0, keep.shape[0] - 1)
    valid = j < total
    out = []
    for a in arrays:
        rows = a[src]
        zeros = jnp.zeros_like(rows)
        mask = valid.reshape((cap,) + (1,) * (rows.ndim - 1))
        out.append(jnp.where(mask, rows, zeros))
    return out, total, valid


def _level_bytes(hi, lo, valid, cap_parent):
    """One bottom-up level: occupancy bytes of the (sorted, deduped,
    padded) child morton codes + the parent codes for the next level.

    Morton codes are two-word ``(hi, lo)`` pairs (:func:`morton2_i32`).

    Returns (bytes (cap_parent,) uint8 padded, parent (hi, lo),
    parent_count, parent_valid).
    """
    phi, plo = _morton2_parent(hi, lo)
    child = lo & 7
    # first occurrence of each parent among valid entries
    prev_hi = jnp.concatenate([jnp.full((1,), -1, phi.dtype), phi[:-1]])
    prev_lo = jnp.concatenate([jnp.full((1,), -1, plo.dtype), plo[:-1]])
    first = valid & ((phi != prev_hi) | (plo != prev_lo) | (jnp.arange(
        phi.shape[0]) == 0))
    # byte index of each entry = rank of its parent
    pidx = jnp.cumsum(first.astype(jnp.int32)) - 1
    nparents = jnp.sum(first.astype(jnp.int32))
    bits = jnp.where(valid, (1 << child).astype(jnp.int32), 0)
    bytes_ = jnp.zeros((cap_parent,), jnp.int32).at[
        jnp.clip(pidx, 0, cap_parent - 1)].add(bits)
    (pm_hi, pm_lo), _, pvalid = _compact(first, (phi, plo), cap_parent)
    return bytes_.astype(jnp.uint8), (pm_hi, pm_lo), nparents, pvalid


@functools.partial(jax.jit, static_argnames=('level', 'cap'))
def points_to_octree_device(points, valid, level, cap=None):
    """Jit-able octree build from quantized points.

    Parity: ``kaolin/ops/spc/points.py:53`` (host version:
    ``unbatched_points_to_octree``).

    Args:
        points: (N, 3) int coords in [0, 2^level); may contain duplicates.
        valid: (N,) bool mask of real entries.
        level: octree depth (<= 15; two-word morton, :func:`morton2_i32`).
        cap: static per-level capacity (default N).

    Returns:
        (octree_bytes (sum of caps,) uint8 padded per level with the
        per-level payload front-aligned, level_counts (level,) int32 —
        bytes per level (level 0 byte last), total_bytes int32,
        leaf_morton (cap, 2) int32 sorted deduped ``(hi, lo)`` code
        words, leaf_count).

        The byte array layout matches the reference: root byte first,
        then level 1, ..., leaves' parents last.  Use
        :func:`pack_octree_host` to trim to a contiguous byte string.
    """
    assert level <= 15, 'SPC supports level <= 15 (spc_math.h:37)'
    N = points.shape[0]
    if cap is None:
        cap = N
    hi, lo = morton2_i32(points)
    big = jnp.int32(2 ** 30)
    key_hi = jnp.where(valid, hi, big)
    key_lo = jnp.where(valid, lo, big)
    key_hi, key_lo = jax.lax.sort((key_hi, key_lo), num_keys=2)
    # dedup
    prev_hi = jnp.concatenate([jnp.full((1,), -1, key_hi.dtype),
                               key_hi[:-1]])
    prev_lo = jnp.concatenate([jnp.full((1,), -1, key_lo.dtype),
                               key_lo[:-1]])
    uniq_first = ((key_hi != prev_hi) | (key_lo != prev_lo)) \
        & (key_hi < big)
    (m_hi, m_lo), leaf_count, valid_l = _compact(
        uniq_first, (key_hi, key_lo), cap)
    leaf_morton = jnp.where(valid_l[:, None],
                            jnp.stack([m_hi, m_lo], -1), 0)

    # the bottom-up byte pass is shape-uniform per level, so one
    # lax.scan body compiles once instead of ``level`` times
    def body(state, _):
        (cur_hi, cur_lo), cur_valid = state
        b, pm, nb, pvalid = _level_bytes(cur_hi, cur_lo, cur_valid, cap)
        return (pm, pvalid), (b, nb)

    (_, _), (level_bytes, level_counts) = jax.lax.scan(
        body, ((m_hi, m_lo), valid_l), None,
        length=level)  # deepest level first
    # assemble: level 0 (root parents of level-1) ... level-1 bytes
    octree = jnp.flip(level_bytes, axis=0).reshape(-1)
    counts = jnp.flip(level_counts, axis=0)
    return octree, counts, jnp.sum(counts), leaf_morton, leaf_count


def pack_octree_host(octree_padded, level_counts, cap):
    """Trim the padded per-level byte blocks into a contiguous octree."""
    counts = np.asarray(level_counts)
    blocks = []
    arr = np.asarray(octree_padded)
    for i, c in enumerate(counts):
        blocks.append(arr[i * cap:i * cap + int(c)])
    return np.concatenate(blocks)


@functools.partial(jax.jit, static_argnames=('cap', 'out_cap'))
def pack_octree_device(octree_padded, level_counts, cap, out_cap=None):
    """Device-side version of :func:`pack_octree_host`: compact the
    ``(levels * cap,)`` padded byte blocks into one contiguous prefix of
    a ``(out_cap,)`` buffer.  Keeps the bulk data on device (a padded
    level-10 build is ~10x ``cap`` bytes; reading that back through a
    slow host link dwarfs the build itself).

    Returns (octree (out_cap,) uint8 padded, total_bytes int32).
    """
    levels = octree_padded.shape[0] // cap
    if out_cap is None:
        # total octree bytes sum over ALL levels and can exceed the
        # per-level cap (deep/sparse octrees where several levels each
        # hold ~N nodes); the padded size is the only always-safe bound
        out_cap = octree_padded.shape[0]
    j = jax.lax.broadcasted_iota(jnp.int32, (levels, cap), 1)
    keep = (j < level_counts[:, None]).reshape(-1)
    (packed,), total, _ = _compact(keep, (octree_padded,), out_cap)
    return packed, total


def _tri_aabb_sat_jnp(tris, vox, r):
    """Triangle-AABB SAT (13 axes), jnp port of the host tester.

    ``r`` is the voxel half-side ``1 / 2**level`` (traced, so one scan
    body serves every level).

    Parity: ``kaolin/csrc/ops/conversions/mesh_to_spc/
    mesh_to_spc_cuda.cu:96-159``.
    """
    center = vox.astype(jnp.float32) * (2.0 * r) + (r - 1.0)
    v = tris - center[:, None, :]
    e = jnp.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 1],
                   v[:, 0] - v[:, 2]], axis=1)

    ok = jnp.ones(tris.shape[0], dtype=bool)
    for a in range(3):
        mn = v[:, :, a].min(1)
        mx = v[:, :, a].max(1)
        ok &= ~((mn > r) | (mx < -r))
    n = jnp.cross(e[:, 0], e[:, 1])
    d = jnp.sum(n * v[:, 0], axis=1)
    rad = jnp.abs(n).sum(-1) * r
    ok &= jnp.abs(d) <= rad
    for i in range(3):
        for a in range(3):
            axis = np.zeros(3, np.float32)
            axis[a] = 1.
            cross = jnp.cross(e[:, i], jnp.asarray(axis)[None])
            p = jnp.einsum('nj,nkj->nk', cross, v)
            rad = jnp.abs(cross).sum(-1) * r
            ok &= ~((p.min(1) > rad) | (p.max(1) < -rad))
    return ok


def _voxel_center_bary_jnp(tris, vox, level):
    """Barycentric uv of voxel centers (mesh_to_spc_cuda.cu:252-305)."""
    r = 1.0 / (1 << level)
    center = vox.astype(jnp.float32) * (2.0 * r) + (r - 1.0)
    v0 = tris[:, 1] - tris[:, 0]
    v1 = tris[:, 2] - tris[:, 0]
    v2 = center - tris[:, 0]
    d00 = jnp.sum(v0 * v0, axis=1)
    d01 = jnp.sum(v0 * v1, axis=1)
    d11 = jnp.sum(v1 * v1, axis=1)
    d20 = jnp.sum(v2 * v0, axis=1)
    d21 = jnp.sum(v2 * v1, axis=1)
    denom = d00 * d11 - d01 * d01
    denom = jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
    u = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    return jnp.stack([u, w], axis=-1)


@functools.partial(jax.jit, static_argnames=('level', 'cap'))
def mesh_to_spc_device(face_vertices, level, cap=2 ** 21):
    """Jit-able conservative mesh voxelization (driver config #3 path).

    Coarse-to-fine (voxel, triangle) proposal expansion with the SAT
    filter applied *before* compaction, so peak memory per level is the
    static ``8 * min(cap, T * 8^l)`` proposal block rather than an
    unbounded materialization.

    Parity: ``kaolin/csrc/ops/conversions/mesh_to_spc/
    mesh_to_spc_cuda.cu:309-456`` (same SAT, same first-triangle-per-voxel
    dedup rule).

    Args:
        face_vertices: (T, 3, 3) float32 triangles in [-1, 1].
        level: target level (<= 15).
        cap: static max surviving proposals per level (and max voxels).

    Returns:
        (octree_padded, level_counts, total_bytes   — see
         :func:`points_to_octree_device`,
         vox (cap, 3) int32 padded leaf voxels (morton order),
         tri (cap,) int32 first intersecting triangle per voxel,
         bary (cap, 2) float32,
         count int32 — number of leaf voxels).
    """
    assert level <= 15, 'SPC supports level <= 15 (spc_math.h:37)'
    T = face_vertices.shape[0]
    if T > cap:
        raise ValueError(
            f'mesh_to_spc_device: cap={cap} must be >= the face count '
            f'({T}) — every face is a level-0 proposal')
    fv = face_vertices.astype(jnp.float32)
    fv9 = fv.reshape(T, 9)

    vox = jnp.zeros((T, 3), jnp.int32)
    tri = jnp.arange(T, dtype=jnp.int32)
    valid = jnp.ones((T,), bool)
    offs = jnp.asarray(_OFFS)

    def level_step(vox, tri, valid, r, cap_l):
        vox8 = (vox[:, None, :] * 2 + offs[None]).reshape(-1, 3)
        tri8 = jnp.repeat(tri, 8)
        valid8 = jnp.repeat(valid, 8)
        tris = fv9[tri8].reshape(-1, 3, 3)
        keep = valid8 & _tri_aabb_sat_jnp(tris, vox8, r)
        (vox, tri), _, valid = _compact(keep, (vox8, tri8), cap_l)
        return vox, tri, valid

    # small levels (capacity still growing) unroll; once the capacity
    # saturates at ``cap`` the pass is shape-uniform, so the remaining
    # levels run under ONE lax.scan body (compiled once — the unrolled
    # version cost ~2 minutes of XLA compile at level 10 / cap 2^21)
    scan_from = level + 1
    for l in range(1, level + 1):
        if T * 8 ** l >= cap:
            scan_from = l
            break
        vox, tri, valid = level_step(vox, tri, valid,
                                     jnp.float32(1.0 / (1 << l)),
                                     T * 8 ** l)
    if scan_from <= level:
        pad_n = cap - vox.shape[0]
        vox = jnp.pad(vox, ((0, pad_n), (0, 0)))
        tri = jnp.pad(tri, (0, pad_n))
        valid = jnp.pad(valid, (0, pad_n))

        def body(state, r):
            vox, tri, valid = state
            return level_step(vox, tri, valid, r, cap), None

        rs = jnp.asarray([1.0 / (1 << l)
                          for l in range(scan_from, level + 1)],
                         jnp.float32)
        (vox, tri, valid), _ = jax.lax.scan(body, (vox, tri, valid), rs)

    # dedup voxels keeping the lowest triangle id (reference's lexsort
    # (morton, tri) + first-occurrence rule)
    hi, lo = morton2_i32(vox)
    big = jnp.int32(2 ** 30)
    key_hi = jnp.where(valid, hi, big)
    key_lo = jnp.where(valid, lo, big)
    kh, kl, tri_s, v0, v1, v2 = jax.lax.sort(
        (key_hi, key_lo, tri, vox[:, 0], vox[:, 1], vox[:, 2]),
        num_keys=3)
    prev_hi = jnp.concatenate([jnp.full((1,), -1, kh.dtype), kh[:-1]])
    prev_lo = jnp.concatenate([jnp.full((1,), -1, kl.dtype), kl[:-1]])
    first = ((kh != prev_hi) | (kl != prev_lo)) & (kh < big)
    vox_s = jnp.stack([v0, v1, v2], axis=-1)
    (vox, tri), count, valid = _compact(first, (vox_s, tri_s), cap)

    octree, counts, nbytes, _, _ = points_to_octree_device(
        vox, valid, level, cap=cap)
    bary = _voxel_center_bary_jnp(fv9[tri].reshape(-1, 3, 3), vox, level)
    bary = jnp.where(valid[:, None], bary, 0.)
    return octree, counts, nbytes, vox, tri, bary, count
