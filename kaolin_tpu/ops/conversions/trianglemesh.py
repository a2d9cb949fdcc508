"""Triangle mesh conversions: voxelgrids and SPC.

Parity: ``kaolin/ops/conversions/trianglemesh.py`` (reference).
"""

import numpy as np
import jax
import jax.numpy as jnp

from kaolin_tpu.ops.conversions.pointcloud import _base_points_to_voxelgrids
from kaolin_tpu.ops.mesh.trianglemesh import _unbatched_subdivide_vertices

__all__ = ['trianglemeshes_to_voxelgrids', 'unbatched_mesh_to_spc',
           'unbatched_mesh_to_spc_device']


def trianglemeshes_to_voxelgrids(vertices, faces, resolution, origin=None,
                                 scale=None, return_sparse=False):
    """Voxelize mesh surfaces: subdivide vertices to the target resolution
    then box-test (reference :29-110).

    Args:
        vertices: ``(B, V, 3)``.
        faces: ``(F, 3)`` int.
        resolution: output grid resolution.
        origin / scale: normalization (defaults: bbox min / max extent).

    Returns:
        ``(B, resolution, resolution, resolution)`` binary grids.
    """
    if not isinstance(resolution, int):
        raise TypeError(f"Expected resolution to be int "
                        f"but got {type(resolution)}.")
    if origin is None:
        origin = jnp.min(vertices, axis=1)
    if scale is None:
        max_val = jnp.max(vertices, axis=1)
        scale = jnp.max(max_val - origin, axis=1)
    batch_size = vertices.shape[0]
    voxelgrids = []
    norm_vertices = (vertices - origin[:, None]) / scale.reshape(-1, 1, 1)
    for b in range(batch_size):
        points = _unbatched_subdivide_vertices(
            norm_vertices[b], faces, resolution)
        voxelgrids.append(
            _base_points_to_voxelgrids(points[None], resolution)[0])
    return jnp.stack(voxelgrids)


def unbatched_mesh_to_spc_device(face_vertices, level, cap=2 ** 21):
    """Device-side (jit-able) variant of :func:`unbatched_mesh_to_spc`.

    Runs the full coarse-to-fine SAT pipeline on the device with static
    shapes (levels <= 15) and trims the padded outputs on host — output
    parity with the host builder is exact (see tests/test_spc_device.py).

    Use this variant when building many octrees (e.g. a deforming mesh
    each training step); the host builder stays
    the default for one-shot conversions and keeps the octree bytes
    host-side for :func:`~kaolin_tpu.ops.spc.scan_octrees`.

    Returns:
        (octree uint8, points (num_voxels, 3) int16, face_idx int32,
        bary (num_voxels, 2) float32) — same as the host version.
    """
    import jax
    import jax.numpy as jnp
    from kaolin_tpu.ops.spc.device import (mesh_to_spc_device,
                                           pack_octree_device)
    out = mesh_to_spc_device(jnp.asarray(face_vertices, jnp.float32),
                             int(level), cap=int(cap))
    octree_p, counts, _, vox, tri, bary, count = out
    # pack on device: the padded byte buffer is levels*cap bytes; only
    # the packed prefix ever needs to cross the (slow) device->host link
    octree_packed, nbytes = pack_octree_device(octree_p, counts,
                                               cap=int(cap))
    n, nb = int(count), int(nbytes)
    return (octree_packed[:nb], vox[:n].astype(jnp.int16),
            tri[:n].astype(jnp.int64), bary[:n])


def unbatched_mesh_to_spc(face_vertices, level):
    """Conservative mesh voxelization into an SPC octree.

    The reference uses a coarse-to-fine CUDA SAT-test pipeline with radix
    sort dedup (``mesh_to_spc_cuda.cu:309-456``); here the same
    coarse-to-fine proposal expansion runs vectorized on host numpy:
    per level, (voxel, triangle) proposal pairs are SAT-tested and
    subdivided; at the final level voxels are deduplicated keeping the
    first triangle per voxel (morton order).

    Args:
        face_vertices: ``(num_faces, 3, 3)`` triangle vertices in [-1, 1].
        level: target octree level.

    Returns:
        (octree uint8, points (num_voxels, 3) int16 morton-sorted,
        face_idx (num_voxels,) int64 first intersecting triangle,
        bary (num_voxels, 2) barycentric uv of the voxel center).
    """
    from kaolin_tpu.ops.spc.points import (points_to_morton,
                                           unbatched_points_to_octree_np)
    fv = np.asarray(face_vertices, dtype=np.float64)
    T = fv.shape[0]

    # proposals: (voxel coords at level l, triangle id)
    vox = np.zeros((T, 3), dtype=np.int64)
    tri = np.arange(T, dtype=np.int64)

    for l in range(1, level + 1):
        # subdivide each proposal into 8 children
        offs = np.stack([(np.arange(8) >> 2) & 1, (np.arange(8) >> 1) & 1,
                         np.arange(8) & 1], axis=-1)
        vox = (vox[:, None] * 2 + offs[None]).reshape(-1, 3)
        tri = np.repeat(tri, 8)
        # SAT test voxel vs triangle at level l
        keep = _tri_aabb_sat(fv[tri], vox, l)
        vox, tri = vox[keep], tri[keep]

    # dedup voxels (keep first triangle per voxel by (morton, tri) order)
    morton = points_to_morton(vox)
    order = np.lexsort((tri, morton))
    morton, vox, tri = morton[order], vox[order], tri[order]
    uniq_mask = np.concatenate([[True], morton[1:] != morton[:-1]])
    vox, tri = vox[uniq_mask], tri[uniq_mask]

    # octree stays host numpy: its consumers (scan_octrees) are host-side
    # and a jnp round-trip would force a device->host readback later
    octree = unbatched_points_to_octree_np(vox, level)
    bary = _voxel_center_bary(fv[tri], vox, level)
    return (octree, jnp.asarray(vox.astype(np.int16)), jnp.asarray(tri),
            jnp.asarray(bary.astype(np.float32)))


def _tri_aabb_sat(tris, vox, level):
    """Triangle-AABB separating axis test (13 axes).

    tris: (N, 3, 3) in [-1, 1]; vox: (N, 3) integer coords at ``level``.
    Mirrors ``mesh_to_spc_cuda.cu:96-159``.
    """
    r = 1.0 / (1 << level)  # half extent in [-1, 1] space
    center = vox * (2.0 * r) + r - 1.0  # (N, 3)
    v = tris - center[:, None, :]  # (N, 3, 3)
    h = np.array([r, r, r])

    e = np.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 1],
                  v[:, 0] - v[:, 2]], axis=1)  # (N, 3, 3)

    ok = np.ones(tris.shape[0], dtype=bool)
    # 3 box axes
    for a in range(3):
        mn = v[:, :, a].min(1)
        mx = v[:, :, a].max(1)
        ok &= ~((mn > h[a]) | (mx < -h[a]))
    # triangle normal axis
    n = np.cross(e[:, 0], e[:, 1])
    d = np.sum(n * v[:, 0], axis=1)
    rad = np.abs(n) @ h
    ok &= np.abs(d) <= rad
    # 9 cross axes
    for i in range(3):
        for a in range(3):
            axis = np.zeros(3)
            axis[a] = 1.
            cross = np.cross(e[:, i], axis)  # (N, 3)
            p = np.einsum('nj,nkj->nk', cross, v)  # (N, 3)
            rad = np.abs(cross) @ h
            ok &= ~((p.min(1) > rad) | (p.max(1) < -rad))
    return ok


def _voxel_center_bary(tris, vox, level):
    """Barycentric uv of each voxel center projected on its triangle.

    Mirrors ``mesh_to_spc_cuda.cu:252-305`` (d_ComputeBaryCoords).
    """
    r = 1.0 / (1 << level)
    center = vox * (2.0 * r) + r - 1.0
    v0 = tris[:, 1] - tris[:, 0]
    v1 = tris[:, 2] - tris[:, 0]
    v2 = center - tris[:, 0]
    d00 = np.sum(v0 * v0, axis=1)
    d01 = np.sum(v0 * v1, axis=1)
    d11 = np.sum(v1 * v1, axis=1)
    d20 = np.sum(v2 * v0, axis=1)
    d21 = np.sum(v2 * v1, axis=1)
    denom = d00 * d11 - d01 * d01
    denom = np.where(np.abs(denom) < 1e-20, 1e-20, denom)
    u = (d11 * d20 - d01 * d21) / denom
    v = (d00 * d21 - d01 * d20) / denom
    return np.stack([u, v], axis=-1)
