"""Point-in-watertight-mesh test (ray parity).

Parity: ``kaolin/ops/mesh/check_sign.py`` (reference).  The reference has a
CUDA per-(point, triangle) crossing kernel and a CPU triangle-hash path; here
a single vectorized parity count over (point-chunk × triangles) replaces
both (brute force maps well to vector hardware; the 2D hash is a CPU-cache
trick).
"""

import math

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ['check_sign', '_unbatched_check_sign_cuda']


def _crossings(points, v0, v1, v2):
    """Count +z ray crossings for each point against all triangles.

    points: (P, 3); v0/v1/v2: (F, 3).  Returns (P,) int32 counts.

    A crossing is counted when the point's xy lies inside the triangle's xy
    projection (consistent strict/non-strict edge rule via sign of the
    doubled area) and the triangle plane's z at that xy is above point z.
    """
    px = points[:, 0:1]  # (P, 1)
    py = points[:, 1:2]
    pz = points[:, 2:3]
    x0, y0, z0 = v0[:, 0], v0[:, 1], v0[:, 2]  # (F,)
    x1, y1, z1 = v1[:, 0], v1[:, 1], v1[:, 2]
    x2, y2, z2 = v2[:, 0], v2[:, 1], v2[:, 2]

    # edge functions w.r.t. each edge, (P, F)
    e01 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
    e12 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
    e20 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)  # (F,)
    # inside iff all edge functions share the sign of the doubled area;
    # half-open rule: edges where the function is 0 count only for the
    # "positive" orientation to avoid double counting shared edges.
    s = jnp.sign(area2)
    inside = ((e01 * s > 0) & (e12 * s > 0) & (e20 * s > 0)) | \
             ((e01 * s >= 0) & (e12 * s >= 0) & (e20 * s >= 0) &
              ((e01 == 0) | (e12 == 0) | (e20 == 0)) & (s > 0))
    degenerate = area2 == 0
    # z on the triangle plane at (px, py) via barycentric interpolation
    denom = jnp.where(degenerate, 1., area2)
    w0 = e12 / denom
    w1 = e20 / denom
    w2 = e01 / denom
    z_at = w0 * z0 + w1 * z1 + w2 * z2  # (P, F)
    hit = inside & ~degenerate & (z_at > pz)
    return jnp.sum(hit.astype(jnp.int32), axis=1)


def _check_sign_hash(verts, faces, points, hash_resolution):
    """Host path using the native 2D triangle hash (csrc/triangle_hash.cpp),
    mirroring the reference CPU implementation
    (``check_sign.py:160-297`` + ``triangle_hash.pyx``)."""
    from kaolin_tpu._native import TriangleHash
    verts = np.asarray(verts)
    faces_np = np.asarray(faces)
    points = np.asarray(points)
    out = np.zeros(points.shape[:2], dtype=bool)
    for b in range(verts.shape[0]):
        tris = verts[b][faces_np]  # (F, 3, 3)
        th = TriangleHash(tris[:, :, :2].astype(np.float64),
                          hash_resolution)
        pidx, tidx = th.query(points[b][:, :2].astype(np.float64))
        if pidx.size == 0:
            continue
        # candidate pairs: exact 2D containment + z-crossing parity
        t = tris[tidx]
        p = points[b][pidx]
        v0, v1, v2 = t[:, 0], t[:, 1], t[:, 2]
        e01 = ((v1[:, 0] - v0[:, 0]) * (p[:, 1] - v0[:, 1])
               - (v1[:, 1] - v0[:, 1]) * (p[:, 0] - v0[:, 0]))
        e12 = ((v2[:, 0] - v1[:, 0]) * (p[:, 1] - v1[:, 1])
               - (v2[:, 1] - v1[:, 1]) * (p[:, 0] - v1[:, 0]))
        e20 = ((v0[:, 0] - v2[:, 0]) * (p[:, 1] - v2[:, 1])
               - (v0[:, 1] - v2[:, 1]) * (p[:, 0] - v2[:, 0]))
        area2 = ((v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1])
                 - (v1[:, 1] - v0[:, 1]) * (v2[:, 0] - v0[:, 0]))
        s = np.sign(area2)
        inside = (e01 * s > 0) & (e12 * s > 0) & (e20 * s > 0) \
            & (area2 != 0)
        denom = np.where(area2 == 0, 1., area2)
        z_at = (e12 * t[:, 0, 2] + e20 * t[:, 1, 2]
                + e01 * t[:, 2, 2]) / denom
        hit = inside & (z_at > p[:, 2])
        counts = np.zeros(points.shape[1], dtype=np.int64)
        np.add.at(counts, pidx[hit], 1)
        out[b] = counts % 2 == 1
    return jnp.asarray(out)


def check_sign(verts, faces, points, hash_resolution=512, chunk_size=2048,
               use_hash=False):
    """Check whether points are inside watertight triangle meshes.

    Parity: ``kaolin/ops/mesh/check_sign.py:61``.  ``hash_resolution`` is
    accepted for API compatibility (this path needs no spatial hash).

    Args:
        verts: ``(B, V, 3)``.
        faces: ``(F, 3)`` int.
        points: ``(B, P, 3)``.
        chunk_size: points processed per step (bounds the (P, F) buffer).

    Returns:
        ``(B, P)`` bool, True = inside.
    """
    if verts.ndim != 3 or verts.shape[-1] != 3:
        raise ValueError(f"verts must be (B, V, 3), got {verts.shape}")
    if points.ndim != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be (B, P, 3), got {points.shape}")
    if use_hash:
        try:
            return _check_sign_hash(verts, faces, points, hash_resolution)
        except Exception:
            pass  # fall through to the vectorized path
    faces = jnp.asarray(faces)
    P = points.shape[1]
    pad = (-P) % chunk_size
    points_p = jnp.pad(points, ((0, 0), (0, pad), (0, 0)))

    def per_mesh(verts_b, points_b):
        fv = verts_b[faces]  # (F, 3, 3)
        chunks = points_b.reshape(-1, chunk_size, 3)
        counts = jax.lax.map(
            lambda c: _crossings(c, fv[:, 0], fv[:, 1], fv[:, 2]), chunks)
        return counts.reshape(-1)

    counts = jax.vmap(per_mesh)(verts, points_p)[:, :P]
    return counts % 2 == 1


def _unbatched_check_sign_cuda(verts, faces, points):
    """Parity alias of the reference CUDA entry point
    (``check_sign.py:47``): unbatched ray-parity inside test."""
    return check_sign(verts[None], faces, points[None])[0]
