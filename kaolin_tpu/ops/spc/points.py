"""SPC point utilities: quantization, morton codes, corners, trilinear.

Parity: ``kaolin/ops/spc/points.py`` + ``kaolin/csrc/ops/spc/
point_utils_cuda.cu`` (reference).

Conventions (must match ``kaolin/csrc/spc_math.h:93-121``):

* morton code interleaves (x, y, z) with x in bit ``3i+2``, y in ``3i+1``,
  z in ``3i`` — so a child's octant id within its parent byte is
  ``x<<2 | y<<1 | z`` of its local coords.
* corners of a point P are ``P + (j>>2 & 1, j>>1 & 1, j & 1)`` for
  ``j in [0, 8)``.

Split: morton encode/decode and octree *construction* are
host-side numpy (build-time, data-dependent output shapes — uint64 without
touching jax x64 config); querying / interpolation are traced jnp and fully
differentiable.
"""

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    'quantize_points',
    'unbatched_points_to_octree',
    'points_to_morton',
    'morton_to_points',
    'points_to_corners',
    'unbatched_interpolate_trilinear',
    'coords_to_trilinear',
    'coords_to_trilinear_coeffs',
    'create_dense_spc',
]


def quantize_points(x, level):
    """Quantize [-1, 1] float coords to integer grid coords at ``level``.

    Parity: ``kaolin/ops/spc/points.py:35``.

    Args:
        x: (..., 3) float coords in [-1, 1].
        level: octree level (grid res = 2^level).

    Returns:
        (..., 3) int16 coords in [0, 2^level - 1].
    """
    res = 2 ** level
    qpts = jnp.floor((x + 1.0) * (res / 2.0)).astype(jnp.int32)
    return jnp.clip(qpts, 0, res - 1).astype(jnp.int16)


def points_to_morton(points):
    """Morton codes of quantized points (host numpy, uint64).

    Parity: ``kaolin/ops/spc/points.py:79``.

    Example:
        >>> import numpy as np
        >>> points_to_morton(
        ...     np.array([[0, 0, 0], [0, 0, 1], [1, 1, 1]])).tolist()
        [0, 1, 7]

    Args:
        points: (N, 3) integer coords (level <= 15, i.e. coords < 2^16).

    Returns:
        numpy (N,) uint64 morton codes.
    """
    pts = np.asarray(points).astype(np.uint64)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    code = np.zeros(pts.shape[0], dtype=np.uint64)
    for i in range(16):
        bit = np.uint64(1 << i)
        code |= (z & bit) << np.uint64(2 * i)
        code |= (y & bit) << np.uint64(2 * i + 1)
        code |= (x & bit) << np.uint64(2 * i + 2)
    return code


def morton_to_points(morton):
    """Decode morton codes to (N, 3) int16 points (host numpy).

    Parity: ``kaolin/ops/spc/points.py:107``.
    """
    m = np.asarray(morton).astype(np.uint64)
    x = np.zeros(m.shape[0], dtype=np.uint64)
    y = np.zeros(m.shape[0], dtype=np.uint64)
    z = np.zeros(m.shape[0], dtype=np.uint64)
    for i in range(16):
        x |= (m & np.uint64(1 << (3 * i + 2))) >> np.uint64(2 * i + 2)
        y |= (m & np.uint64(1 << (3 * i + 1))) >> np.uint64(2 * i + 1)
        z |= (m & np.uint64(1 << (3 * i))) >> np.uint64(2 * i)
    return np.stack([x, y, z], axis=-1).astype(np.int16)


def unbatched_points_to_octree(points, level, sorted=False):
    """Build an octree byte array from quantized points (host numpy).

    Bottom-up construction replacing the CUDA scan/compactify pipeline
    (``kaolin/csrc/ops/spc/spc_cuda.cu:33-181``): per level, children are
    grouped by parent morton code and OR-ed into occupancy bytes.

    Parity: ``kaolin/ops/spc/points.py:53``.

    Args:
        points: (N, 3) integer coords in [0, 2^level - 1].
        level: max octree level.
        sorted: unused (kept for API parity; input is always deduplicated).

    Returns:
        jnp uint8 octree byte array.
    """
    return jnp.asarray(unbatched_points_to_octree_np(points, level))


def unbatched_points_to_octree_np(points, level, sorted=False):
    """Host-numpy variant of :func:`unbatched_points_to_octree` — same
    output as a numpy array.  Use when the octree stays host-side (e.g.
    feeding :func:`scan_octrees`, which is host-side too)."""
    del sorted
    morton = np.unique(points_to_morton(np.asarray(points)))
    levels = []
    for _ in range(level, 0, -1):
        parents = morton >> np.uint64(3)
        child_bits = (morton & np.uint64(7)).astype(np.int64)
        uniq, inv = np.unique(parents, return_inverse=True)
        bytes_l = np.zeros(uniq.shape[0], dtype=np.uint8)
        np.bitwise_or.at(bytes_l, inv, (1 << child_bits).astype(np.uint8))
        levels.append(bytes_l)
        morton = uniq
    return np.concatenate(levels[::-1]) if levels else \
        np.zeros(0, dtype=np.uint8)


def points_to_corners(points):
    """The 8 corners of each point's voxel.

    Parity: ``kaolin/ops/spc/points.py:133``; ordering matches
    ``point_utils_cuda.cu:25-42``: corner j offset =
    ``(j>>2 & 1, j>>1 & 1, j & 1)``.

    Args:
        points: (..., 3) integer coords.

    Returns:
        (..., 8, 3) coords, same dtype.
    """
    points = jnp.asarray(points)
    j = jnp.arange(8)
    offs = jnp.stack([(j >> 2) & 1, (j >> 1) & 1, j & 1],
                     axis=-1).astype(points.dtype)  # (8, 3)
    return points[..., None, :] + offs


def coords_to_trilinear(coords, points, level):
    """Deprecated alias of :func:`coords_to_trilinear_coeffs`."""
    import warnings
    warnings.warn("coords_to_trilinear is deprecated, "
                  "please use coords_to_trilinear_coeffs instead",
                  DeprecationWarning)
    return coords_to_trilinear_coeffs(coords, points, level)


def coords_to_trilinear_coeffs(coords, points, level):
    """Trilinear interpolation coefficients of coords w.r.t. their voxel.

    Parity: ``kaolin/ops/spc/points.py:313``; coefficient j corresponds to
    corner j (same ordering as :func:`points_to_corners`).

    Args:
        coords: (..., 3) float coords in [-1, 1].
        points: (..., 3) integer voxel coords at ``level``.
        level: octree level.

    Returns:
        (..., 8) coefficients.
    """
    res = 2 ** level
    x = (coords * 0.5 + 0.5) * res - points.astype(coords.dtype)
    _x = 1.0 - x
    cx, cy, cz = x[..., 0], x[..., 1], x[..., 2]
    _cx, _cy, _cz = _x[..., 0], _x[..., 1], _x[..., 2]
    return jnp.stack([
        _cx * _cy * _cz,
        _cx * _cy * cz,
        _cx * cy * _cz,
        _cx * cy * cz,
        cx * _cy * _cz,
        cx * _cy * cz,
        cx * cy * _cz,
        cx * cy * cz,
    ], axis=-1)


def unbatched_interpolate_trilinear(coords, pidx, point_hierarchy, trinkets,
                                    feats, level):
    """Trilinearly interpolate corner features at sample coords.

    Fully differentiable in jnp (w.r.t. ``coords`` and ``feats``) — replaces
    the reference's CUDA forward + hand-written backward
    (``kaolin/ops/spc/points.py:172-245``).

    Args:
        coords: (N, k, 3) float coords in [-1, 1].
        pidx: (N,) int indices into ``point_hierarchy`` (from
            :func:`unbatched_query`); -1 entries produce zeros.
        point_hierarchy: (num_points, 3) int coords.
        trinkets: (num_points, 8) int corner indices (level-local into the
            dual hierarchy / ``feats``).
        feats: (num_corners, D) corner features.
        level: octree level of the query.

    Returns:
        (N, k, D) interpolated features.
    """
    valid = pidx >= 0
    safe_pidx = jnp.maximum(pidx, 0)
    sel_points = point_hierarchy[safe_pidx]      # (N, 3)
    sel_trinkets = trinkets[safe_pidx]           # (N, 8)
    coeffs = coords_to_trilinear_coeffs(
        coords, sel_points[:, None, :], level)   # (N, k, 8)
    corner_feats = feats[sel_trinkets]           # (N, 8, D)
    out = jnp.einsum('nkc,ncd->nkd', coeffs.astype(feats.dtype),
                     corner_feats)
    return jnp.where(valid[:, None, None], out, 0.)


def create_dense_spc(level, **kwargs):
    """Create a fully dense SPC octree at ``level``.

    Parity: ``kaolin/ops/spc/points.py:344``.

    Returns:
        (octree uint8 array, lengths int32 numpy (1,)).
    """
    num_bytes = sum(8 ** l for l in range(level))
    octree = jnp.full((num_bytes,), 255, dtype=jnp.uint8)
    return octree, np.array([num_bytes], dtype=np.int32)
