"""Table-driven Lorensen marching cubes (XLA-native, jit-able).

Parity: ``kaolin/csrc/ops/conversions/unbatched_mcube/`` (reference) —
the unique-vertex variant used by ``voxelgrids_to_trianglemeshes``
(reference ``kaolin/ops/conversions/voxelgrid.py:158-244``): each cell
owns the up-to-3 iso vertices on its "far" edges (6, 7, 11), so output
vertices are deduplicated across cells and faces index vertices through
neighbour-cell offsets.

Redesign (SURVEY.md A.3): instead of the reference's
classify / CUB-scan / host-readback / compact / generate pipeline
(``unbatched_mcube_cuda.cu:550-637``), everything is one static-shaped
XLA program: classify all cells (vectorized table lookups), exclusive
``cumsum`` for vertex/face offsets, and masked scatters into
fixed-capacity output buffers (out-of-bounds drop).  The vertex
positions are differentiable w.r.t. the grid values through the edge
interpolation weights (the reference's CUDA op has no backward at all,
``voxelgrid.py:165-167``).

``_TRI_TABLE`` is the classic public-domain Lorensen/Bourke marching
cubes triangle table ("Polygonising a scalar field", P. Bourke, 1994);
all auxiliary tables (triangle counts, per-cell owned-vertex counts and
ordering, face-offset ranks) are derived from it at import time.  The
reference's ``tables.h`` auxiliary tables were verified to be exactly
these derivations.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ['unbatched_marching_cubes']

_TRI_TABLE = ((), (0,8,3), (0,1,9), (1,8,3,9,8,1), (1,2,10), (0,8,3,1,2,10),
    (9,2,10,0,2,9), (2,8,3,2,10,8,10,9,8), (3,11,2), (0,11,2,8,11,0),
    (1,9,0,2,3,11), (1,11,2,1,9,11,9,8,11), (3,10,1,11,10,3),
    (0,10,1,0,8,10,8,11,10), (3,9,0,3,11,9,11,10,9), (9,8,10,10,8,11), (4,7,8),
    (4,3,0,7,3,4), (0,1,9,8,4,7), (4,1,9,4,7,1,7,3,1), (1,2,10,8,4,7),
    (3,4,7,3,0,4,1,2,10), (9,2,10,9,0,2,8,4,7), (2,10,9,2,9,7,2,7,3,7,9,4),
    (8,4,7,3,11,2), (11,4,7,11,2,4,2,0,4), (9,0,1,8,4,7,2,3,11),
    (4,7,11,9,4,11,9,11,2,9,2,1), (3,10,1,3,11,10,7,8,4),
    (1,11,10,1,4,11,1,0,4,7,11,4), (4,7,8,9,0,11,9,11,10,11,0,3),
    (4,7,11,4,11,9,9,11,10), (9,5,4), (9,5,4,0,8,3), (0,5,4,1,5,0),
    (8,5,4,8,3,5,3,1,5), (1,2,10,9,5,4), (3,0,8,1,2,10,4,9,5),
    (5,2,10,5,4,2,4,0,2), (2,10,5,3,2,5,3,5,4,3,4,8), (9,5,4,2,3,11),
    (0,11,2,0,8,11,4,9,5), (0,5,4,0,1,5,2,3,11), (2,1,5,2,5,8,2,8,11,4,8,5),
    (10,3,11,10,1,3,9,5,4), (4,9,5,0,8,1,8,10,1,8,11,10),
    (5,4,0,5,0,11,5,11,10,11,0,3), (5,4,8,5,8,10,10,8,11), (9,7,8,5,7,9),
    (9,3,0,9,5,3,5,7,3), (0,7,8,0,1,7,1,5,7), (1,5,3,3,5,7),
    (9,7,8,9,5,7,10,1,2), (10,1,2,9,5,0,5,3,0,5,7,3),
    (8,0,2,8,2,5,8,5,7,10,5,2), (2,10,5,2,5,3,3,5,7), (7,9,5,7,8,9,3,11,2),
    (9,5,7,9,7,2,9,2,0,2,7,11), (2,3,11,0,1,8,1,7,8,1,5,7),
    (11,2,1,11,1,7,7,1,5), (9,5,8,8,5,7,10,1,3,10,3,11),
    (5,7,0,5,0,9,7,11,0,1,0,10,11,10,0), (11,10,0,11,0,3,10,5,0,8,0,7,5,7,0),
    (11,10,5,7,11,5), (10,6,5), (0,8,3,5,10,6), (9,0,1,5,10,6),
    (1,8,3,1,9,8,5,10,6), (1,6,5,2,6,1), (1,6,5,1,2,6,3,0,8),
    (9,6,5,9,0,6,0,2,6), (5,9,8,5,8,2,5,2,6,3,2,8), (2,3,11,10,6,5),
    (11,0,8,11,2,0,10,6,5), (0,1,9,2,3,11,5,10,6),
    (5,10,6,1,9,2,9,11,2,9,8,11), (6,3,11,6,5,3,5,1,3),
    (0,8,11,0,11,5,0,5,1,5,11,6), (3,11,6,0,3,6,0,6,5,0,5,9),
    (6,5,9,6,9,11,11,9,8), (5,10,6,4,7,8), (4,3,0,4,7,3,6,5,10),
    (1,9,0,5,10,6,8,4,7), (10,6,5,1,9,7,1,7,3,7,9,4), (6,1,2,6,5,1,4,7,8),
    (1,2,5,5,2,6,3,0,4,3,4,7), (8,4,7,9,0,5,0,6,5,0,2,6),
    (7,3,9,7,9,4,3,2,9,5,9,6,2,6,9), (3,11,2,7,8,4,10,6,5),
    (5,10,6,4,7,2,4,2,0,2,7,11), (0,1,9,4,7,8,2,3,11,5,10,6),
    (9,2,1,9,11,2,9,4,11,7,11,4,5,10,6), (8,4,7,3,11,5,3,5,1,5,11,6),
    (5,1,11,5,11,6,1,0,11,7,11,4,0,4,11), (0,5,9,0,6,5,0,3,6,11,6,3,8,4,7),
    (6,5,9,6,9,11,4,7,9,7,11,9), (10,4,9,6,4,10), (4,10,6,4,9,10,0,8,3),
    (10,0,1,10,6,0,6,4,0), (8,3,1,8,1,6,8,6,4,6,1,10), (1,4,9,1,2,4,2,6,4),
    (3,0,8,1,2,9,2,4,9,2,6,4), (0,2,4,4,2,6), (8,3,2,8,2,4,4,2,6),
    (10,4,9,10,6,4,11,2,3), (0,8,2,2,8,11,4,9,10,4,10,6),
    (3,11,2,0,1,6,0,6,4,6,1,10), (6,4,1,6,1,10,4,8,1,2,1,11,8,11,1),
    (9,6,4,9,3,6,9,1,3,11,6,3), (8,11,1,8,1,0,11,6,1,9,1,4,6,4,1),
    (3,11,6,3,6,0,0,6,4), (6,4,8,11,6,8), (7,10,6,7,8,10,8,9,10),
    (0,7,3,0,10,7,0,9,10,6,7,10), (10,6,7,1,10,7,1,7,8,1,8,0),
    (10,6,7,10,7,1,1,7,3), (1,2,6,1,6,8,1,8,9,8,6,7),
    (2,6,9,2,9,1,6,7,9,0,9,3,7,3,9), (7,8,0,7,0,6,6,0,2), (7,3,2,6,7,2),
    (2,3,11,10,6,8,10,8,9,8,6,7), (2,0,7,2,7,11,0,9,7,6,7,10,9,10,7),
    (1,8,0,1,7,8,1,10,7,6,7,10,2,3,11), (11,2,1,11,1,7,10,6,1,6,7,1),
    (8,9,6,8,6,7,9,1,6,11,6,3,1,3,6), (0,9,1,11,6,7),
    (7,8,0,7,0,6,3,11,0,11,6,0), (7,11,6), (7,6,11), (3,0,8,11,7,6),
    (0,1,9,11,7,6), (8,1,9,8,3,1,11,7,6), (10,1,2,6,11,7),
    (1,2,10,3,0,8,6,11,7), (2,9,0,2,10,9,6,11,7),
    (6,11,7,2,10,3,10,8,3,10,9,8), (7,2,3,6,2,7), (7,0,8,7,6,0,6,2,0),
    (2,7,6,2,3,7,0,1,9), (1,6,2,1,8,6,1,9,8,8,7,6), (10,7,6,10,1,7,1,3,7),
    (10,7,6,1,7,10,1,8,7,1,0,8), (0,3,7,0,7,10,0,10,9,6,10,7),
    (7,6,10,7,10,8,8,10,9), (6,8,4,11,8,6), (3,6,11,3,0,6,0,4,6),
    (8,6,11,8,4,6,9,0,1), (9,4,6,9,6,3,9,3,1,11,3,6), (6,8,4,6,11,8,2,10,1),
    (1,2,10,3,0,11,0,6,11,0,4,6), (4,11,8,4,6,11,0,2,9,2,10,9),
    (10,9,3,10,3,2,9,4,3,11,3,6,4,6,3), (8,2,3,8,4,2,4,6,2), (0,4,2,4,6,2),
    (1,9,0,2,3,4,2,4,6,4,3,8), (1,9,4,1,4,2,2,4,6), (8,1,3,8,6,1,8,4,6,6,10,1),
    (10,1,0,10,0,6,6,0,4), (4,6,3,4,3,8,6,10,3,0,3,9,10,9,3), (10,9,4,6,10,4),
    (4,9,5,7,6,11), (0,8,3,4,9,5,11,7,6), (5,0,1,5,4,0,7,6,11),
    (11,7,6,8,3,4,3,5,4,3,1,5), (9,5,4,10,1,2,7,6,11),
    (6,11,7,1,2,10,0,8,3,4,9,5), (7,6,11,5,4,10,4,2,10,4,0,2),
    (3,4,8,3,5,4,3,2,5,10,5,2,11,7,6), (7,2,3,7,6,2,5,4,9),
    (9,5,4,0,8,6,0,6,2,6,8,7), (3,6,2,3,7,6,1,5,0,5,4,0),
    (6,2,8,6,8,7,2,1,8,4,8,5,1,5,8), (9,5,4,10,1,6,1,7,6,1,3,7),
    (1,6,10,1,7,6,1,0,7,8,7,0,9,5,4), (4,0,10,4,10,5,0,3,10,6,10,7,3,7,10),
    (7,6,10,7,10,8,5,4,10,4,8,10), (6,9,5,6,11,9,11,8,9),
    (3,6,11,0,6,3,0,5,6,0,9,5), (0,11,8,0,5,11,0,1,5,5,6,11),
    (6,11,3,6,3,5,5,3,1), (1,2,10,9,5,11,9,11,8,11,5,6),
    (0,11,3,0,6,11,0,9,6,5,6,9,1,2,10), (11,8,5,11,5,6,8,0,5,10,5,2,0,2,5),
    (6,11,3,6,3,5,2,10,3,10,5,3), (5,8,9,5,2,8,5,6,2,3,8,2),
    (9,5,6,9,6,0,0,6,2), (1,5,8,1,8,0,5,6,8,3,8,2,6,2,8), (1,5,6,2,1,6),
    (1,3,6,1,6,10,3,8,6,5,6,9,8,9,6), (10,1,0,10,0,6,9,5,0,5,6,0),
    (0,3,8,5,6,10), (10,5,6), (11,5,10,7,5,11), (11,5,10,11,7,5,8,3,0),
    (5,11,7,5,10,11,1,9,0), (10,7,5,10,11,7,9,8,1,8,3,1),
    (11,1,2,11,7,1,7,5,1), (0,8,3,1,2,7,1,7,5,7,2,11),
    (9,7,5,9,2,7,9,0,2,2,11,7), (7,5,2,7,2,11,5,9,2,3,2,8,9,8,2),
    (2,5,10,2,3,5,3,7,5), (8,2,0,8,5,2,8,7,5,10,2,5),
    (9,0,1,5,10,3,5,3,7,3,10,2), (9,8,2,9,2,1,8,7,2,10,2,5,7,5,2),
    (1,3,5,3,7,5), (0,8,7,0,7,1,1,7,5), (9,0,3,9,3,5,5,3,7), (9,8,7,5,9,7),
    (5,8,4,5,10,8,10,11,8), (5,0,4,5,11,0,5,10,11,11,3,0),
    (0,1,9,8,4,10,8,10,11,10,4,5), (10,11,4,10,4,5,11,3,4,9,4,1,3,1,4),
    (2,5,1,2,8,5,2,11,8,4,5,8), (0,4,11,0,11,3,4,5,11,2,11,1,5,1,11),
    (0,2,5,0,5,9,2,11,5,4,5,8,11,8,5), (9,4,5,2,11,3),
    (2,5,10,3,5,2,3,4,5,3,8,4), (5,10,2,5,2,4,4,2,0),
    (3,10,2,3,5,10,3,8,5,4,5,8,0,1,9), (5,10,2,5,2,4,1,9,2,9,4,2),
    (8,4,5,8,5,3,3,5,1), (0,4,5,1,0,5), (8,4,5,8,5,3,9,0,5,0,3,5), (9,4,5),
    (4,11,7,4,9,11,9,10,11), (0,8,3,4,9,7,9,11,7,9,10,11),
    (1,10,11,1,11,4,1,4,0,7,4,11), (3,1,4,3,4,8,1,10,4,7,4,11,10,11,4),
    (4,11,7,9,11,4,9,2,11,9,1,2), (9,7,4,9,11,7,9,1,11,2,11,1,0,8,3),
    (11,7,4,11,4,2,2,4,0), (11,7,4,11,4,2,8,3,4,3,2,4),
    (2,9,10,2,7,9,2,3,7,7,4,9), (9,10,7,9,7,4,10,2,7,8,7,0,2,0,7),
    (3,7,10,3,10,2,7,4,10,1,10,0,4,0,10), (1,10,2,8,7,4), (4,9,1,4,1,7,7,1,3),
    (4,9,1,4,1,7,0,8,1,8,7,1), (4,0,3,7,4,3), (4,8,7), (9,10,8,10,11,8),
    (3,0,9,3,9,11,11,9,10), (0,1,10,0,10,8,8,10,11), (3,1,10,11,3,10),
    (1,2,11,1,11,9,9,11,8), (3,0,9,3,9,11,1,2,9,2,11,9), (0,2,11,8,0,11),
    (3,2,11), (2,3,8,2,8,10,10,8,9), (9,10,2,0,9,2),
    (2,3,8,2,8,10,0,1,8,1,10,8), (1,10,2), (1,3,8,9,1,8), (0,9,1), (0,3,8), (),
)


def _build_tables():
    """Derive all constant tables from the triangle table.

    Corner numbering (reference ``unbatched_mcube_cuda.cu:96-104``,
    mapped to numpy array dims ``(d0, d1, d2)`` — the CUDA kernel's
    ``(x, y, z)`` are dims ``(2, 1, 0)`` of the torch-contiguous grid):
    """
    # corner offsets in (d0, d1, d2); index = CUDA corner id
    corners = np.array([
        [0, 0, 0], [0, 0, 1], [0, 1, 1], [0, 1, 0],
        [1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0]], dtype=np.int32)
    # the 12 cell edges as (corner_from, corner_to) — interpolation runs
    # from `from` to `to` (reference vertlist order, mcube_cuda.cu:421-432)
    edges = np.array([
        [0, 1], [1, 2], [2, 3], [3, 0],
        [4, 5], [5, 6], [6, 7], [7, 4],
        [0, 4], [1, 5], [2, 6], [3, 7]], dtype=np.int32)

    tri = np.full((256, 16), 255, dtype=np.int32)
    for ci, row in enumerate(_TRI_TABLE):
        tri[ci, :len(row)] = row
    ntri = (tri != 255).sum(1) // 3

    # each cell owns edges 6, 7, 11; a cell's vertices are emitted in the
    # order those edges first appear in its triangle list (this derivation
    # reproduces the reference's vertsOrderTable/numPartialVertsTable)
    vorder = np.full((256, 3), 255, dtype=np.int32)
    npart = np.zeros(256, dtype=np.int32)
    # rank[ci, k] = position of owned edge (6, 7, 11)[k] in vorder[ci]
    rank = np.zeros((256, 3), dtype=np.int32)
    owned = (6, 7, 11)
    for ci in range(256):
        seen = []
        for e in tri[ci]:
            if e in owned and e not in seen:
                seen.append(int(e))
        vorder[ci, :len(seen)] = seen
        npart[ci] = len(seen)
        for k, e in enumerate(owned):
            rank[ci, k] = seen.index(e) if e in seen else 0

    # for each original edge id: the neighbour cell that owns it
    # ((d0, d1, d2) delta) and which owned slot it is there
    # (reference find_target_voxel / find_offset, mcube_cuda.cu:213-355)
    nb_delta = np.array([
        [-1, -1, 0],   # e0  -> edge 6 of (y-1, z-1)
        [-1, 0, 1],    # e1  -> edge 7 of (x+1, z-1)
        [-1, 0, 0],    # e2  -> edge 6 of (z-1)
        [-1, 0, 0],    # e3  -> edge 7 of (z-1)
        [0, -1, 0],    # e4  -> edge 6 of (y-1)
        [0, 0, 1],     # e5  -> edge 7 of (x+1)
        [0, 0, 0],     # e6  -> self
        [0, 0, 0],     # e7  -> self
        [0, -1, 0],    # e8  -> edge 11 of (y-1)
        [0, -1, 1],    # e9  -> edge 11 of (x+1, y-1)
        [0, 0, 1],     # e10 -> edge 11 of (x+1)
        [0, 0, 0],     # e11 -> self
    ], dtype=np.int32)
    owned_slot = np.array([0, 1, 0, 1, 0, 1, 0, 1, 2, 2, 2, 2],
                          dtype=np.int32)  # -> index into (6, 7, 11)

    return (corners, edges, tri, ntri, vorder, npart, rank, nb_delta,
            owned_slot)


(_CORNERS, _EDGES, _TRI, _NTRI, _VORDER, _NPART, _RANK, _NB_DELTA,
 _OWNED_SLOT) = _build_tables()


@functools.partial(jax.jit, static_argnames=('max_verts', 'max_faces'))
def unbatched_marching_cubes(grid, iso_value, max_verts, max_faces):
    """Marching cubes over one (pre-padded) scalar grid.

    Args:
        grid: ``(D0, D1, D2)`` float scalar field (callers pad with a
            zero border to close surfaces, as the reference wrapper does).
        iso_value: iso level.
        max_verts / max_faces: static output capacities; surplus
            geometry is dropped (callers size these from the exact
            counts — see :func:`voxelgrids_to_trianglemeshes`).

    Returns:
        (verts (max_verts, 3) float32, faces (max_faces, 3) int32,
        num_verts, num_faces): padded outputs + true counts.  Vertex
        coordinates are in grid units; a vertex on edge ``e`` of cell
        ``c`` interpolates the two corner samples straddling the iso
        level (differentiable w.r.t. ``grid``).
    """
    D0, D1, D2 = grid.shape
    N = D0 * D1 * D2
    grid = grid.astype(jnp.float32)
    # clamped +1 reads (reference sampleVolume clamps at the far border)
    gext = jnp.pad(grid, ((0, 1), (0, 1), (0, 1)), mode='edge')
    fields = jnp.stack(
        [gext[o0:o0 + D0, o1:o1 + D1, o2:o2 + D2].reshape(-1)
         for (o0, o1, o2) in np.asarray(_CORNERS)], axis=-1)  # (N, 8)
    bits = (fields < iso_value).astype(jnp.int32)
    ci = jnp.sum(bits << jnp.arange(8, dtype=jnp.int32)[None], axis=-1)

    npart = jnp.asarray(_NPART)[ci]
    ntri = jnp.asarray(_NTRI)[ci]
    pscan = jnp.cumsum(npart) - npart   # exclusive
    tscan = jnp.cumsum(ntri) - ntri
    num_verts = pscan[-1] + npart[-1]
    num_faces = tscan[-1] + ntri[-1]

    cell = jnp.arange(N, dtype=jnp.int32)
    c0 = cell // (D1 * D2)
    c1 = (cell // D2) % D1
    c2 = cell % D2
    cpos = jnp.stack([c0, c1, c2], axis=-1).astype(jnp.float32)

    # --- vertices: up to 3 owned iso vertices per cell ------------------
    corners_f = jnp.asarray(_CORNERS.astype(np.float32))
    edges_t = jnp.asarray(_EDGES)
    vorder = jnp.asarray(_VORDER)[ci]  # (N, 3)
    verts = jnp.zeros((max_verts, 3), jnp.float32)
    for s in range(3):
        e = vorder[:, s]
        valid = e != 255
        esafe = jnp.where(valid, e, 0)
        a = edges_t[esafe, 0]
        b = edges_t[esafe, 1]
        f0 = jnp.take_along_axis(fields, a[:, None], axis=1)[:, 0]
        f1 = jnp.take_along_axis(fields, b[:, None], axis=1)[:, 0]
        t = (iso_value - f0) / jnp.where(f1 == f0, 1.0, f1 - f0)
        p0 = corners_f[a]
        p1 = corners_f[b]
        pos = cpos + p0 + t[:, None] * (p1 - p0)
        idx = jnp.where(valid, pscan + s, max_verts)
        verts = verts.at[idx].set(pos, mode='drop')

    # --- faces: per cell, triangles in table order ----------------------
    tri_t = jnp.asarray(_TRI)[ci]          # (N, 16)
    rank_t = jnp.asarray(_RANK)
    nbd = jnp.asarray(_NB_DELTA)
    oslot = jnp.asarray(_OWNED_SLOT)
    faces = jnp.zeros((max_faces, 3), jnp.int32)
    for ti in range(5):
        e3 = tri_t[:, 3 * ti:3 * ti + 3]   # (N, 3)
        valid = e3[:, 0] != 255

        def vert_of(e):
            esafe = jnp.where(e == 255, 0, e)
            d = nbd[esafe]                 # (N, 3)
            nb = (jnp.clip(c0 + d[:, 0], 0, D0 - 1) * D1
                  + jnp.clip(c1 + d[:, 1], 0, D1 - 1)) * D2 \
                + jnp.clip(c2 + d[:, 2], 0, D2 - 1)
            ci_nb = ci[nb]
            off = rank_t[ci_nb, oslot[esafe]]
            return pscan[nb] + off

        v0 = vert_of(e3[:, 0])
        v1 = vert_of(e3[:, 1])
        v2 = vert_of(e3[:, 2])
        row = jnp.where(valid, tscan + ti, max_faces)
        # reference emits each face reversed to preserve orientation
        # (mcube_cuda.cu:484-501): columns are (third, second, first)
        tri_out = jnp.stack([v2, v1, v0], axis=-1)
        faces = faces.at[row].set(tri_out, mode='drop')

    return verts, faces, num_verts, num_faces
