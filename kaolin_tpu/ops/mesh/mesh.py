"""Generic mesh ops: indexing, adjacency, laplacian, vertex normals.

Parity: ``kaolin/ops/mesh/mesh.py`` (reference).  Scatter-adds replace CUDA
``scatter_add_`` (race-free in XLA); the sparse adjacency is a
``jax.experimental.sparse.BCOO``.
"""

import numpy as np
import jax.numpy as jnp
from jax.experimental import sparse as jsparse

__all__ = [
    'index_vertices_by_faces',
    'adjacency_matrix',
    'uniform_laplacian',
    'compute_vertex_normals',
]


def index_vertices_by_faces(vertices_features, faces):
    """Gather per-vertex features into per-face-corner features.

    Parity: ``kaolin/ops/mesh/mesh.py:25``.

    Args:
        vertices_features: ``(B, V, D)`` per-vertex features.
        faces: ``(F, face_size)`` int vertex indices.

    Returns:
        ``(B, F, face_size, D)`` gathered features.
    """
    if vertices_features.ndim != 3:
        raise ValueError(
            f"vertices_features must be (B, V, D), got {vertices_features.shape}")
    # flat row gather (kaolin_tpu/ops/gather.py)
    from kaolin_tpu.ops.gather import flat_index, gather_rows
    B, V, D = vertices_features.shape
    faces = jnp.asarray(faces)
    F, S = faces.shape
    gidx = flat_index(jnp.broadcast_to(faces.reshape(-1)[None], (B, F * S)),
                      V)
    rows = gather_rows(vertices_features.reshape(B * V, D), gidx)
    return rows.reshape(B, F, S, D)


def _unique_edges(faces):
    """All directed edges (i->j and j->i) of the faces, deduplicated (host)."""
    faces = np.asarray(faces)
    fwd = np.stack([faces, np.roll(faces, 1, axis=-1)], axis=-1)
    bwd = np.stack([np.roll(faces, 1, axis=-1), faces], axis=-1)
    idx = np.concatenate([fwd, bwd], axis=1).reshape(-1, 2)
    return np.unique(idx, axis=0)


def adjacency_matrix(num_vertices, faces, sparse=True):
    """Vertex adjacency matrix of a mesh.

    Parity: ``kaolin/ops/mesh/mesh.py:49``.  ``sparse=True`` returns a BCOO
    sparse array; ``sparse=False`` a dense ``(V, V)`` float array.
    """
    indices = _unique_edges(faces)
    if sparse:
        values = jnp.ones(indices.shape[0], dtype=jnp.float32)
        return jsparse.BCOO((values, jnp.asarray(indices)),
                            shape=(num_vertices, num_vertices))
    adj = jnp.zeros((num_vertices, num_vertices), dtype=jnp.float32)
    return adj.at[indices[:, 0], indices[:, 1]].set(1.)


def uniform_laplacian(num_vertices, faces):
    """Uniform (combinatorial) Laplacian: ``L = A / deg - I``.

    Parity: ``kaolin/ops/mesh/mesh.py:87``.  Rows of isolated vertices are 0
    (matching the reference's nan→0 replacement).
    """
    indices = _unique_edges(faces)
    deg = np.zeros(num_vertices, dtype=np.float32)
    np.add.at(deg, indices[:, 0], 1.)
    L = np.zeros((num_vertices, num_vertices), dtype=np.float32)
    safe_deg = np.where(deg > 0, deg, 1.)
    L[indices[:, 0], indices[:, 1]] = 1. / safe_deg[indices[:, 0]]
    L -= np.diag((deg > 0).astype(np.float32))
    return jnp.asarray(L)


def compute_vertex_normals(faces, face_normals, num_vertices=None):
    """Average per-face-corner normals onto vertices.

    Parity: ``kaolin/ops/mesh/mesh.py:125``.

    Args:
        faces: ``(F, face_size)`` int indices.
        face_normals: ``(B, F, face_size, 3)`` pre-normalized normals.
        num_vertices: V (defaults to ``faces.max() + 1``).

    Returns:
        ``(B, V, 3)`` averaged (not re-normalized) vertex normals.
    """
    faces = jnp.asarray(faces)
    if num_vertices is None:
        num_vertices = int(np.asarray(faces).max()) + 1
    B = face_normals.shape[0]
    flat_idx = faces.reshape(-1)  # (F * FSz,)
    flat_normals = face_normals.reshape(B, -1, 3)
    vertex_normals = jnp.zeros((B, num_vertices, 3), dtype=face_normals.dtype)
    vertex_normals = vertex_normals.at[:, flat_idx].add(flat_normals)
    counts = jnp.zeros((num_vertices,), dtype=face_normals.dtype)
    counts = counts.at[flat_idx].add(1.)
    counts = jnp.clip(counts, min=1.)
    return vertex_normals / counts[None, :, None]
