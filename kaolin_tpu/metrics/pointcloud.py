"""Pointcloud metrics: sided distance, chamfer, f-score.

Parity: ``kaolin/metrics/pointcloud.py`` (reference).

Design: the CUDA brute-force kernel with shared-memory tiling
(``csrc/metrics/sided_distance_cuda.cu:53``) becomes a chunked ``(P1, P2)``
pairwise-distance sweep.  The min/argmin selection is non-differentiable; the
distance is recomputed differentiably on the selected pairs so the backward
is O(P1) gathers + scatter (matching the reference's analytic backward
:204-242) rather than O(P1*P2).
"""

import jax
import jax.numpy as jnp

__all__ = ['sided_distance', 'chamfer_distance', 'f_score']


def _sided_min_chunked(p1, p2, chunk_size):
    """(P1,) min sq-dist and argmin over p2; p1 (P1,3), p2 (P2,3)."""
    P1 = p1.shape[0]
    pad = (-P1) % chunk_size
    p1p = jnp.pad(p1, ((0, pad), (0, 0)))

    def chunk_fn(c):  # (chunk, 3)
        d = jnp.sum((c[:, None, :] - p2[None, :, :]) ** 2, axis=-1)
        return jnp.min(d, axis=1), jnp.argmin(d, axis=1)

    dists, idxs = jax.lax.map(chunk_fn, p1p.reshape(-1, chunk_size, 3))
    return dists.reshape(-1)[:P1], idxs.reshape(-1)[:P1]


def sided_distance(p1, p2, chunk_size=4096):
    """For each point of p1, squared distance and index of the closest
    point of p2.

    Parity: ``kaolin/metrics/pointcloud.py:52``.

    Args:
        p1: ``(B, P1, 3)``.
        p2: ``(B, P2, 3)``.

    Returns:
        (dist ``(B, P1)``, idx ``(B, P1)``), dist differentiable.
    """
    if p1.ndim != 3 or p2.ndim != 3:
        raise ValueError("p1 and p2 must be (B, N, 3)")
    _, idx = jax.vmap(
        lambda a, b: _sided_min_chunked(a, b, chunk_size))(
            jax.lax.stop_gradient(p1), jax.lax.stop_gradient(p2))
    closest = jnp.take_along_axis(p2, idx[..., None], axis=1)  # (B, P1, 3)
    dist = jnp.sum((p1 - closest) ** 2, axis=-1)
    return dist, idx


def chamfer_distance(p1, p2, w1=1., w2=1., squared=True, chunk_size=4096):
    """Chamfer distance between two batched pointclouds.

    Parity: ``kaolin/metrics/pointcloud.py:89``.

    Returns:
        ``(B,)`` distances.

    Example:
        >>> import jax.numpy as jnp
        >>> p1 = jnp.array([[[0., 0., 0.], [1., 0., 0.]]])
        >>> p2 = jnp.array([[[0., 0., 1.]]])
        >>> chamfer_distance(p1, p2).tolist()
        [2.5]
    """
    sdist1 = sided_distance(p1, p2, chunk_size)[0]
    sdist2 = sided_distance(p2, p1, chunk_size)[0]
    if not squared:
        sdist1 = jnp.sqrt(sdist1)
        sdist2 = jnp.sqrt(sdist2)
    return w1 * jnp.mean(sdist1, axis=-1) + w2 * jnp.mean(sdist2, axis=-1)


def f_score(gt_points, pred_points, radius=0.01, eps=1e-8, chunk_size=4096):
    """F-score of two point sets with a hit radius.

    Parity: ``kaolin/metrics/pointcloud.py:138``.

    Returns:
        ``(B,)`` f-scores.
    """
    pred_distances = jnp.sqrt(
        sided_distance(gt_points, pred_points, chunk_size)[0])
    gt_distances = jnp.sqrt(
        sided_distance(pred_points, gt_points, chunk_size)[0])
    dtype = pred_points.dtype
    fn = jnp.sum(pred_distances > radius, axis=1).astype(dtype)
    fp = jnp.sum(gt_distances > radius, axis=1).astype(dtype)
    tp = (gt_distances.shape[1] - fp).astype(dtype)
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    return 2 * (precision * recall) / (precision + recall + eps)
