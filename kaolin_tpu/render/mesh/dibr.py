"""DIB-R: soft silhouette mask + full differentiable renderer.

Parity: ``kaolin/render/mesh/dibr.py`` + the CUDA kernels
``kaolin/csrc/render/mesh/dibr_soft_mask_cuda.cu`` (reference).

Design (same split as :mod:`rasterization`):

1. **k-buffer selection pass** (non-differentiable): for each uncovered
   pixel, the first ``knum`` faces (in face order, matching the CUDA loop
   ``dibr_soft_mask_cuda.cu:80``) whose *enlarged* bbox covers the pixel.
   Vectorized with a running per-pixel count over face chunks (the
   first-k rule is a cumsum-based scatter — no serial loop).
2. **differentiable epilogue**: for each (pixel, k) recompute the min
   squared distance to the face (3 perpendicular edge distances with the
   "bad triangle" sentinel ``4*multiplier**2`` :135, and 3 vertex
   distances), ``prob = exp(-sigmainv * d / multiplier**2)``, combined as
   ``1 - prod(1 - p)`` :174-182.  JAX autodiff reproduces the reference
   backward (:230-353) through the same branch structure.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from kaolin_tpu.render.mesh.rasterization import (
    _resolve_backend, pixel_coords, rasterize)

__all__ = ['dibr_soft_mask', 'dibr_soft_mask_select',
           'dibr_rasterization']

_EPS = 1e-7  # reference dibr_soft_mask_cuda.cu:23


@functools.partial(jax.jit, static_argnames=(
    'height', 'width', 'knum', 'pixel_chunk'))
def _soft_mask_select(face_bboxes, empty_pixel, xs, ys, height, width, knum,
                      pixel_chunk=4096):
    """First-knum covering faces per pixel (single mesh).

    face_bboxes: (F, 4) enlarged [xmin, ymin, xmax, ymax] (scaled);
    empty_pixel: (H, W) bool.

    One ``top_k`` per pixel block over ALL faces at once: the first-k
    faces in face order (the CUDA loop order, ``dibr_soft_mask_cuda.cu:80``)
    have the k largest keys ``F+1-fid`` among covered faces.  ``lax.map``
    (not vmap) over pixel blocks bounds the (pixel_chunk, F) candidate
    matrix.

    Returns:
        (H, W, knum) int32 face indices, -1 padded.
    """
    F = face_bboxes.shape[0]
    P = height * width
    bboxes = face_bboxes

    ppad = (-P) % pixel_chunk
    pix = jnp.arange(P + ppad)
    px = xs[jnp.minimum(pix % width, width - 1)]
    py = ys[jnp.minimum(pix // width, height - 1)]
    empty = jnp.pad(empty_pixel.reshape(-1), (0, ppad))
    coords = jnp.stack(
        [px, py, empty.astype(px.dtype)], axis=-1
    ).reshape(-1, pixel_chunk, 3)

    fids = jnp.arange(F, dtype=jnp.int32)[None, :]

    def pixel_block(c):
        x0, y0 = c[:, 0:1], c[:, 1:2]  # (pc, 1)
        is_empty = c[:, 2] > 0.5
        covered = ((x0 >= bboxes[:, 0][None]) & (x0 < bboxes[:, 2][None])
                   & (y0 >= bboxes[:, 1][None]) & (y0 < bboxes[:, 3][None]))
        covered = covered & is_empty[:, None]  # (pc, F)
        keys = jnp.where(covered, F + 1 - fids, 0)
        if F < knum:  # top_k needs k <= axis size; pad with invalid keys
            keys = jnp.pad(keys, ((0, 0), (0, knum - F)))
        best, _ = jax.lax.top_k(keys, knum)
        return jnp.where(best > 0, F + 1 - best, -1)

    out = jax.lax.map(pixel_block, coords).reshape(-1, knum)[:P]
    return out.reshape(height, width, knum)


def _face_min_sqdist(fv, x0, y0, multiplier):
    """Min squared distance from pixel (x0, y0) to a 2D triangle.

    fv: (..., 3, 2) scaled face verts; x0/y0 broadcastable to (...).
    Matches ``dibr_soft_mask_cuda.cu:100-149``: 3 perpendicular edge
    distances (sentinel ``4*multiplier**2`` when the projection falls
    outside the segment) and 3 vertex distances.
    """
    dists = []
    sentinel = 4. * multiplier * multiplier
    for i in range(3):
        x1, y1 = fv[..., i, 0], fv[..., i, 1]
        x2, y2 = fv[..., (i + 1) % 3, 0], fv[..., (i + 1) % 3, 1]
        A = y2 - y1
        B = x1 - x2
        C = x2 * y1 - x1 * y2
        up = A * x0 + B * y0 + C
        down = A * A + B * B
        x3 = (B * B * x0 - A * B * y0 - A * C) / (down + _EPS)
        y3 = (A * A * y0 - A * B * x0 - B * C) / (down + _EPS)
        direct = (x3 - x1) * (x3 - x2) + (y3 - y1) * (y3 - y2)
        perp = up * up / (down + _EPS)
        dists.append(jnp.where(direct > 0, sentinel, perp))
    for i in range(3):
        x1, y1 = fv[..., i, 0], fv[..., i, 1]
        dists.append((x0 - x1) ** 2 + (y0 - y1) ** 2)
    return jnp.min(jnp.stack(dists, axis=-1), axis=-1)


def dibr_soft_mask_select(face_vertices_image, selected_face_idx,
                          boxlen=0.02, knum=30, multiplier=1000.):
    """Run only the (non-differentiable) k-buffer selection of the soft
    mask: the first ``knum`` faces whose enlarged bbox covers each empty
    pixel.  Feed the result to :func:`dibr_soft_mask` via ``kbuf=``.

    Returns:
        ``(B, H, W, knum)`` int32 face indices (-1 padded).
    """
    B, H, W = selected_face_idx.shape
    fvi_scaled = face_vertices_image * multiplier
    pts_min = jnp.min(fvi_scaled, axis=-2)
    pts_max = jnp.max(fvi_scaled, axis=-2)
    bboxes = jnp.concatenate([pts_min - boxlen * multiplier,
                              pts_max + boxlen * multiplier], axis=-1)
    xs, ys = pixel_coords(H, W, multiplier,
                          dtype=face_vertices_image.dtype)
    empty = selected_face_idx < 0
    # lax.map (sequential) over batch: one mesh already fills the device
    kbuf = jax.lax.map(
        lambda be: _soft_mask_select(be[0], be[1], xs, ys,
                                     height=H, width=W, knum=knum),
        (jax.lax.stop_gradient(bboxes), empty))
    return jax.lax.stop_gradient(kbuf)


@functools.partial(jax.custom_vjp, nondiff_argnums=(5, 6))
def _soft_mask_epilogue(fvi_scaled, kbuf, empty, xs, ys, sigmainv,
                        multiplier):
    """Differentiable soft-mask epilogue over a fixed k-buffer.

    fvi_scaled: (B, F, 3, 2); kbuf: (B, H, W, K) int32 (-1 padded);
    empty: (B, H, W) bool; xs (W,) / ys (H,) pixel-center coords (scaled)
    — pass a row slice of the full image's ``ys`` to evaluate a row slab
    (the tile-sharded path).  Returns (B, H, W) mask.

    ``custom_vjp``: the autodiff backward of the 6-branch min-distance
    chain materializes dozens of (B, H, W, K) intermediates.  The
    hand-derived backward below — the
    same k1/k2/k3-style algebra as the reference CUDA kernel
    (``dibr_soft_mask_cuda.cu:230-353``) — recomputes the distances in
    one fused elementwise pass, selects the argmin branch with masks,
    and accumulates vertex grads with a single scatter-add.
    """
    prob, _, _ = _soft_mask_prob(fvi_scaled, kbuf, sigmainv, multiplier,
                                 xs, ys)
    allprob = 1. - jnp.prod(1. - prob, axis=-1)
    return jnp.where(empty, allprob, 1.)


def _soft_mask_gather(fvi_scaled, kbuf):
    """Gather per-(pixel, k) face vertices, batch folded into the ids."""
    B, F = fvi_scaled.shape[:2]
    sel = jnp.maximum(kbuf, 0)
    gid = sel + (jnp.arange(B, dtype=sel.dtype)
                 .reshape((B,) + (1,) * (kbuf.ndim - 1))) * F
    return fvi_scaled.reshape(B * F, 3, 2)[gid], gid


def _soft_mask_edge_terms(fv, x0, y0):
    """Line coefficients + perpendicular distances for the 3 edges.

    Returns per-edge tuples (A, B, C, up, down, perp, direct).
    """
    out = []
    for i in range(3):
        x1, y1 = fv[..., i, 0], fv[..., i, 1]
        x2, y2 = fv[..., (i + 1) % 3, 0], fv[..., (i + 1) % 3, 1]
        A = y2 - y1
        B = x1 - x2
        C = x2 * y1 - x1 * y2
        up = A * x0 + B * y0 + C
        down = A * A + B * B
        x3 = (B * B * x0 - A * B * y0 - A * C) / (down + _EPS)
        y3 = (A * A * y0 - A * B * x0 - B * C) / (down + _EPS)
        direct = (x3 - x1) * (x3 - x2) + (y3 - y1) * (y3 - y2)
        perp = up * up / (down + _EPS)
        out.append((A, B, C, up, down, perp, direct))
    return out


def _soft_mask_prob(fvi_scaled, kbuf, sigmainv, multiplier, xs, ys):
    """Per-(pixel, k) influence probability (forward pass core)."""
    x0 = xs[None, None, :, None]
    y0 = ys[None, :, None, None]
    fv, gid = _soft_mask_gather(fvi_scaled, kbuf)  # (B, H, W, K, 3, 2)
    sentinel = 4. * multiplier * multiplier
    edges = _soft_mask_edge_terms(fv, x0, y0)
    dists = [jnp.where(e[6] > 0, sentinel, e[5]) for e in edges]
    for i in range(3):
        x1, y1 = fv[..., i, 0], fv[..., i, 1]
        dists.append((x0 - x1) ** 2 + (y0 - y1) ** 2)
    dall = jnp.stack(dists, axis=-1)  # (B, H, W, K, 6)
    d = jnp.min(dall, axis=-1)
    branch = jnp.argmin(dall, axis=-1).astype(jnp.int32)
    z = (sigmainv / (multiplier * multiplier)) * d
    prob = jnp.where(kbuf >= 0, jnp.exp(-z), 0.)
    return prob, branch, gid


def _soft_mask_epilogue_fwd(fvi_scaled, kbuf, empty, xs, ys, sigmainv,
                            multiplier):
    mask = _soft_mask_epilogue(fvi_scaled, kbuf, empty, xs, ys, sigmainv,
                               multiplier)
    return mask, (fvi_scaled, kbuf, empty, xs, ys)


def _soft_mask_epilogue_bwd(sigmainv, multiplier, res, g):
    fvi_scaled, kbuf, empty, xs, ys = res
    B, F = fvi_scaled.shape[:2]
    x0 = xs[None, None, :, None]
    y0 = ys[None, :, None, None]

    prob, branch, gid = _soft_mask_prob(fvi_scaled, kbuf, sigmainv,
                                        multiplier, xs, ys)
    fv, _ = _soft_mask_gather(fvi_scaled, kbuf)

    # dL/dprob_k = g * prod_{j != k}(1 - p_j), via exclusive cumprods
    # (exact — no (1-allprob)/(1-p_k) EPS division as in the CUDA kernel,
    # whose backward is approximate when p_k -> 1).
    one_minus = 1. - prob
    left = jnp.concatenate(
        [jnp.ones_like(one_minus[..., :1]),
         jnp.cumprod(one_minus[..., :-1], axis=-1)], axis=-1)
    right = jnp.concatenate(
        [jnp.cumprod(one_minus[..., :0:-1], axis=-1)[..., ::-1],
         jnp.ones_like(one_minus[..., :1])], axis=-1)
    excl = left * right
    g_eff = jnp.where(empty, g, 0.)
    dprob = g_eff[..., None] * excl
    inv = sigmainv / (multiplier * multiplier)
    # prob = exp(-inv * d) -> dL/dd = -inv * prob * dL/dprob
    dd = jnp.where(kbuf >= 0, -inv * prob * dprob, 0.)  # (B, H, W, K)

    # accumulate the 6 coordinate grads as flat (B, H, W, K) components
    # for one (N, 6) row scatter
    comp = [jnp.zeros_like(dd) for _ in range(6)]  # x0,y0,x1,y1,x2,y2
    edges = _soft_mask_edge_terms(fv, x0, y0)
    for e in range(3):
        A, Bc, C, up, down, perp, direct = edges[e]
        on = (branch == e) & (direct <= 0)
        w = jnp.where(on, dd, 0.)
        dA = 2. * (up * x0 - perp * A) / (down + _EPS)
        dB = 2. * (up * y0 - perp * Bc) / (down + _EPS)
        dC = 2. * up / (down + _EPS)
        x1, y1 = fv[..., e, 0], fv[..., e, 1]
        x2, y2 = fv[..., (e + 1) % 3, 0], fv[..., (e + 1) % 3, 1]
        j = (e + 1) % 3
        comp[2 * e] = comp[2 * e] + w * (dB - dC * y2)
        comp[2 * e + 1] = comp[2 * e + 1] + w * (dC * x2 - dA)
        comp[2 * j] = comp[2 * j] + w * (dC * y1 - dB)
        comp[2 * j + 1] = comp[2 * j + 1] + w * (dA - dC * x1)
    for v in range(3):
        on = branch == (3 + v)
        w = jnp.where(on, dd, 0.)
        x1, y1 = fv[..., v, 0], fv[..., v, 1]
        comp[2 * v] = comp[2 * v] + w * 2. * (x1 - x0)
        comp[2 * v + 1] = comp[2 * v + 1] + w * 2. * (y1 - y0)

    grad_rows = jnp.stack([c.reshape(-1) for c in comp], axis=-1)  # (N, 6)
    dfvi = jnp.zeros((B * F, 6), fvi_scaled.dtype)
    dfvi = dfvi.at[gid.reshape(-1)].add(grad_rows).reshape(B, F, 3, 2)
    return (dfvi,
            np.zeros(kbuf.shape, jax.dtypes.float0),
            np.zeros(empty.shape, jax.dtypes.float0),
            jnp.zeros_like(xs), jnp.zeros_like(ys))


_soft_mask_epilogue.defvjp(_soft_mask_epilogue_fwd, _soft_mask_epilogue_bwd)


def dibr_soft_mask(face_vertices_image, selected_face_idx, sigmainv=7000,
                   boxlen=0.02, knum=30, multiplier=1000., kbuf=None):
    """Differentiable soft silhouette mask.

    Parity: ``kaolin/render/mesh/dibr.py:75``.

    Args:
        face_vertices_image: ``(B, F, 3, 2)`` image-plane positions in
            [-1, 1].
        selected_face_idx: ``(B, H, W)`` winning face per pixel (-1 = empty),
            from :func:`kaolin_tpu.render.mesh.rasterize`.
        sigmainv: sharpness (higher = sharper).
        boxlen: influence margin around each face bbox.
        knum: max faces influencing one pixel.
        multiplier: internal coordinate scale.
        kbuf: precomputed selection — either the ``(B, H, W, knum)``
            k-buffer from :func:`dibr_soft_mask_select`, or a
            :class:`~kaolin_tpu.render.mesh._fused.FusedSelection` from
            the fused engine (uncapped product; ``knum`` ignored).

    Returns:
        ``(B, H, W)`` soft mask in [0, 1].
    """
    B, H, W = selected_face_idx.shape
    fvi_scaled = face_vertices_image * multiplier
    empty = selected_face_idx < 0

    from kaolin_tpu.render.mesh._fused import FusedSelection, softmask_fused
    if isinstance(kbuf, FusedSelection):
        return softmask_fused(fvi_scaled, kbuf,
                              (H, W, float(multiplier), float(sigmainv)))

    if kbuf is None:
        kbuf = dibr_soft_mask_select(face_vertices_image,
                                     selected_face_idx, boxlen, knum,
                                     multiplier)
    kbuf = jax.lax.stop_gradient(kbuf)  # (B, H, W, knum)

    xs, ys = pixel_coords(H, W, multiplier,
                          dtype=face_vertices_image.dtype)
    return _soft_mask_epilogue(fvi_scaled, kbuf, empty, xs, ys,
                               float(sigmainv), float(multiplier))


def dibr_rasterization(height, width, face_vertices_z, face_vertices_image,
                       face_features, face_normals_z, sigmainv=7000,
                       boxlen=0.02, knum=30, multiplier=None, eps=None,
                       rast_backend='auto'):
    """Full DIB-R differentiable renderer: rasterize with backface culling
    (``face_normals_z >= 0``) + soft mask.

    Parity: ``kaolin/render/mesh/dibr.py:119``.

    Returns:
        (image_features, soft_mask, face_idx).
    """
    _multiplier = 1000. if multiplier is None else multiplier
    backend = _resolve_backend(rast_backend)
    if backend == 'fused':
        # one fused selection pass yields BOTH the z-buffer winner and the
        # soft-mask product — the epilogues reuse it
        from kaolin_tpu.render.mesh._fused import fused_selection
        sel = fused_selection(
            face_vertices_z, face_vertices_image, face_normals_z >= 0.,
            height, width, _multiplier, boxlen=boxlen, sigmainv=sigmainv,
            eps=1e-8 if eps is None else eps)
        interpolated_features, face_idx = rasterize(
            height, width, face_vertices_z, face_vertices_image,
            face_features, multiplier=multiplier, eps=eps,
            precomputed_face_idx=sel.face_idx)
        soft_mask = dibr_soft_mask(face_vertices_image, face_idx, sigmainv,
                                   boxlen, knum, _multiplier, kbuf=sel)
        return interpolated_features, soft_mask, face_idx
    interpolated_features, face_idx = rasterize(
        height, width, face_vertices_z, face_vertices_image, face_features,
        face_normals_z >= 0., multiplier, eps, backend)
    soft_mask = dibr_soft_mask(face_vertices_image, face_idx, sigmainv,
                               boxlen, knum, _multiplier)
    return interpolated_features, soft_mask, face_idx
