"""Differentiable z-buffer triangle rasterization (DIB-R).

Parity: ``kaolin/render/mesh/rasterization.py`` + the CUDA kernels
``kaolin/csrc/render/mesh/rasterization_cuda.cu:43-442`` (reference).

Design
------
The reference pairs a forward CUDA kernel (per-pixel loop over faces with a
z-buffer) with a hand-derived analytic backward (k1/k2/k3 determinant
algebra, atomics for the feature grads).  Here rasterization is split into:

1. a **non-differentiable selection pass** computing the winning face per
   pixel (the z-buffer argmax — piecewise constant, so it carries no
   gradient).  Backends: ``'jnp'`` (chunked brute force, runs anywhere) and
   ``'fused'`` (tile-binned Pallas kernels for the GPU, :mod:`._fused`).
2. a **differentiable epilogue**: gather the selected face per pixel,
   recompute the normalized barycentric weights with the same
   ``copysign(eps)`` rule (``rasterization_cuda.cu:141-142``), and
   interpolate features.  JAX autodiff of this epilogue reproduces the
   reference backward exactly (the k1/k2/k3 algebra *is* the derivative of
   this epilogue), with scatter-adds instead of atomics — race-free and
   O(pixels), not O(pixels x faces).

Pixel-center convention (must match ``rasterization_cuda.cu:85-86``):
``x0 = mult/W * (2*wi + 1 - W)``, ``y0 = mult/H * (H - 2*hi - 1)`` — image
coords in [-1, 1] with y up and row 0 at the top.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp

__all__ = ['rasterize', 'rasterize_selection']


def _resolve_backend(backend):
    """'auto' -> the fused kernels on a GPU, the 'jnp' path elsewhere."""
    if backend == 'auto':
        return 'fused' if jax.default_backend() == 'gpu' else 'jnp'
    return backend


def pixel_coords(height, width, multiplier, dtype=jnp.float32):
    """Pixel-center coordinates: xs (W,), ys (H,)."""
    xs = (multiplier / width) * (
        2 * jnp.arange(width, dtype=dtype) + 1 - width)
    ys = (multiplier / height) * (
        height - 2 * jnp.arange(height, dtype=dtype) - 1)
    return xs, ys


def _bary_weights_pairwise(fvi, x0, y0, eps):
    """Normalized barycentric weights for pixels x faces.

    fvi: (F, 3, 2); x0/y0: (P,).  Returns w0, w1, w2 each (P, F).
    """
    ax, ay = fvi[:, 0, 0], fvi[:, 0, 1]  # (F,)
    bx, by = fvi[:, 1, 0], fvi[:, 1, 1]
    cx, cy = fvi[:, 2, 0], fvi[:, 2, 1]
    x0 = x0[:, None]
    y0 = y0[:, None]
    a_ex = ax[None] - x0
    a_ey = ay[None] - y0
    b_ex = bx[None] - x0
    b_ey = by[None] - y0
    c_ex = cx[None] - x0
    c_ey = cy[None] - y0
    w0 = b_ex * c_ey - b_ey * c_ex
    w1 = c_ex * a_ey - c_ey * a_ex
    w2 = a_ex * b_ey - a_ey * b_ex
    norm = w0 + w1 + w2
    norm = norm + jnp.copysign(eps, norm)
    return w0 / norm, w1 / norm, w2 / norm


def _bary_weights_gathered(fv, x0, y0, eps):
    """Weights for one face per pixel.  fv: (..., 3, 2); x0/y0: (...)."""
    a_ex = fv[..., 0, 0] - x0
    a_ey = fv[..., 0, 1] - y0
    b_ex = fv[..., 1, 0] - x0
    b_ey = fv[..., 1, 1] - y0
    c_ex = fv[..., 2, 0] - x0
    c_ey = fv[..., 2, 1] - y0
    w0 = b_ex * c_ey - b_ey * c_ex
    w1 = c_ex * a_ey - c_ey * a_ex
    w2 = a_ex * b_ey - a_ey * b_ex
    norm = w0 + w1 + w2
    norm = norm + jnp.copysign(eps, norm)
    return w0 / norm, w1 / norm, w2 / norm


@functools.partial(jax.jit, static_argnames=(
    'height', 'width', 'eps', 'pixel_chunk', 'face_chunk'))
def _selection_jnp(face_vertices_z, face_vertices_image_scaled, valid_faces,
                   xs, ys, height, width, eps,
                   pixel_chunk=8192, face_chunk=1024):
    """Z-buffer winning-face selection (single mesh).

    Args:
        face_vertices_z: (F, 3); face_vertices_image_scaled: (F, 3, 2)
        (multiplier applied); valid_faces: (F,) bool; xs (W,), ys (H,).

    Returns:
        (H, W) int32 face index, -1 where empty.
    """
    F = face_vertices_z.shape[0]
    P = height * width
    fpad = (-F) % face_chunk
    fvz = jnp.pad(face_vertices_z, ((0, fpad), (0, 0)))
    fvi = jnp.pad(face_vertices_image_scaled, ((0, fpad), (0, 0), (0, 0)))
    valid = jnp.pad(valid_faces, (0, fpad))
    num_fchunks = (F + fpad) // face_chunk

    ppad = (-P) % pixel_chunk
    pix = jnp.arange(P + ppad)
    px = xs[jnp.minimum(pix % width, width - 1)]
    py = ys[jnp.minimum(pix // width, height - 1)]
    coords = jnp.stack([px, py], axis=-1).reshape(-1, pixel_chunk, 2)

    neg_inf = jnp.asarray(-jnp.inf, dtype=face_vertices_z.dtype)

    def pixel_block(c):
        x0, y0 = c[:, 0], c[:, 1]

        def face_step(i, carry):
            best_z, best_idx = carry
            lo = i * face_chunk
            fvz_c = jax.lax.dynamic_slice_in_dim(fvz, lo, face_chunk)
            fvi_c = jax.lax.dynamic_slice_in_dim(fvi, lo, face_chunk)
            valid_c = jax.lax.dynamic_slice_in_dim(valid, lo, face_chunk)
            w0, w1, w2 = _bary_weights_pairwise(fvi_c, x0, y0, eps)
            z0 = (w0 * fvz_c[None, :, 0] + w1 * fvz_c[None, :, 1]
                  + w2 * fvz_c[None, :, 2])
            ok = (w0 >= 0.) & (w1 >= 0.) & (w2 >= 0.) & valid_c[None, :]
            z0 = jnp.where(ok, z0, neg_inf)
            chunk_best = jnp.max(z0, axis=1)
            chunk_idx = jnp.argmax(z0, axis=1).astype(jnp.int32) + lo
            # strict > keeps the first (lowest-index) face on ties,
            # matching the ascending-order CUDA loop
            upd = chunk_best > best_z
            return (jnp.where(upd, chunk_best, best_z),
                    jnp.where(upd, chunk_idx, best_idx))

        init = (jnp.full(x0.shape, neg_inf),
                jnp.full(x0.shape, -1, dtype=jnp.int32))
        best_z, best_idx = jax.lax.fori_loop(0, num_fchunks, face_step, init)
        return jnp.where(best_z > neg_inf, best_idx, -1)

    out = jax.lax.map(pixel_block, coords).reshape(-1)[:P]
    return out.reshape(height, width)


def _interpolate_selected(face_idx, face_vertices_image_scaled, face_features,
                          xs, ys, eps):
    """Differentiable epilogue (single mesh): gather + weights + lerp.

    face_idx: (H, W) int32; fvi: (F, 3, 2) scaled; features (F, 3, C).

    Returns:
        (image_features (H, W, C), weights (H, W, 3)).
    """
    feats, weights = _interpolate_selected_batched(
        face_idx[None], face_vertices_image_scaled[None],
        face_features[None], xs, ys, eps)
    return feats[0], weights[0]


def _interpolate_selected_batched(face_idx, face_vertices_image_scaled,
                                  face_features, xs, ys, eps):
    """Batched differentiable epilogue with flat row gathers.

    The batch dim is folded into the gather index; the barycentric math is
    identical to the unbatched version op for op.

    face_idx: (B, H, W) int32; fvi: (B, F, 3, 2); features (B, F, 3, C).

    Returns:
        (image_features (B, H, W, C), weights (B, H, W, 3)).
    """
    from kaolin_tpu.ops.gather import flat_index, gather_rows
    B, F = face_vertices_image_scaled.shape[:2]
    H, W = face_idx.shape[1:]
    C = face_features.shape[-1]
    covered = (face_idx >= 0).reshape(-1)              # (B*H*W,)
    gidx = flat_index(jnp.maximum(face_idx, 0), F)
    # single combined gather: one scatter pass over the face table in the
    # backward instead of two
    combined = jnp.concatenate(
        [face_vertices_image_scaled.reshape(B * F, 6),
         face_features.reshape(B * F, 3 * C)], axis=-1)
    rows = gather_rows(combined, gidx)                 # (P, 6 + 3C)
    fv = rows[:, :6].reshape(-1, 3, 2)                 # (P, 3, 2)
    ff = rows[:, 6:].reshape(-1, 3, C)                 # (P, 3, C)
    x0 = jnp.tile(jnp.tile(xs[None, :], (H, 1)).reshape(-1), B)
    y0 = jnp.tile(jnp.tile(ys[:, None], (1, W)).reshape(-1), B)
    w0, w1, w2 = _bary_weights_gathered(fv, x0, y0, eps)
    weights = jnp.stack([w0, w1, w2], axis=-1)         # (P, 3)
    weights = jnp.where(covered[..., None], weights, 0.)
    feats = (weights[..., 0:1] * ff[..., 0, :]
             + weights[..., 1:2] * ff[..., 1, :]
             + weights[..., 2:3] * ff[..., 2, :])
    return (feats.reshape(B, H, W, C), weights.reshape(B, H, W, 3))


def rasterize_selection(height, width, face_vertices_z, face_vertices_image,
                        valid_faces=None, multiplier=None, eps=None,
                        backend='auto'):
    """Run only the (non-differentiable) z-buffer selection pass.

    Useful to keep the selection in its own compiled program (its
    pixel x face sweep dominates compile and run time) and feed the
    result back into :func:`rasterize` via ``precomputed_face_idx``.

    Returns:
        ``(B, H, W)`` int32 winning-face indices (-1 = background).
    """
    if multiplier is None:
        multiplier = 1000
    if eps is None:
        eps = 1e-8
    B, F = face_vertices_z.shape[:2]
    if valid_faces is None:
        valid_faces = jnp.ones((B, F), dtype=bool)
    backend = _resolve_backend(backend)
    fvi_scaled = face_vertices_image * multiplier
    xs, ys = pixel_coords(height, width, multiplier,
                          dtype=face_vertices_z.dtype)
    if backend == 'jnp':
        # lax.map (sequential) over batch: one mesh's pixel x face sweep
        # already fills the device
        face_idx = jax.lax.map(
            lambda ziv: _selection_jnp(ziv[0], ziv[1], ziv[2], xs, ys,
                                       height=height, width=width, eps=eps),
            (jax.lax.stop_gradient(face_vertices_z),
             jax.lax.stop_gradient(fvi_scaled), valid_faces))
    elif backend == 'fused':
        from kaolin_tpu.render.mesh._fused import fused_selection
        face_idx = fused_selection(
            face_vertices_z, face_vertices_image, valid_faces,
            height, width, float(multiplier), eps=eps,
            with_softmask=False).face_idx
    else:
        raise ValueError(f'"{backend}" is not a valid backend, '
                         'valid choices are ["jnp", "fused", "auto"]')
    return jax.lax.stop_gradient(face_idx)


def rasterize(height, width, face_vertices_z, face_vertices_image,
              face_features, valid_faces=None, multiplier=None, eps=None,
              backend='auto', with_weights=False,
              precomputed_face_idx=None):
    """Differentiable rasterization of triangle meshes to feature images.

    Parity: ``kaolin/render/mesh/rasterization.py:390`` (the 'cuda' backend;
    the OpenGL-based 'nvdiffrast' backends are replaced by 'fused'/'jnp').

    Args:
        height, width: output image size.
        face_vertices_z: ``(B, F, 3)`` camera-space z of face vertices
            (camera looks down -z: larger z = closer).
        face_vertices_image: ``(B, F, 3, 2)`` image-plane positions in
            [-1, 1] (y up).
        face_features: ``(B, F, 3, C)`` per-face-vertex features, or a list
            of such (concatenated and re-split, as in the reference).
        valid_faces: optional ``(B, F)`` bool mask.
        multiplier: coordinate scale to avoid numeric issues (default 1000).
        eps: barycentric normalization epsilon (default 1e-8).
        backend: 'jnp', 'fused', or 'auto' (fused on GPU else jnp).
        with_weights: also return the per-pixel barycentric weights.

    Returns:
        (image_features ``(B, H, W, C)`` [or tuple], face_idx
        ``(B, H, W)`` int32 with -1 for background[, weights
        ``(B, H, W, 3)``]).
    """
    if multiplier is None:
        multiplier = 1000
    if eps is None:
        eps = 1e-8
    is_list = isinstance(face_features, (list, tuple))
    features = (jnp.concatenate(face_features, axis=-1) if is_list
                else face_features)

    fvi_scaled = face_vertices_image * multiplier
    xs, ys = pixel_coords(height, width, multiplier,
                          dtype=face_vertices_z.dtype)

    if precomputed_face_idx is not None:
        face_idx = jax.lax.stop_gradient(precomputed_face_idx)
    else:
        face_idx = rasterize_selection(
            height, width, face_vertices_z, face_vertices_image,
            valid_faces, multiplier, eps, backend)

    image_features, weights = _interpolate_selected_batched(
        face_idx, fvi_scaled, features, xs, ys, eps)

    if is_list:
        out = []
        cur = 0
        for f in face_features:
            out.append(image_features[..., cur:cur + f.shape[-1]])
            cur += f.shape[-1]
        image_features = tuple(out)
    if with_weights:
        return image_features, face_idx, weights
    return image_features, face_idx
