"""Render utilities: texture mapping, SH lighting (legacy), vertex prep.

Parity: ``kaolin/render/mesh/utils.py`` (reference).
"""

import jax
import jax.numpy as jnp

from kaolin_tpu.render import camera as _camera
from kaolin_tpu.ops import mesh as _mesh_ops
from kaolin_tpu.ops.gather import gather_rows

__all__ = ['texture_mapping', 'spherical_harmonic_lighting',
           'prepare_vertices']


def _flat_corner_idx(x, y, H, W, B, P):
    """Clipped corner indices + lerp weights for bilinear sampling.

    x, y: (B*P,) continuous pixel coords.  Returns flat row ids into the
    (B*H*W, C) channels-last texture table plus (wx, wy).
    """
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    wx = x - x0
    wy = y - y0
    x0i = jnp.clip(x0.astype(jnp.int32), 0, W - 1)
    x1i = jnp.clip(x0.astype(jnp.int32) + 1, 0, W - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, H - 1)
    y1i = jnp.clip(y0.astype(jnp.int32) + 1, 0, H - 1)
    boff = jnp.repeat(jnp.arange(B, dtype=jnp.int32) * (H * W), P)
    i00 = boff + y0i * W + x0i
    i01 = boff + y0i * W + x1i
    i10 = boff + y1i * W + x0i
    i11 = boff + y1i * W + x1i
    return (i00, i01, i10, i11), wx, wy


def _bilinear_sample(tex_rows, x, y, hw):
    """Bilinear sample of a channels-last texture table.

    tex_rows: (B*H*W, C); x, y: (B*P,) pixel coords (border-padded via
    index clipping, align_corners=False unnormalization done by caller).
    ``hw`` = (H, W, B, P) static.  Autodiff gives the texture gradient as
    scatter-adds of the four taps.
    """
    H, W, B, P = hw
    (i00, i01, i10, i11), wx, wy = _flat_corner_idx(x, y, H, W, B, P)
    wx = wx[:, None]
    wy = wy[:, None]
    return (tex_rows[i00] * (1 - wx) * (1 - wy)
            + tex_rows[i01] * wx * (1 - wy)
            + tex_rows[i10] * (1 - wx) * wy
            + tex_rows[i11] * wx * wy)


def _grid_sample_2d(image, coords_x, coords_y, mode='bilinear'):
    """Sample image (C, H, W) at continuous pixel coords (torch
    grid_sample convention, align_corners=False, padding_mode='border').

    coords are in [-1, 1]; -1 maps to pixel-edge -0.5, +1 to H-0.5.
    """
    C, H, W = image.shape
    # unnormalize (align_corners=False): x_pix = (x + 1) * W / 2 - 0.5
    x = (coords_x + 1.) * W / 2. - 0.5
    y = (coords_y + 1.) * H / 2. - 0.5
    if mode == 'nearest':
        # torch rounds half away... uses floor(x + 0.5) semantics
        xi = jnp.clip(jnp.floor(x + 0.5).astype(jnp.int32), 0, W - 1)
        yi = jnp.clip(jnp.floor(y + 0.5).astype(jnp.int32), 0, H - 1)
        rows = gather_rows(
            image.transpose(1, 2, 0).reshape(H * W, C),
            (yi * W + xi).reshape(-1))
        return jnp.moveaxis(rows.reshape(xi.shape + (C,)), -1, 0)
    elif mode == 'bilinear':
        P = x.size
        out = _bilinear_sample(
            image.transpose(1, 2, 0).reshape(H * W, C),
            x.reshape(-1), y.reshape(-1), (H, W, 1, P))
        return jnp.moveaxis(out.reshape(x.shape + (C,)), -1, 0)
    raise ValueError(f"unsupported mode {mode!r}")


def texture_mapping(texture_coordinates, texture_maps, mode='nearest'):
    """Sample texture maps at (OpenGL-convention) uv coordinates.

    Parity: ``kaolin/render/mesh/utils.py:23``: uvs in [0, 1] are clamped,
    y flipped (OpenGL bottom-up -> image top-down), then sampled with
    border padding and align_corners=False.

    Args:
        texture_coordinates: ``(B, h, w, 2)`` or ``(B, N, 2)`` uvs in [0,1].
        texture_maps: ``(B, C, h', w')``.
        mode: 'nearest' or 'bilinear'.

    Returns:
        ``(B, h, w, C)`` or ``(B, N, C)`` sampled features.
    """
    batch_size = texture_coordinates.shape[0]
    num_channels = texture_maps.shape[1]
    TH, TW = texture_maps.shape[2:]
    lead_shape = texture_coordinates.shape[1:-1]
    uv = texture_coordinates.reshape(batch_size, -1, 2)
    P = uv.shape[1]
    uv = jnp.clip(uv, 0., 1.)
    uv = uv * 2. - 1.
    cx = uv[..., 0].reshape(-1)
    cy = -uv[..., 1].reshape(-1)  # flip y

    # unnormalize (align_corners=False); batch folded into flat row ids
    x = (cx + 1.) * TW / 2. - 0.5
    y = (cy + 1.) * TH / 2. - 0.5
    tex_rows = texture_maps.transpose(0, 2, 3, 1).reshape(
        batch_size * TH * TW, num_channels)
    if mode == 'nearest':
        xi = jnp.clip(jnp.floor(x + 0.5).astype(jnp.int32), 0, TW - 1)
        yi = jnp.clip(jnp.floor(y + 0.5).astype(jnp.int32), 0, TH - 1)
        boff = jnp.repeat(
            jnp.arange(batch_size, dtype=jnp.int32) * (TH * TW), P)
        out = gather_rows(tex_rows, boff + yi * TW + xi)
    elif mode == 'bilinear':
        out = _bilinear_sample(tex_rows, x, y, (TH, TW, batch_size, P))
    else:
        raise ValueError(f"unsupported mode {mode!r}")
    return out.reshape((batch_size,) + lead_shape + (num_channels,))


def spherical_harmonic_lighting(imnormal, lights):
    """Per-pixel SH9 lighting effect (deprecated in reference; kept for
    DIB-R tutorial parity).

    Parity: ``kaolin/render/mesh/utils.py:78``.

    Args:
        imnormal: ``(B, H, W, 3)`` per-pixel normals.
        lights: ``(B, 9)`` SH coefficients.

    Returns:
        ``(B, H, W)`` lighting effect.
    """
    x = imnormal[..., 0]
    y = imnormal[..., 1]
    z = imnormal[..., 2]
    bands = jnp.stack([
        0.28209479177 * jnp.ones_like(x),
        0.4886025119 * x,
        0.4886025119 * z,
        0.4886025119 * y,
        1.09254843059 * (x * y),
        1.09254843059 * (y * z),
        0.94617469575 * (z * z) - 0.31539156525,
        0.77254840404 * (x * z),
        0.38627420202 * (x * x - y * y)], axis=-1)
    return jnp.sum(bands * lights.reshape(-1, 1, 1, 9), axis=-1)


def prepare_vertices(vertices, faces, camera_proj, camera_rot=None,
                     camera_trans=None, camera_transform=None):
    """Transform + project vertices, index by faces, compute face normals.

    Parity: ``kaolin/render/mesh/utils.py:128``.

    Returns:
        (face_vertices_camera ``(B, F, 3, 3)``,
         face_vertices_image ``(B, F, 3, 2)``,
         face_normals ``(B, F, 3)``).
    """
    if camera_transform is None:
        assert camera_trans is not None and camera_rot is not None, \
            "camera_transform or camera_trans and camera_rot must be defined"
        vertices_camera = _camera.rotate_translate_points(
            vertices, camera_rot, camera_trans)
    else:
        assert camera_trans is None and camera_rot is None, \
            "camera_trans and camera_rot must be None when camera_transform " \
            "is defined"
        padded = jnp.pad(vertices, ((0, 0), (0, 0), (0, 1)),
                         constant_values=1.)
        vertices_camera = padded @ camera_transform
    vertices_image = _camera.perspective_camera(vertices_camera, camera_proj)
    face_vertices_camera = _mesh_ops.index_vertices_by_faces(
        vertices_camera, faces)
    face_vertices_image = _mesh_ops.index_vertices_by_faces(
        vertices_image, faces)
    face_normals = _mesh_ops.face_normals(face_vertices_camera, unit=True)
    return face_vertices_camera, face_vertices_image, face_normals
