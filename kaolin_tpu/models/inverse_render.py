"""Flagship model: DIB-R textured inverse rendering.

The reference is a library, not a trainer (SURVEY.md §1); its flagship
workload is DIB-R-style multi-view shape fitting (tutorials
``examples/tutorial/dibr_tutorial.ipynb``, driver configs #1/#2/#5).  This
module packages that workload as an explicit model: optimizable parameters
(vertex positions, UV texture, SH lighting) plus a jittable render step.
"""

import math
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from kaolin_tpu.ops import mesh as mesh_ops
from kaolin_tpu.render import camera as camera_fns
from kaolin_tpu.render import mesh as mesh_render
from kaolin_tpu.render.mesh import _fused
from kaolin_tpu.render.mesh.rasterization import _resolve_backend

__all__ = ['InverseRenderParams', 'CameraViews', 'make_views',
           'render_views', 'render_loss', 'init_params',
           'compute_selection']


class InverseRenderParams(NamedTuple):
    """Optimizable parameters of the inverse-rendering model."""
    vertices: jnp.ndarray        # (V, 3)
    texture_map: jnp.ndarray     # (3, TH, TW)
    sh_coeffs: jnp.ndarray       # (9,)


class CameraViews(NamedTuple):
    """Per-view camera data (leading axis = views; shardable)."""
    camera_rot: jnp.ndarray      # (B, 3, 3)
    camera_trans: jnp.ndarray    # (B, 3)
    camera_proj: jnp.ndarray     # (3, 1) shared


def init_params(mesh, texture_res=256, key=None):
    """Init params from a SurfaceMesh (normalized into [-0.5, 0.5]^3)."""
    v = mesh.vertices
    vmin = v.min(axis=0, keepdims=True)
    vmax = v.max(axis=0, keepdims=True)
    v = (v - (vmin + vmax) / 2.) / (vmax - vmin).max()
    if key is None:
        key = jax.random.key(0)
    texture = jax.random.uniform(key, (3, texture_res, texture_res),
                                 dtype=jnp.float32)
    sh = jnp.zeros((9,), dtype=jnp.float32).at[0].set(3.0)
    return InverseRenderParams(v, texture, sh)


def make_views(num_views, distance=2.0, fovy=math.pi / 4., elevation=0.4):
    """Build a turntable of camera views around the origin."""
    azimuth = np.linspace(0, 2 * np.pi, num_views, endpoint=False)
    eye = np.stack([np.sin(azimuth) * np.cos(elevation),
                    np.full_like(azimuth, np.sin(elevation)),
                    np.cos(azimuth) * np.cos(elevation)],
                   axis=-1) * distance
    eye = jnp.asarray(eye, dtype=jnp.float32)
    at = jnp.zeros((num_views, 3), dtype=jnp.float32)
    up = jnp.broadcast_to(jnp.array([0., 1., 0.]), (num_views, 3))
    rot, trans = camera_fns.generate_rotate_translate_matrices(eye, at, up)
    proj = camera_fns.generate_perspective_projection(fovy)
    return CameraViews(rot, trans, proj)


def _prepare(params, views, faces):
    """Camera transform + projection + face indexing (differentiable)."""
    B = views.camera_rot.shape[0]
    vertices = jnp.broadcast_to(params.vertices[None],
                                (B,) + params.vertices.shape)
    return mesh_render.prepare_vertices(
        vertices, faces, views.camera_proj,
        camera_rot=views.camera_rot, camera_trans=views.camera_trans)


def compute_selection(params: InverseRenderParams, views: CameraViews,
                      faces, height, width, backend='auto', boxlen=0.02,
                      knum=30, sigmainv=7000., with_soft_mask=True):
    """Run both non-differentiable selection passes (z-buffer + soft-mask).

    Run standalone, it keeps each XLA program small (fast [re]compiles)
    and lets the selection result be reused; :func:`render_views` calls it
    when no selection is given.

    Returns:
        (face_idx (B, H, W), aux) where ``aux`` is the soft-mask selection
        state: a (B, H, W, knum) k-buffer for the 'jnp' backend (None
        without the soft mask), or a
        :class:`~kaolin_tpu.render.mesh.FusedSelection` for 'fused'
        (both accepted by ``dibr_soft_mask(kbuf=...)``).
    """
    face_vertices_camera, face_vertices_image, face_normals = \
        jax.lax.stop_gradient(_prepare(params, views, faces))
    if _resolve_backend(backend) == 'fused':
        sel = _fused.fused_selection(
            face_vertices_camera[..., 2], face_vertices_image,
            face_normals[..., 2] >= 0., height, width,
            boxlen=boxlen, sigmainv=sigmainv, with_softmask=with_soft_mask)
        return sel.face_idx, sel
    face_idx = mesh_render.rasterize_selection(
        height, width, face_vertices_camera[..., 2], face_vertices_image,
        valid_faces=face_normals[..., 2] >= 0., backend=backend)
    kbuf = mesh_render.dibr_soft_mask_select(
        face_vertices_image, face_idx, boxlen=boxlen,
        knum=knum) if with_soft_mask else None
    return face_idx, kbuf


def render_views(params: InverseRenderParams, views: CameraViews, faces,
                 face_uvs, height, width, backend='auto', sigmainv=7000.,
                 with_soft_mask=True, selection=None, knum=30):
    """Render all views: textured DIB-R + SH lighting.

    Mirrors the reference DIB-R tutorial pipeline (call stack SURVEY.md
    §3.1): prepare_vertices -> dibr_rasterization(uvs, normals) ->
    texture_mapping + spherical_harmonic_lighting.  With the 'fused'
    backend one selection pass yields both the z-buffer winner and the
    soft-mask product.

    Args:
        params: model parameters.
        views: camera batch (B views).
        faces: (F, 3) int array.
        face_uvs: (F, 3, 2) per-face-corner uvs.
        height, width: image size.
        selection: ``(face_idx, aux)`` from :func:`compute_selection`;
            computed here with ``backend`` when None.

    Returns:
        (images (B, H, W, 3), soft_mask (B, H, W), face_idx (B, H, W)).
    """
    B = views.camera_rot.shape[0]
    face_vertices_camera, face_vertices_image, face_normals = \
        _prepare(params, views, faces)
    face_uvs_b = jnp.broadcast_to(face_uvs[None], (B,) + face_uvs.shape)
    face_normals_corner = jnp.broadcast_to(
        face_normals[:, :, None, :],
        face_normals.shape[:2] + (3, 3))
    if selection is None:
        selection = compute_selection(
            params, views, faces, height, width, backend=backend, knum=knum,
            sigmainv=sigmainv, with_soft_mask=with_soft_mask)
    (uv_map, normal_map), face_idx = mesh_render.rasterize(
        height, width, face_vertices_camera[..., 2],
        face_vertices_image, [face_uvs_b, face_normals_corner],
        precomputed_face_idx=selection[0])
    texture = jnp.broadcast_to(params.texture_map[None],
                               (B,) + params.texture_map.shape)
    albedo = mesh_render.texture_mapping(uv_map, texture, mode='bilinear')
    lighting = mesh_render.spherical_harmonic_lighting(
        normal_map, jnp.broadcast_to(params.sh_coeffs[None], (B, 9)))
    images = albedo * jnp.clip(lighting, 0.)[..., None]
    images = jnp.clip(images, 0., 1.)
    images = jnp.where((face_idx >= 0)[..., None], images, 0.)
    if with_soft_mask:
        soft_mask = mesh_render.dibr_soft_mask(
            face_vertices_image, face_idx, sigmainv=sigmainv, knum=knum,
            kbuf=selection[1])
    else:
        soft_mask = (face_idx >= 0).astype(images.dtype)
    return images, soft_mask, face_idx


def render_loss(params, views, faces, face_uvs, target_images, target_masks,
                height, width, backend='auto', with_soft_mask=True,
                selection=None, knum=30):
    """Image L1 + silhouette IoU loss (the reference tutorials' loss)."""
    from kaolin_tpu.metrics.render import mask_iou
    images, soft_mask, _ = render_views(
        params, views, faces, face_uvs, height, width, backend=backend,
        with_soft_mask=with_soft_mask, selection=selection, knum=knum)
    image_loss = jnp.mean(jnp.abs(images - target_images))
    mask_loss = mask_iou(soft_mask, target_masks)
    return image_loss + mask_loss
