"""Legacy functional camera API (used by the DIB-R pipeline).

Parity: ``kaolin/render/camera/legacy.py`` (reference).
"""

from math import tan

import jax
import jax.numpy as jnp

__all__ = [
    'rotate_translate_points',
    'generate_rotate_translate_matrices',
    'generate_transformation_matrix',
    'perspective_camera',
    'generate_perspective_projection',
]


def rotate_translate_points(points, camera_rot, camera_trans):
    """``P_new = R @ (P_old - T)``.

    Parity: ``kaolin/render/camera/legacy.py:22``.

    Args:
        points: ``(B, N, 3)``.
        camera_rot: ``(B, 3, 3)``.
        camera_trans: ``(B, 3)`` or ``(B, 3, 1)``.

    Returns:
        ``(B, N, 3)``.
    """
    translated = points - camera_trans.reshape(-1, 1, 3)
    # full f32: a GPU would otherwise run this product in TF32, which moves
    # projected vertices by a sizeable fraction of a pixel
    return jnp.matmul(translated, jnp.swapaxes(camera_rot, 1, 2),
                      precision=jax.lax.Precision.HIGHEST)


def generate_rotate_translate_matrices(camera_position, look_at,
                                       camera_up_direction):
    """Camera rotation + translation for ``P_cam = R @ (P_world - T)``.

    Parity: ``kaolin/render/camera/legacy.py:40``.

    Returns:
        (rot ``(B, 3, 3)``, trans ``(B, 3)``).
    """
    camz = look_at - camera_position
    camz = camz / (jnp.linalg.norm(camz, axis=1, keepdims=True) + 1e-10)
    B = max(camz.shape[0], camera_up_direction.shape[0])
    camz = jnp.broadcast_to(camz, (B, 3))
    up = jnp.broadcast_to(camera_up_direction, (B, 3))
    camx = jnp.cross(camz, up)
    camx = camx / (jnp.linalg.norm(camx, axis=1, keepdims=True) + 1e-10)
    camy = jnp.cross(camx, camz)
    camy = camy / (jnp.linalg.norm(camy, axis=1, keepdims=True) + 1e-10)
    mtx = jnp.stack([camx, camy, -camz], axis=1)
    return mtx, camera_position


def generate_transformation_matrix(camera_position, look_at,
                                   camera_up_direction):
    """(B, 4, 3) matrix for ``P_cam = [P_world | 1] @ M``.

    Parity: ``kaolin/render/camera/legacy.py:85``.
    """
    z_axis = camera_position - look_at
    z_axis = z_axis / jnp.linalg.norm(z_axis, axis=1, keepdims=True)
    B = max(z_axis.shape[0], camera_up_direction.shape[0])
    z_axis = jnp.broadcast_to(z_axis, (B, 3))
    up = jnp.broadcast_to(camera_up_direction, (B, 3))
    x_axis = jnp.cross(up, z_axis)
    x_axis = x_axis / jnp.linalg.norm(x_axis, axis=1, keepdims=True)
    y_axis = jnp.cross(z_axis, x_axis)
    rot_part = jnp.stack([x_axis, y_axis, z_axis], axis=2)
    trans_part = -camera_position[:, None] @ rot_part
    return jnp.concatenate([rot_part, trans_part], axis=1)


def perspective_camera(points, camera_proj):
    """Project camera-space 3D points to 2D image coords (divide by z).

    Parity: ``kaolin/render/camera/legacy.py:120``: the projection vector's
    z entry is -1, so this divides x, y by ``-z``.

    Args:
        points: ``(B, N, 3)`` camera-space points.
        camera_proj: ``(3, 1)`` projection vector.

    Returns:
        ``(B, N, 2)``.
    """
    projected = points * camera_proj.reshape(-1, 1, 3)
    return projected[:, :, :2] / projected[:, :, 2:3]


def generate_perspective_projection(fovyangle, ratio=1.0,
                                    dtype=jnp.float32):
    """(3, 1) perspective projection vector for :func:`perspective_camera`.

    Parity: ``kaolin/render/camera/legacy.py:142``.
    """
    tanfov = tan(fovyangle / 2.0)
    return jnp.array([[1.0 / (ratio * tanfov)], [1.0 / tanfov], [-1]],
                     dtype=dtype)
