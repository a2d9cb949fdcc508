"""Camera API tour: every construction path, motion op, and projection
of the differentiable Camera (the reference's camera tutorial notebooks
— camera_init / camera_movement / camera_properties — as one script).

Usage::

    python examples/camera_tour.py
"""

import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), os.pardir))

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    import kaolin_tpu as kal
    from kaolin_tpu.render.camera import (
        Camera, CameraExtrinsics, CameraFOV, OrthographicIntrinsics,
        PinholeIntrinsics, blender_coords)

    # -- construction: lookat + fov ------------------------------------
    cam = Camera.from_args(
        eye=jnp.array([4., 4., 4.]), at=jnp.zeros(3),
        up=jnp.array([0., 1., 0.]), fov=30 * math.pi / 180,
        width=256, height=256)
    print('lookat camera:', len(cam), 'view matrix det',
          f'{float(jnp.linalg.det(cam.view_matrix()[0, :3, :3])):.3f}')

    # -- construction: focal / view matrix / camera pose ---------------
    cam_focal = Camera.from_args(
        eye=jnp.array([0., 0., 3.]), at=jnp.zeros(3),
        up=jnp.array([0., 1., 0.]), focal_x=500., width=256, height=256)
    print('focal camera fov_x:',
          f'{float(cam_focal.fov(CameraFOV.HORIZONTAL)[0]):.1f} deg')

    ext = CameraExtrinsics.from_view_matrix(cam.view_matrix())
    print('from_view_matrix round-trip close:',
          bool(jnp.allclose(ext.view_matrix(), cam.view_matrix(),
                            atol=1e-5)))

    # -- orthographic ---------------------------------------------------
    ortho = Camera.from_args(
        eye=jnp.array([0., 0., 3.]), at=jnp.zeros(3),
        up=jnp.array([0., 1., 0.]),
        width=256, height=256, fov_distance=2.0)
    print('ortho intrinsics:', type(ortho.intrinsics).__name__)

    # -- projection -----------------------------------------------------
    points = jnp.asarray(np.random.default_rng(0).normal(
        size=(16, 3)).astype(np.float32))
    ndc = cam.transform(points)
    depth = cam.extrinsics.transform(points)[..., 2]
    print('projected', ndc.shape, 'mean depth',
          f'{float(depth.mean()):.3f}')

    # -- motion ---------------------------------------------------------
    before = np.asarray(cam.cam_pos()).reshape(-1)
    cam.move_forward(0.5)
    cam.rotate(yaw=0.1, pitch=0.05, roll=0.)
    after = np.asarray(cam.cam_pos()).reshape(-1)
    print('moved camera by', f'{np.linalg.norm(after - before):.3f}')

    # -- coordinate-system change (blender convention) ------------------
    cam_b = Camera.from_args(
        eye=jnp.array([4., 4., 4.]), at=jnp.zeros(3),
        up=jnp.array([0., 1., 0.]), fov=30 * math.pi / 180,
        width=256, height=256)
    cam_b.extrinsics.change_coordinate_system(blender_coords())
    print('blender-coords view differs:', not bool(jnp.allclose(
        cam_b.view_matrix(), cam.view_matrix())))

    # -- batched cameras + cat ------------------------------------------
    pair = Camera.cat([cam_focal, cam_focal])
    print('cat batch size:', len(pair))

    # -- differentiable pose (6-DoF backend) ----------------------------
    e0 = CameraExtrinsics.from_lookat(
        eye=jnp.array([0., 0., 3.]), at=jnp.zeros(3),
        up=jnp.array([0., 1., 0.]), backend='matrix_6dof_rotation')

    def loss_fn(params):
        e = CameraExtrinsics(params, backend_name='matrix_6dof_rotation')
        return jnp.sum(e.transform(points) ** 2)

    g = jax.grad(loss_fn)(e0.parameters())
    print('pose gradient norm:', f'{float(jnp.linalg.norm(g)):.3f}')
    print('done')


if __name__ == '__main__':
    main()
