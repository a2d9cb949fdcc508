"""DIB-R inverse rendering: fit vertices + texture + lighting to target
views (the reference's dibr_tutorial.ipynb workload, driver configs #1/#2).

Usage::

    python examples/dibr_inverse_rendering.py --height 64 --steps 20
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), os.pardir))

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--mesh', default=None,
                        help='.obj file (default: a seeded UV sphere)')
    parser.add_argument('--height', type=int, default=64)
    parser.add_argument('--width', type=int, default=64)
    parser.add_argument('--num-views', type=int, default=4)
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--lr', type=float, default=5e-3)
    parser.add_argument('--backend', default='jnp')
    parser.add_argument('--logdir', default=None,
                        help='write Timelapse USD checkpoints here')
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import optax
    from kaolin_tpu.io import obj
    from kaolin_tpu.models import inverse_render as M
    from kaolin_tpu.utils.testing import seeded_uv_sphere

    mesh = (obj.import_mesh(args.mesh, triangulate=True) if args.mesh
            else seeded_uv_sphere(320))
    faces = jnp.asarray(np.asarray(mesh.faces))
    face_uvs = (jnp.asarray(np.asarray(mesh.uvs)[
        np.asarray(mesh.face_uvs_idx)]) if mesh.uvs is not None
        else jnp.zeros((faces.shape[0], 3, 2)))
    views = M.make_views(args.num_views)

    # ground truth = the original mesh with a fixed texture
    gt_params = M.init_params(mesh, texture_res=64, key=jax.random.key(7))
    target_images, target_masks, _ = M.render_views(
        gt_params, views, faces, face_uvs, args.height, args.width,
        backend=args.backend)

    # start from a perturbed mesh
    key = jax.random.key(0)
    params = M.init_params(mesh, texture_res=64)
    params = params._replace(
        vertices=params.vertices
        + 0.05 * jax.random.normal(key, params.vertices.shape))

    optimizer = grad_tx = __import__('optax').adam(args.lr)
    opt_state = optimizer.init(params)

    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, sel: M.render_loss(
            p, views, faces, face_uvs, target_images, target_masks,
            args.height, args.width, backend=args.backend,
            selection=sel)))

    timelapse = None
    if args.logdir:
        from kaolin_tpu.visualize import Timelapse
        timelapse = Timelapse(args.logdir)

    for step in range(args.steps):
        t0 = time.time()
        sel = M.compute_selection(params, views, faces, args.height,
                                  args.width, backend=args.backend)
        loss, grads = grad_fn(params, sel)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = __import__('optax').apply_updates(params, updates)
        print(f'step {step:3d}  loss {float(loss):.5f}  '
              f'({time.time() - t0:.2f}s)')
        if timelapse is not None and step % 5 == 0:
            timelapse.add_mesh_batch(
                iteration=step, category='fitted',
                vertices_list=[np.asarray(params.vertices)],
                faces_list=[np.asarray(faces)])
    print('done')


if __name__ == '__main__':
    main()
