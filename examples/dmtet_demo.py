"""DMTet-style demo: optimize an SDF on a tet grid so marching tetrahedra
reconstructs a target sphere (driver config #4 neighborhood: tet losses +
differentiable iso-surface).

Usage::

    python examples/dmtet_demo.py --res 8 --steps 30
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), os.pardir))

import numpy as np


def tet_grid(res):
    """Regular tetrahedral grid covering [-0.5, 0.5]^3."""
    lin = np.linspace(-0.5, 0.5, res + 1, dtype=np.float32)
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing='ij'),
                   axis=-1).reshape(-1, 3)

    def vid(x, y, z):
        return (x * (res + 1) + y) * (res + 1) + z

    cube_tets = np.array([
        [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
        [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]])
    corners = np.array([[(j >> 2) & 1, (j >> 1) & 1, j & 1]
                        for j in range(8)])
    tets = []
    for x in range(res):
        for y in range(res):
            for z in range(res):
                ids = [vid(x + c[0], y + c[1], z + c[2]) for c in corners]
                for t in cube_tets:
                    tets.append([ids[i] for i in t])
    return pts, np.asarray(tets)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--res', type=int, default=5)
    parser.add_argument('--steps', type=int, default=10)
    parser.add_argument('--lr', type=float, default=1e-2)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import optax
    from kaolin_tpu.ops.conversions import marching_tetrahedra
    from kaolin_tpu.metrics.pointcloud import chamfer_distance

    pts_np, tets = tet_grid(args.res)
    vertices = jnp.asarray(pts_np)[None]

    # target: points on a sphere of radius 0.35
    rng = np.random.default_rng(0)
    d = rng.normal(size=(2048, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    target = jnp.asarray((d * 0.35).astype(np.float32))[None]

    sdf = jnp.asarray(
        np.linalg.norm(pts_np, axis=1) - 0.25)[None]  # wrong radius

    optimizer = optax.adam(args.lr)
    opt_state = optimizer.init(sdf)

    for step in range(args.steps):
        def loss_fn(s):
            verts, faces = marching_tetrahedra(vertices, tets, s)
            if verts[0].shape[0] == 0:
                return jnp.float32(1.0)
            return chamfer_distance(verts[0][None], target)[0]

        loss, grads = jax.value_and_grad(loss_fn)(sdf)
        updates, opt_state = optimizer.update(grads, opt_state, sdf)
        sdf = optax.apply_updates(sdf, updates)
        if step % 5 == 0 or step == args.steps - 1:
            print(f'step {step:3d}  chamfer {float(loss):.6f}')
    print('done')


if __name__ == '__main__':
    main()
