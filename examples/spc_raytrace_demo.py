"""SPC pipeline demo: mesh -> octree -> ray trace -> volume integrate
(NGLOD-style; driver config #3, call stack SURVEY.md §3.2).

Usage::

    python examples/spc_raytrace_demo.py --level 6 --rays 10000
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
    parser.add_argument('--level', type=int, default=6)
    parser.add_argument('--rays', type=int, default=10000)
    args = parser.parse_args()

    import jax.numpy as jnp
    from kaolin_tpu.io import obj
    from kaolin_tpu.ops import spc as spc_ops
    from kaolin_tpu.ops.conversions import unbatched_mesh_to_spc
    from kaolin_tpu.render import spc as spc_render
    from kaolin_tpu.utils.testing import seeded_uv_sphere

    mesh = (obj.import_mesh(args.mesh, triangulate=True) if args.mesh
            else seeded_uv_sphere(320))
    v = np.asarray(mesh.vertices)
    v = (v - (v.min(0) + v.max(0)) / 2.) / np.abs(v).max() * 0.9
    fv = jnp.asarray(v[np.asarray(mesh.faces)])

    t0 = time.time()
    octree, points, face_idx, bary = unbatched_mesh_to_spc(fv, args.level)
    print(f'mesh_to_spc level {args.level}: '
          f'{np.asarray(points).shape[0]} voxels '
          f'({time.time() - t0:.2f}s)')

    lengths = np.array([len(np.asarray(octree))], dtype=np.int32)
    max_level, pyramids, exsum = spc_ops.scan_octrees(octree, lengths)
    ph = spc_ops.generate_points(octree, pyramids, exsum)

    # orthographic rays looking down -z
    n = int(np.sqrt(args.rays))
    lin = np.linspace(-0.95, 0.95, n, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin)
    origin = jnp.asarray(
        np.stack([gx, gy, np.full_like(gx, 2.)], -1).reshape(-1, 3))
    direction = jnp.asarray(
        np.broadcast_to(np.array([0., 0., -1.], np.float32),
                        origin.shape).copy())

    t0 = time.time()
    ridx, pidx, depth = spc_render.unbatched_raytrace(
        octree, ph, np.asarray(pyramids)[0], exsum, origin, direction,
        args.level)
    nuggets = np.asarray(ridx).shape[0]
    dt = time.time() - t0
    print(f'raytrace: {nuggets} intersections for {origin.shape[0]} rays '
          f'({dt:.2f}s incl. compile)')

    # volume integration over the packs
    boundaries = spc_render.mark_pack_boundaries(ridx)
    tau = jnp.full((nuggets, 1), 0.4)
    feats = jnp.asarray(
        np.asarray(ph)[np.asarray(pidx)].astype(np.float32) /
        (2 ** args.level))
    integrated, transmittance = spc_render.exponential_integration(
        feats, tau, boundaries)
    print(f'integrated features for {integrated.shape[0]} hit rays; '
          f'mean transmittance {float(transmittance.mean()):.4f}')


if __name__ == '__main__':
    main()
