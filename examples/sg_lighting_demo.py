"""Spherical-gaussian lighting demo: render a textured mesh through the
full pipeline (Camera.from_args -> rasterize -> texture_mapping -> SG
diffuse + specular), then recover the light parameters from the image by
gradient descent (the DIB-R++ use case; reference
``render/lighting/test_sg.py`` scene setup).

Usage::

    python examples/sg_lighting_demo.py --size 64 --steps 10
"""

import argparse
import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), os.pardir))

import numpy as np


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--mesh', default=(
        '/root/reference/tests/samples/colored_sphere.obj'))
    parser.add_argument('--size', type=int, default=64)
    parser.add_argument('--steps', type=int, default=10)
    parser.add_argument('--lr', type=float, default=5e-2)
    args = parser.parse_args()

    import jax
    import jax.numpy as jnp
    import optax
    import kaolin_tpu as kal

    mesh = kal.io.obj.import_mesh(args.mesh, with_materials=True,
                                  with_normals=True)
    vertices = jnp.asarray(np.asarray(mesh.vertices))[None]
    v_max = vertices.max(axis=1, keepdims=True)
    v_min = vertices.min(axis=1, keepdims=True)
    vertices = (vertices - v_min) / (v_max - v_min) - 0.5
    faces = jnp.asarray(np.asarray(mesh.faces))
    normals = jnp.asarray(np.asarray(mesh.normals))[None]
    face_normals = kal.ops.mesh.index_vertices_by_faces(
        normals, jnp.asarray(np.asarray(mesh.face_normals_idx)))
    uvs = jnp.asarray(np.asarray(mesh.uvs))[None]
    face_uvs = kal.ops.mesh.index_vertices_by_faces(
        uvs, jnp.asarray(np.asarray(mesh.face_uvs_idx)))
    texture = jnp.asarray(
        np.asarray(mesh.materials[0]['map_Kd']), jnp.float32
    ).transpose(2, 0, 1)[None] / 255.

    cam = kal.render.camera.Camera.from_args(
        eye=jnp.array([0., -0.6, 0.8]), at=jnp.zeros(3),
        up=jnp.array([0., 1., 0.]), fov=70. * 2. * math.pi / 360,
        width=args.size, height=args.size)
    vc = cam.extrinsics.transform(vertices)
    vn = cam.intrinsics.transform(vc)
    fvc = kal.ops.mesh.index_vertices_by_faces(vc, faces)
    fvi = kal.ops.mesh.index_vertices_by_faces(vn[..., :2], faces)

    (uv_map, nrm_map), face_idx = kal.render.mesh.rasterize(
        args.size, args.size, fvc[..., -1], fvi,
        [face_uvs, face_normals], backend='jnp')
    mask = face_idx != -1
    nrm = nrm_map / jnp.maximum(
        jnp.linalg.norm(nrm_map, axis=-1, keepdims=True), 1e-12)
    albedo = kal.render.mesh.texture_mapping(uv_map, texture,
                                             mode='nearest')
    albedo = jnp.clip(albedo * mask[..., None], 0., 1.)

    def shade(amplitude, direction, sharpness):
        eff = kal.render.lighting.sg_diffuse_inner_product(
            amplitude, direction, sharpness,
            nrm.reshape(-1, 3), albedo.reshape(-1, 3)
        ).reshape(albedo.shape)
        return jnp.where(mask[..., None], eff, 0.)

    # ground-truth lighting -> target image
    gt_dirs = jnp.stack(kal.ops.coords.spherical2cartesian(
        jnp.array([0., math.pi / 2.]), jnp.array([0., 0.])), axis=-1)
    gt_amp = jnp.array([[5., 2., 2.], [5., 10., 5.]])
    gt_sharp = jnp.array([6., 20.])
    target = shade(gt_amp, gt_dirs, gt_sharp)
    print(f'target image mean {float(target.mean()):.4f}')

    # recover amplitudes from the image (directions/sharpness known)
    params = jnp.ones_like(gt_amp)
    opt = optax.adam(args.lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(p, s):
        def loss_fn(p):
            return jnp.mean((shade(p, gt_dirs, gt_sharp) - target) ** 2)
        loss, g = jax.value_and_grad(loss_fn)(p)
        updates, s = opt.update(g, s, p)
        return optax.apply_updates(p, updates), s, loss

    for i in range(args.steps):
        params, opt_state, loss = step(params, opt_state)
        if i % max(1, args.steps // 5) == 0:
            print(f'step {i}: loss {float(loss):.6f}')
    err = float(jnp.abs(params - gt_amp).mean())
    print(f'final amplitude error {err:.4f}')
    print('done')


if __name__ == '__main__':
    main()
