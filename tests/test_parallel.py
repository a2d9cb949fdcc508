"""Multi-device sharding tests on the 8-device virtual CPU mesh
(SURVEY.md §4: the reference has no distributed layer; this one is
exercised without a cluster)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from kaolin_tpu.parallel import (make_mesh, multi_view_grad, replicate,
                                 shard_views)
from kaolin_tpu.utils.testing import seeded_uv_sphere


@pytest.fixture
def eight_devices():
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices')
    return jax.devices()[:8]


def test_make_mesh_shapes(eight_devices):
    mesh = make_mesh((8,), ('data',))
    assert mesh.shape == {'data': 8}
    mesh2d = make_mesh((4, 2), ('data', 'tile'))
    assert mesh2d.shape == {'data': 4, 'tile': 2}


def test_multi_view_grad_matches_single_device(eight_devices):
    mesh = make_mesh((8,), ('data',))
    rng = np.random.default_rng(0)
    params = jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32))
    views = jnp.asarray(rng.normal(size=(16, 3)).astype(np.float32))

    def loss_fn(p, v):
        # per-shard loss: sum over local views (psum makes it global)
        return jnp.sum((v @ p.T) ** 2) / 16.

    grad_fn = multi_view_grad(loss_fn, mesh)
    sharded_views = shard_views(mesh, views)
    rep_params = replicate(mesh, params)
    loss, grads = grad_fn(rep_params, sharded_views)

    expected_loss, expected_grads = jax.value_and_grad(loss_fn)(
        params, views)
    np.testing.assert_allclose(float(loss), float(expected_loss),
                               rtol=1e-5)
    np.testing.assert_allclose(np.asarray(grads), np.asarray(expected_grads),
                               rtol=1e-4, atol=1e-5)


def test_sharded_dibr_render_matches_single(eight_devices):
    """Views sharded over the mesh produce the same images as unsharded
    (spatial DP of the renderer — driver config #5 miniature)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from kaolin_tpu.models import inverse_render as M

    mesh = make_mesh((8,), ('data',))
    m = seeded_uv_sphere(320)
    faces = jnp.asarray(np.asarray(m.faces))
    face_uvs = jnp.asarray(np.asarray(m.uvs)[np.asarray(m.face_uvs_idx)])
    params = M.init_params(m, texture_res=16)
    views = M.make_views(8)
    H = W = 16

    def render_local(p, rot, trans):
        v = M.CameraViews(rot, trans, views.camera_proj)
        images, soft, fidx = M.render_views(
            p, v, faces, face_uvs, H, W, backend='jnp',
            with_soft_mask=False)
        return images

    sharded = shard_map(
        render_local, mesh=mesh,
        in_specs=(P(), P('data'), P('data')),
        out_specs=P('data'), check_vma=False)
    imgs_sharded = sharded(params, views.camera_rot, views.camera_trans)
    imgs_single = render_local(params, views.camera_rot,
                               views.camera_trans)
    np.testing.assert_allclose(np.asarray(imgs_sharded),
                               np.asarray(imgs_single), atol=1e-5)


def test_sharded_fused_selection_matches_single(eight_devices):
    """The fused Pallas selection engine (interpreted) under shard_map:
    per-device view shards must reproduce the unsharded selection
    exactly."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    from kaolin_tpu.models import inverse_render as M
    from kaolin_tpu.render.mesh import fused_selection

    mesh = make_mesh((8,), ('data',))
    m = seeded_uv_sphere(320)
    faces = jnp.asarray(np.asarray(m.faces))
    params = M.init_params(m, texture_res=16)
    views = M.make_views(8)
    H = W = 64

    def select_local(p, rot, trans):
        v = M.CameraViews(rot, trans, views.camera_proj)
        fvc, fvi, fn = M._prepare(p, v, faces)
        sel = fused_selection(fvc[..., 2], fvi, fn[..., 2] >= 0., H, W,
                              interpret=True)
        return sel.face_idx, sel.prod

    sharded = shard_map(
        select_local, mesh=mesh,
        in_specs=(P(), P('data'), P('data')),
        out_specs=(P('data'), P('data')), check_vma=False)
    fid_s, prod_s = sharded(params, views.camera_rot, views.camera_trans)
    fid_1, prod_1 = select_local(params, views.camera_rot,
                                 views.camera_trans)
    np.testing.assert_array_equal(np.asarray(fid_s), np.asarray(fid_1))
    np.testing.assert_allclose(np.asarray(prod_s), np.asarray(prod_1),
                               atol=1e-6)


def test_graft_entry_dryrun(monkeypatch):
    import importlib
    import __graft_entry__ as g
    importlib.reload(g)
    fn, args = g.entry(num_faces=320)
    out = jax.jit(fn)(*args)
    assert out[0].shape == (1, 512, 512, 3)
    monkeypatch.setenv('KAOLIN_DRYRUN_RES', '64')
    g.dryrun_multichip(4, num_faces=320)


def test_tile_sharded_render_loss_grads_match_single(eight_devices):
    """The FULL differentiable render (z-buffer + texture/SH epilogue +
    soft mask) sharded over a (data, tile) mesh: loss AND parameter
    gradients must match the single-device render_loss (VERDICT r4 #4 —
    nothing computed a gradient across the tile axis before)."""
    from kaolin_tpu.parallel.tile import tile_sharded_render_loss
    from kaolin_tpu.models import inverse_render as M

    mesh2d = make_mesh((2, 4), ('data', 'tile'))
    m = seeded_uv_sphere(320)
    faces = jnp.asarray(np.asarray(m.faces))
    face_uvs = jnp.asarray(np.asarray(m.uvs)[np.asarray(m.face_uvs_idx)])
    params = M.init_params(m, texture_res=8)
    views = M.make_views(2)
    H = W = 16
    rng = np.random.default_rng(0)
    t_img = jnp.asarray(rng.uniform(size=(2, H, W, 3)).astype(np.float32))
    t_mask = jnp.asarray(
        (rng.uniform(size=(2, H, W)) > 0.5).astype(np.float32))

    def loss_sharded(p):
        return tile_sharded_render_loss(
            mesh2d, p, views, faces, face_uvs, t_img, t_mask, H, W,
            knum=8)

    def loss_single(p):
        return M.render_loss(p, views, faces, face_uvs, t_img, t_mask,
                             H, W, backend='jnp', knum=8)

    v_s, g_s = jax.value_and_grad(loss_sharded)(params)
    v_1, g_1 = jax.value_and_grad(loss_single)(params)
    np.testing.assert_allclose(float(v_s), float(v_1), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g_s),
                    jax.tree_util.tree_leaves(g_1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


def test_tile_sharded_selection_matches_single(eight_devices):
    """Image rows sharded over a (data, tile) mesh reproduce the
    unsharded z-buffer selection exactly (SURVEY §2.3 tile axis)."""
    from kaolin_tpu.parallel.tile import tile_sharded_selection
    from kaolin_tpu.render.mesh.rasterization import rasterize_selection
    from kaolin_tpu.models import inverse_render as M
    import kaolin_tpu as kal

    mesh2d = make_mesh((2, 4), ('data', 'tile'))
    m = seeded_uv_sphere(320)
    faces = jnp.asarray(np.asarray(m.faces))
    params = M.init_params(m, texture_res=16)
    views = M.make_views(2)
    H = W = 32
    fvc, fvi, fn = jax.lax.stop_gradient(
        M._prepare(params, views, faces))
    valid = fn[..., 2] >= 0.
    ref = rasterize_selection(H, W, fvc[..., 2], fvi, valid_faces=valid,
                              backend='jnp')
    out = tile_sharded_selection(mesh2d, fvc[..., 2], fvi, valid, H, W)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(ref))
