"""Tests for the fused tile-binned Pallas DIB-R engine (render/mesh/_fused).

The kernels run in the Pallas interpreter here (``interpret=True``); on a
GPU the same code compiles through Triton.  Parity targets:

- z-buffer face selection == the brute-force 'jnp' backend;
- soft mask == dibr_soft_mask (k-buffer path) wherever per-pixel coverage
  stays under knum (the fused engine computes the uncapped product);
- soft-mask gradients == the reference CUDA product-division algebra
  (golden fixtures from /root/reference/tests/samples/dibr/simple).
"""
import functools
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import kaolin_tpu as kal
from kaolin_tpu.render.mesh import _fused as FU
from kaolin_tpu.render.mesh import dibr as dibr_mod
from kaolin_tpu.render.mesh import rasterization as rast_mod

SIMPLE_GT_DIR = '/root/reference/tests/samples/dibr/simple/'


def random_scene(key, F=57, B=2, spread=0.3):
    k1, k2 = jax.random.split(jax.random.key(key))
    fvi = jax.random.uniform(k1, (B, F, 3, 2), minval=-0.9, maxval=0.9)
    cent = fvi.mean(axis=2, keepdims=True)
    fvi = cent + (fvi - cent) * spread
    fvz = jax.random.uniform(k2, (B, F, 3), minval=0.1, maxval=2.0)
    return fvz, fvi


@pytest.mark.parametrize('hw', [(64, 64), (35, 31), (40, 200)])
def test_fused_selection_matches_jnp(hw):
    H, W = hw
    fvz, fvi = random_scene(0)
    valid = jnp.ones(fvz.shape[:2], dtype=bool)
    fi_ref = rast_mod.rasterize_selection(H, W, fvz, fvi, valid,
                                          backend='jnp')
    sel = FU.fused_selection(fvz, fvi, valid, height=H, width=W,
                             interpret=True)
    np.testing.assert_array_equal(np.asarray(sel.face_idx),
                                  np.asarray(fi_ref))


def test_fused_selection_valid_faces():
    H = W = 32
    fvz, fvi = random_scene(3, F=8, B=1, spread=1.0)
    valid = jnp.array([[True, False, True, False, True, False, True,
                        False]])
    fi_ref = rast_mod.rasterize_selection(H, W, fvz, fvi, valid,
                                          backend='jnp')
    sel = FU.fused_selection(fvz, fvi, valid, height=H, width=W,
                             interpret=True)
    np.testing.assert_array_equal(np.asarray(sel.face_idx),
                                  np.asarray(fi_ref))
    assert not np.isin(np.asarray(sel.face_idx), [1, 3, 5, 7]).any()


def test_fused_softmask_matches_kbuffer_path():
    """Against the k-buffer path in float64: the f32 k-buffer path's own
    rounding (its ``A*x0 + B*y0 + C`` cancels terms of size
    multiplier**2) is larger than the kernel's error."""
    H, W = 48, 48
    fvz, fvi = random_scene(1)
    valid = jnp.ones(fvz.shape[:2], dtype=bool)
    fi = rast_mod.rasterize_selection(H, W, fvz, fvi, valid, backend='jnp')
    with jax.enable_x64(True):
        mask_ref = np.asarray(dibr_mod.dibr_soft_mask(
            jnp.asarray(np.asarray(fvi), jnp.float64), fi, knum=60))
    sel = FU.fused_selection(fvz, fvi, valid, height=H, width=W,
                             interpret=True)
    mask_fused = FU.softmask_fused(fvi * 1000., sel, (H, W, 1000., 7000.))
    np.testing.assert_allclose(np.asarray(mask_fused), mask_ref, atol=1e-5)


def test_fused_softmask_grad_matches_kbuffer_path():
    H = W = 40
    fvz, fvi = random_scene(2, F=23)
    valid = jnp.ones(fvz.shape[:2], dtype=bool)
    fi = rast_mod.rasterize_selection(H, W, fvz, fvi, valid, backend='jnp')
    sel = FU.fused_selection(fvz, fvi, valid, height=H, width=W,
                             interpret=True)
    config = (H, W, 1000., 7000.)

    def loss_ref(fvi_):
        return jnp.sum(dibr_mod.dibr_soft_mask(fvi_, fi, knum=40) ** 2)

    def loss_fused(fvi_s):
        return jnp.sum(FU.softmask_fused(fvi_s, sel, config) ** 2)

    g_ref = np.asarray(jax.grad(loss_ref)(fvi))
    g_fused = np.asarray(jax.grad(loss_fused)(fvi * 1000.)) * 1000.
    # CUDA product-division approximation vs exact cumprod: tiny rel diff
    scale = max(np.abs(g_ref).max(), 1.)
    np.testing.assert_allclose(g_fused / scale, g_ref / scale, atol=1e-4)


@pytest.mark.parametrize('sigmainv', [7000, 70])
@pytest.mark.parametrize('boxlen', [0.02, 0.2])
def test_fused_soft_mask_forward_golden(sigmainv, boxlen):
    torch = pytest.importorskip('torch')
    gt = torch.load(
        os.path.join(SIMPLE_GT_DIR, f'soft_mask_35_31_{sigmainv}_{boxlen}.pt'),
        map_location='cpu').numpy()
    fvi = jnp.array(
        [[[[-0.7, 0.], [0., -0.7], [0., 0.7]],
          [[-0.7, 0.], [0., 0.7], [0., -0.7]],
          [[0., -0.7], [0., 0.7], [0.7, 0.]]],
         [[[-0.7, -0.7], [0.7, -0.7], [-0.7, 0.7]],
          [[-0.7, -0.7], [0.7, -0.7], [-0.7, 0.7]],
          [[-0.7, -0.7], [0.7, -0.7], [-0.7, 0.7]]]], dtype=jnp.float32)
    fvz = jnp.array(
        [[[-2., -1., -1.], [-2.5, -3., -3.], [-2., -2., -2.]],
         [[-2., -1., -3.], [-2., -2., -2.], [-2., -3., -1.]]],
        dtype=jnp.float32)
    sel = FU.fused_selection(fvz, fvi, height=35, width=31,
                             boxlen=boxlen, sigmainv=sigmainv,
                             interpret=True)
    mask = FU.softmask_fused(fvi * 1000., sel, (35, 31, 1000., sigmainv))
    np.testing.assert_allclose(np.asarray(mask), gt, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('sigmainv', [7000, 70])
@pytest.mark.parametrize('boxlen', [0.02, 0.2])
def test_fused_soft_mask_backward_golden(sigmainv, boxlen):
    torch = pytest.importorskip('torch')
    gt_grad = torch.load(
        os.path.join(SIMPLE_GT_DIR,
                     f'grad_face_vertices_image_35_31_{sigmainv}_{boxlen}.pt'),
        map_location='cpu').numpy()
    fvi = jnp.array(
        [[[[-0.7, 0.], [0., -0.7], [0., 0.7]],
          [[-0.7, 0.], [0., 0.7], [0., -0.7]],
          [[0., -0.7], [0., 0.7], [0.7, 0.]]],
         [[[-0.7, -0.7], [0.7, -0.7], [-0.7, 0.7]],
          [[-0.7, -0.7], [0.7, -0.7], [-0.7, 0.7]],
          [[-0.7, -0.7], [0.7, -0.7], [-0.7, 0.7]]]], dtype=jnp.float32)
    fvz = jnp.array(
        [[[-2., -1., -1.], [-2.5, -3., -3.], [-2., -2., -2.]],
         [[-2., -1., -3.], [-2., -2., -2.], [-2., -3., -1.]]],
        dtype=jnp.float32)
    sel = FU.fused_selection(fvz, fvi, height=35, width=31,
                             boxlen=boxlen, sigmainv=sigmainv,
                             interpret=True)
    mask = sel.face_idx != -1
    shifted_mask = jnp.pad(mask, ((0, 0), (0, 0), (0, 5)))[..., 5:]

    def loss_fn(fvi_):
        soft_mask = FU.softmask_fused(fvi_ * 1000., sel,
                                      (35, 31, 1000., float(sigmainv)))
        return kal.metrics.render.mask_iou(
            soft_mask, shifted_mask.astype(soft_mask.dtype))

    grad = jax.grad(loss_fn)(fvi)
    # the fused backward uses the CUDA kernel's product-division
    # approximation (dibr_soft_mask_cuda.cu:283-284); near-edge pixels
    # with p ~ 1 deviate from the exact-cumprod goldens by <1%
    np.testing.assert_allclose(np.asarray(grad), gt_grad,
                               rtol=1e-2, atol=1e-3)


@pytest.fixture
def interpreted_fused(monkeypatch):
    """The public entry points with the fused kernels in the Pallas
    interpreter (they only interpret when asked)."""
    monkeypatch.setattr(FU, 'fused_selection', functools.partial(
        FU.fused_selection, interpret=True))


def test_dibr_rasterization_fused_backend(interpreted_fused):
    fvi = jnp.array([[
        [[-0.5, -0.5], [0.5, -0.5], [0.0, 0.5]],
    ]])
    fvz = jnp.full((1, 1, 3), -1.)
    ff = jnp.ones(fvz.shape + (1,))
    normals_z = jnp.ones((1, 1))
    feats, soft_mask, fidx = kal.render.mesh.dibr_rasterization(
        32, 32, fvz, fvi, ff, normals_z, sigmainv=70, boxlen=0.2,
        rast_backend='fused')
    feats_j, soft_mask_j, fidx_j = kal.render.mesh.dibr_rasterization(
        32, 32, fvz, fvi, ff, normals_z, sigmainv=70, boxlen=0.2,
        rast_backend='jnp')
    np.testing.assert_array_equal(np.asarray(fidx), np.asarray(fidx_j))
    np.testing.assert_allclose(np.asarray(soft_mask),
                               np.asarray(soft_mask_j), atol=2e-5)
    np.testing.assert_allclose(np.asarray(feats), np.asarray(feats_j),
                               atol=1e-5)


def _model_scene(num_views=2):
    from kaolin_tpu.models import inverse_render as M
    from kaolin_tpu.utils.testing import seeded_uv_sphere
    m = seeded_uv_sphere(80)
    faces = jnp.asarray(m.faces)
    face_uvs = jnp.asarray(np.asarray(m.uvs)[np.asarray(m.face_uvs_idx)])
    params = M.init_params(m, texture_res=16)
    return M, params, M.make_views(num_views), faces, face_uvs


def test_model_selection_fused_path(interpreted_fused):
    """``compute_selection(backend='fused')`` against the 'jnp' one: same
    winners, same gradients through ``render_loss``."""
    M, params, views, faces, face_uvs = _model_scene()
    H = W = 32
    fi_f, sel = M.compute_selection(params, views, faces, H, W,
                                    backend='fused')
    fi_j, kbuf = M.compute_selection(params, views, faces, H, W,
                                     backend='jnp', knum=80)
    np.testing.assert_array_equal(np.asarray(fi_f), np.asarray(fi_j))
    assert isinstance(sel, FU.FusedSelection)

    target_images = jnp.zeros((2, H, W, 3))
    target_masks = jnp.zeros((2, H, W))
    gf = jax.grad(lambda p: M.render_loss(
        p, views, faces, face_uvs, target_images, target_masks, H, W,
        backend='jnp', selection=(fi_f, sel)))(params)
    gj = jax.grad(lambda p: M.render_loss(
        p, views, faces, face_uvs, target_images, target_masks, H, W,
        backend='jnp', selection=(fi_j, kbuf)))(params)
    np.testing.assert_allclose(np.asarray(gf.vertices),
                               np.asarray(gj.vertices),
                               rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize('with_soft_mask', [True, False])
def test_render_views_fused_backend(interpreted_fused, with_soft_mask):
    """``render_views(backend='fused')`` (what 'auto' runs on a GPU)
    against ``backend='jnp'``: images, masks, winners and the loss
    gradient."""
    M, params, views, faces, face_uvs = _model_scene()
    H = W = 32

    def run(backend):
        out = M.render_views(params, views, faces, face_uvs, H, W,
                             backend=backend, knum=80,
                             with_soft_mask=with_soft_mask)
        g = jax.grad(lambda p: M.render_loss(
            p, views, faces, face_uvs, jnp.zeros((2, H, W, 3)),
            jnp.ones((2, H, W)), H, W, backend=backend, knum=80,
            with_soft_mask=with_soft_mask))(params)
        return out, g

    (img_f, mask_f, fi_f), g_f = run('fused')
    (img_j, mask_j, fi_j), g_j = run('jnp')
    np.testing.assert_array_equal(np.asarray(fi_f), np.asarray(fi_j))
    np.testing.assert_allclose(np.asarray(img_f), np.asarray(img_j),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(mask_f), np.asarray(mask_j),
                               atol=2e-5)
    for a, b in zip(g_f, g_j):
        scale = max(float(np.abs(np.asarray(b)).max()), 1e-12)
        np.testing.assert_allclose(np.asarray(a) / scale,
                                   np.asarray(b) / scale, atol=1e-4)


@pytest.mark.parametrize('hw', [(37, 45), (8, 16), (100, 23)])
def test_fused_backward_kernel_matches_dibr(hw):
    """Backward kernel alone, image sizes that are not multiples of the
    8x16 pixel tile and a face count that is not a multiple of the chunk,
    against dibr.py's custom_vjp in float64 (k-buffer covering every
    face)."""
    H, W = hw
    fvz, fvi = random_scene(4, F=37, B=2, spread=0.4)
    fi = rast_mod.rasterize_selection(H, W, fvz, fvi, None, backend='jnp')
    sel = FU.fused_selection(fvz, fvi, None, height=H, width=W,
                             interpret=True)
    w = jnp.asarray(np.random.default_rng(0).normal(size=(2, H, W)),
                    jnp.float32)
    g_f = np.asarray(jax.grad(lambda f: jnp.sum(
        w * FU.softmask_fused(f, sel, (H, W, 1000., 7000.))))(fvi * 1000.))
    with jax.enable_x64(True):
        f64 = jnp.asarray(np.asarray(fvi * 1000.), jnp.float64)
        xs, ys = rast_mod.pixel_coords(H, W, 1000., dtype=jnp.float64)
        kbuf = dibr_mod.dibr_soft_mask_select(fvi, fi, knum=37)
        g_r = np.asarray(jax.grad(lambda f: jnp.sum(
            w * dibr_mod._soft_mask_epilogue(f, kbuf, fi < 0, xs, ys,
                                             7000., 1000.)))(f64))
    scale = np.abs(g_r).max()
    assert scale > 0
    # product division vs exact cumprods: apart where some p ~ 1
    np.testing.assert_allclose(g_f / scale, g_r / scale, atol=1e-3)
    assert np.quantile(np.abs(g_f - g_r), 0.99) / scale < 1e-4


def test_fused_selection_not_interpreted_unasked():
    """Off the GPU the kernels only run when the caller asks for the
    interpreter: a plain call has no kernel to run and fails loudly."""
    fvz, fvi = random_scene(0, F=8, B=1)
    with pytest.raises(Exception):
        jax.block_until_ready(FU.fused_selection(fvz, fvi, None, 16, 16))
