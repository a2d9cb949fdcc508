"""Tests that need a GPU: the Triton-route kernels compiled for the card.

Run on a GPU machine with ``python -m pytest -m gpu``; elsewhere the
``gpu_device`` fixture skips them.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

pytestmark = pytest.mark.gpu


def test_fused_kernels_compile_and_match_jnp(gpu_device):
    """Forward and backward kernels at 512^2, ~10k faces, 2 views."""
    from kaolin_tpu.models import inverse_render as M
    from kaolin_tpu.render.mesh import _fused as FU
    from kaolin_tpu.render.mesh.rasterization import rasterize_selection
    from kaolin_tpu.utils.testing import seeded_uv_sphere

    m = seeded_uv_sphere(10_000)
    params = M.init_params(m, texture_res=16)
    fvc, fvi, fn = M._prepare(params, M.make_views(2), jnp.asarray(m.faces))
    valid = fn[..., 2] >= 0.
    sel = FU.fused_selection(fvc[..., 2], fvi, valid, 512, 512)
    ref = rasterize_selection(512, 512, fvc[..., 2], fvi, valid,
                              backend='jnp')
    assert np.mean(np.asarray(sel.face_idx) == np.asarray(ref)) >= 0.9999
    g = jax.grad(lambda f: jnp.sum(FU.softmask_fused(
        f, sel, (512, 512, 1000., 7000.))))(fvi * 1000.)
    assert bool(jnp.all(jnp.isfinite(g))) and float(jnp.abs(g).max()) > 0


def test_auto_backend_is_fused(gpu_device):
    from kaolin_tpu.render.mesh.rasterization import _resolve_backend
    assert _resolve_backend('auto') == 'fused'


def test_public_entry_points_auto(gpu_device):
    """``dibr_rasterization``, ``compute_selection`` and ``render_views``
    with ``backend='auto'`` run the compiled kernels and match 'jnp'."""
    from kaolin_tpu.models import inverse_render as M
    from kaolin_tpu.render.mesh import _fused as FU
    from kaolin_tpu.render.mesh import dibr_rasterization
    from kaolin_tpu.utils.testing import seeded_uv_sphere

    m = seeded_uv_sphere(10_000)
    faces = jnp.asarray(m.faces)
    face_uvs = jnp.asarray(np.asarray(m.uvs)[np.asarray(m.face_uvs_idx)])
    params = M.init_params(m, texture_res=64)
    views = M.make_views(2)
    H = W = 256
    fi_a, sel = M.compute_selection(params, views, faces, H, W)
    fi_j, _ = M.compute_selection(params, views, faces, H, W, backend='jnp')
    assert isinstance(sel, FU.FusedSelection) and not sel.interpret
    assert np.mean(np.asarray(fi_a) == np.asarray(fi_j)) >= 0.9999

    img_a, mask_a, _ = M.render_views(params, views, faces, face_uvs, H, W)
    img_j, mask_j, _ = M.render_views(params, views, faces, face_uvs, H, W,
                                      backend='jnp', knum=128)
    assert float(jnp.mean(jnp.abs(img_a - img_j))) < 1e-3
    assert float(jnp.mean(jnp.abs(mask_a - mask_j))) < 1e-3

    fvc, fvi, fn = M._prepare(params, views, faces)
    feats = jnp.broadcast_to(fn[:, :, None, :], fn.shape[:2] + (3, 3))
    out_a = dibr_rasterization(H, W, fvc[..., 2], fvi, feats, fn[..., 2])
    out_j = dibr_rasterization(H, W, fvc[..., 2], fvi, feats, fn[..., 2],
                               knum=128, rast_backend='jnp')
    assert np.mean(np.asarray(out_a[2]) == np.asarray(out_j[2])) >= 0.9999
    assert float(jnp.mean(jnp.abs(out_a[1] - out_j[1]))) < 1e-3
