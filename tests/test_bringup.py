"""CPU tests of the GPU bring-up: backend choice, compile cache, generated
inputs, DefTet ids past 2048, Pallas routes, and chip_smoke.py's phases at
tiny sizes (kernels interpreted)."""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from kaolin_tpu.utils.testing import seeded_uv_sphere  # noqa: E402


@pytest.mark.parametrize('platform,backend,expected', [
    ('gpu', 'auto', 'fused'), ('cpu', 'auto', 'jnp'), ('cpu', 'jnp', 'jnp'),
    ('gpu', 'jnp', 'jnp'), ('cpu', 'fused', 'fused')])
def test_resolve_backend(monkeypatch, platform, backend, expected):
    from kaolin_tpu.render.mesh import rasterization
    monkeypatch.setattr(rasterization.jax, 'default_backend',
                        lambda: platform)
    assert rasterization._resolve_backend(backend) == expected


def test_compile_cache_honours_env(monkeypatch):
    from kaolin_tpu.utils import compile_cache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', '/some/where')
    assert compile_cache.enable_compile_cache() == '/some/where'
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_path(monkeypatch):
    from kaolin_tpu.utils import compile_cache
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    path = compile_cache.enable_compile_cache()
    assert path == os.path.join(REPO, '.jax_cache')
    assert jax.config.jax_compilation_cache_dir == path


@pytest.mark.parametrize('num_faces,expected', [
    (10_000, 9680), (40_000, 40500), (320, 320), (80, 80)])
def test_seeded_uv_sphere_counts(num_faces, expected):
    m = seeded_uv_sphere(num_faces)
    f = np.asarray(m.faces)
    v = np.asarray(m.vertices)
    assert f.shape == (expected, 3) and f.dtype == np.int32
    edges = {tuple(sorted(e)) for t in f.tolist()
             for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0]))}
    assert v.shape[0] - len(edges) + f.shape[0] == 2     # closed sphere
    fv = v[f]
    n = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    assert np.all(np.sum(n * fv.mean(1), -1) > 0)       # wound outward
    uv = np.asarray(m.uvs)
    assert uv.shape == (v.shape[0], 2) and uv.min() >= 0 and uv.max() <= 1


def test_seeded_uv_sphere_deterministic():
    a, b = seeded_uv_sphere(320, seed=3), seeded_uv_sphere(320, seed=3)
    c = seeded_uv_sphere(320, seed=4)
    np.testing.assert_array_equal(np.asarray(a.vertices),
                                  np.asarray(b.vertices))
    np.testing.assert_array_equal(np.asarray(a.faces), np.asarray(c.faces))
    assert not np.array_equal(np.asarray(a.vertices), np.asarray(c.vertices))


def test_deftet_binned_ids_past_2048():
    """Face ids above 2048 (inexact if they ever went through a TF32
    product) come back exactly from the binned engine."""
    from kaolin_tpu.render.mesh.deftet import deftet_sparse_render
    rng = np.random.default_rng(0)
    F, res = 3000, 24
    cent = rng.uniform(-0.9, 0.9, (1, F, 1, 2))
    fvi = jnp.asarray(cent + rng.uniform(-0.15, 0.15, (1, F, 3, 2)),
                      jnp.float32)
    fvz = jnp.asarray(-rng.uniform(1., 3., (1, F, 3)), jnp.float32)
    feats = jnp.asarray(rng.normal(size=(1, F, 3, 2)), jnp.float32)
    ys, xs = jnp.meshgrid(jnp.linspace(-1., 1., res),
                          jnp.linspace(-1., 1., res), indexing='ij')
    pix = jnp.stack([xs.reshape(-1), ys.reshape(-1)], -1)[None]
    ranges = jnp.broadcast_to(jnp.asarray([[-1e4, 0.]]), (res * res, 2))[None]
    out_b, ids_b = deftet_sparse_render(pix, ranges, fvz, fvi, feats,
                                        knum=16, max_candidates=F,
                                        pixel_chunk=64)
    out_d, ids_d = deftet_sparse_render(pix, ranges, fvz, fvi, feats,
                                        knum=16)
    ids_b = np.asarray(ids_b)
    assert ids_b.max() > 2048
    np.testing.assert_array_equal(ids_b, np.asarray(ids_d))
    np.testing.assert_allclose(np.asarray(out_b), np.asarray(out_d),
                               atol=1e-5)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module
            yield from (f'{node.module}.{a.name}' for a in node.names)


def test_pallas_imports_are_gpu_routes():
    """Pallas is imported only as the core API or a GPU route."""
    files = [os.path.join(d, f) for top in ('kaolin_tpu', 'tests', 'examples')
             for d, _, fs in os.walk(os.path.join(REPO, top))
             for f in fs if f.endswith('.py')]
    files += [os.path.join(REPO, f) for f in
              ('bench.py', '__graft_entry__.py', 'chip_smoke.py')]
    routes = ('triton', 'mosaic_gpu')
    mods = [(f, m) for f in files for m in _imports(f)
            if m.startswith('jax.experimental.pallas.')]
    bad = [(f, m) for f, m in mods if m.split('.')[3] not in routes]
    assert len(files) > 100 and mods and not bad


def test_chip_smoke_phase_kernels_tiny():
    ok, info = chip_smoke.phase_kernels(num_faces=320, res=32, views=2,
                                        row_stride=4, interpret=True)
    assert ok and info['fused_selection_ms'] > 0


def test_chip_smoke_phase_train_tiny():
    ok, info = chip_smoke.phase_train(num_faces=320, res=32, views=2,
                                      texture_res=16, steps=2,
                                      backend='jnp')
    assert ok and len(info['step_ms']) == 1


def test_chip_smoke_phase_spc_tiny():
    ok, _ = chip_smoke.phase_spc(num_faces=320, level=5, side=32, stride=4,
                                 knum=64)
    assert ok


@pytest.mark.parametrize('level,side', [(4, 24), (6, 40)])
def test_camera_ray_pairs_conservative(level, side):
    """The candidate pairs of chip_smoke's SPC check hold every pair the
    all-pairs brute force finds near a hit."""
    from kaolin_tpu.utils.testing import ray_voxel_hits
    rng = np.random.default_rng(level)
    pts = rng.integers(0, 2 ** level, size=(500, 3))
    o, d = chip_smoke.camera_rays(side)
    r, v = chip_smoke.camera_ray_pairs(pts, level, side, chunk=128)
    assert r.shape[0] < o.shape[0] * pts.shape[0] // 4
    full = ray_voxel_hits(pts, level, o, d)
    some = ray_voxel_hits(pts, level, o, d, r, v)
    assert full[0].shape[0] > 0
    key = lambda h: set(zip(h[0].tolist(), h[1].tolist()))
    assert key(full) == key(some)


def test_chip_smoke_phase_deftet_tiny():
    ok, _ = chip_smoke.phase_deftet(num_faces=320, res=32, knum=8,
                                    max_candidates=512, pixel_chunk=128)
    assert ok


def test_chip_smoke_phase_sharded_tiny():
    if len(jax.devices()) < 4:
        pytest.skip('needs 4 virtual devices')
    ok, info = chip_smoke.phase_sharded(views=4, res=16, num_faces=80,
                                        steps=2, sub_views=2)
    assert ok and len(info['step_s']) == 2


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS='cpu')
    out = subprocess.run([sys.executable, os.path.join(REPO, 'chip_smoke.py')],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode != 0
    for line in out.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)
