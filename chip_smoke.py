"""Smoke test of the main paths on NVIDIA GPUs, compared with the plain
references of this repository.

    python chip_smoke.py              # one GPU: the four phases below
    python chip_smoke.py --cards 4    # four GPUs: the sharded path only

One GPU:

1. kernels — the fused DIB-R kernels at 512^2, ~40k faces, 4 views against
   the 'jnp' selection and the float64 ``dibr.py`` soft mask (value and
   ``custom_vjp`` gradient).
2. train — 5 steps of ``render_loss`` + ``optax.adam`` with
   ``backend='auto'`` (~10k faces, 512^2, 4 views, 256^2 texture, SH
   lighting); the first step's gradients against ``backend='jnp'`` at full
   f32 matmul precision.
3. spc — level-10 octree of the ~40k-face mesh built on the device, 1M
   coherent camera rays traced into the per-ray k-buffer; every hit
   against a float64 slab test of the level's voxels, and a 64k-ray subset
   of the k-buffer against the packed nuggets of ``unbatched_raytrace``.
4. deftet — the binned DefTet k-buffer render (256^2, knum=30), forward
   and backward, against the dense path.

Four GPUs: ``tile_sharded_render_loss`` on a (data, tile) = (2, 2) mesh,
3 steps at 64 views x 1024^2, its loss and gradients on 8 of the views
against the same loss on one GPU, and ``dryrun_multichip(4)``.

Inputs are generated from a seed.  Any failed phase makes the exit code
non-zero.  The last line of stdout is one JSON object naming the device.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

MULT = 1000.     # the renderer's default coordinate multiplier
SIGMAINV = 7000.
BOXLEN = 0.02


def log(msg):
    print(msg, flush=True)


def card_info():
    """``name, power.limit`` per card, from nvidia-smi in a child process
    (which never imports JAX)."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


# ---------------------------------------------------------------------------
# helpers

def compile_timed(name, fn, *args):
    """jit + lower + compile ``fn``; logs compile time and memory."""
    import jax
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    dt = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    if mem is not None:
        mib = lambda b: f'{b / 2 ** 20:.1f} MiB'
        mem = (f'args {mib(mem.argument_size_in_bytes)}, out '
               f'{mib(mem.output_size_in_bytes)}, temp '
               f'{mib(mem.temp_size_in_bytes)}')
    log(f'  [{name}] compile {dt:.2f} s; memory: {mem}')
    return compiled


def timed(fn, *args, reps=1):
    """(result, seconds per call) with ``block_until_ready``."""
    import jax
    out = None
    t0 = time.perf_counter()
    for _ in range(reps):
        out = jax.block_until_ready(fn(*args))
    return out, (time.perf_counter() - t0) / reps


def check(ok, what):
    log(f'  {"PASS" if ok else "FAIL"}: {what}')
    return bool(ok)


def scene(num_faces, views, texture_res, seed=0):
    """(params, cameras, faces, face_uvs) of the seeded UV sphere."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from kaolin_tpu.models import inverse_render as M
    from kaolin_tpu.utils.testing import seeded_uv_sphere
    mesh = seeded_uv_sphere(num_faces, seed=seed)
    faces = np.asarray(mesh.faces)
    face_uvs = np.asarray(mesh.uvs)[np.asarray(mesh.face_uvs_idx)]
    params = M.init_params(mesh, texture_res=texture_res,
                           key=jax.random.key(seed))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    return params, M.make_views(views), jnp.asarray(faces), \
        jnp.asarray(face_uvs)


def max_coverage(fvi_scaled, empty, xs, ys):
    """Most faces whose enlarged bbox covers one empty pixel (the k-buffer
    depth at which ``dibr.py`` equals the uncapped product)."""
    import jax
    import jax.numpy as jnp
    lo = jnp.min(fvi_scaled, axis=-2) - BOXLEN * MULT       # (B, F, 2)
    hi = jnp.max(fvi_scaled, axis=-2) + BOXLEN * MULT

    def row(args):
        y, e, lo_b, hi_b = args
        cov = ((xs[:, None] >= lo_b[None, :, 0])
               & (xs[:, None] < hi_b[None, :, 0])
               & (y >= lo_b[None, :, 1]) & (y < hi_b[None, :, 1]))
        return jnp.max(jnp.where(e, jnp.sum(cov, axis=1), 0))

    def view(args):
        e, lo_b, hi_b = args
        return jnp.max(jax.lax.map(
            lambda ye: row((ye[0], ye[1], lo_b, hi_b)), (ys, e)))
    return int(jnp.max(jax.lax.map(view, (empty, lo, hi))))


def _pow2(n, lo=8):
    return max(lo, 1 << int(max(n, 1) - 1).bit_length())


# ---------------------------------------------------------------------------
# phase 1: fused kernels against the plain references

def z_tie_count(fvz, fvi_scaled, fi, fr, xs, ys):
    """How many disagreeing pixels are z-ties: both faces' planes give the
    same depth (float64, within 1e-5 relative) at the pixel center."""
    import numpy as np
    bad = np.argwhere(fi != fr)
    if bad.shape[0] == 0:
        return 0
    fvz = np.asarray(fvz, np.float64)
    fvi = np.asarray(fvi_scaled, np.float64)
    xs = np.asarray(xs, np.float64)
    ys = np.asarray(ys, np.float64)
    ties = 0
    for b, i, j in bad:
        f1, f2 = fi[b, i, j], fr[b, i, j]
        if f1 < 0 or f2 < 0:
            continue
        zs = []
        for f in (f1, f2):
            v = fvi[b, f] - np.array([xs[j], ys[i]])
            w = np.array([v[1, 0] * v[2, 1] - v[1, 1] * v[2, 0],
                          v[2, 0] * v[0, 1] - v[2, 1] * v[0, 0],
                          v[0, 0] * v[1, 1] - v[0, 1] * v[1, 0]])
            zs.append(np.dot(w / w.sum(), fvz[b, f]))
        ties += abs(zs[0] - zs[1]) <= 1e-5 * max(1., abs(zs[0]))
    return int(ties)


def phase_kernels(num_faces=40_000, res=512, views=4, row_stride=8,
                  interpret=False):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from kaolin_tpu.models import inverse_render as M
    from kaolin_tpu.render.mesh import _fused as FU
    from kaolin_tpu.render.mesh import dibr as D
    from kaolin_tpu.render.mesh.rasterization import (
        pixel_coords, rasterize_selection)

    params, cams, faces, _ = scene(num_faces, views, 16)
    fvc, fvi, fn = jax.lax.stop_gradient(M._prepare(params, cams, faces))
    fvz, valid = fvc[..., 2], fn[..., 2] >= 0.
    log(f'  {views} views, {int(faces.shape[0])} faces, {res}x{res}')

    sel_fn = compile_timed(
        'fused selection (z-buffer + soft-mask product)',
        lambda z, i, v: FU.fused_selection(z, i, v, res, res,
                                           interpret=interpret),
        fvz, fvi, valid)
    ref_fn = compile_timed(
        'jnp selection',
        lambda z, i, v: rasterize_selection(res, res, z, i, v,
                                            backend='jnp'),
        fvz, fvi, valid)
    sel, t_f = timed(sel_fn, fvz, fvi, valid)
    fi_ref, t_j = timed(ref_fn, fvz, fvi, valid)
    log(f'  fused selection {t_f * 1e3:.2f} ms, jnp z-buffer selection '
        f'{t_j * 1e3:.2f} ms')
    fi, fr = np.asarray(sel.face_idx), np.asarray(fi_ref)
    xs, ys = pixel_coords(res, res, MULT)
    fvi_s = fvi * MULT
    n_diff = int((fi != fr).sum())
    ties = z_tie_count(fvz, fvi_s, fi, fr, xs, ys)
    agree = 1. - n_diff / fi.size
    ok = check(agree >= 0.9999 and ties == n_diff,
               f'face_idx agrees on {agree * 100:.4f}% of pixels (>= '
               f'99.99%); {n_diff} differ, {ties} of them z-ties')

    # soft mask on every row_stride-th row, where the selections agree
    rows = np.arange(0, res, row_stride)
    ys_r = ys[rows]
    empty_r = jnp.asarray(fr[:, rows] < 0)
    weight = np.random.default_rng(1).normal(size=empty_r.shape)
    weight = jnp.asarray((weight * (fi[:, rows] == fr[:, rows]))
                         .astype(np.float32))
    K = _pow2(max_coverage(fvi_s, empty_r, xs, ys_r))
    bboxes = jnp.concatenate([jnp.min(fvi_s, axis=-2) - BOXLEN * MULT,
                              jnp.max(fvi_s, axis=-2) + BOXLEN * MULT], -1)
    kbuf = jax.jit(lambda bb, e: jax.lax.map(
        lambda a: D._soft_mask_select(a[0], a[1], xs, ys_r,
                                      height=rows.size, width=res, knum=K),
        (bb, e)))(bboxes, empty_r)
    log(f'  soft mask on {rows.size} rows: k-buffer depth {K} covers every '
        f'pixel')
    config = (res, res, MULT, SIGMAINV)

    def fused_loss(fs):
        m = FU.softmask_fused(fs, sel, config)[:, rows]
        return jnp.sum(weight * m), m

    (_, mask_f), g_f = jax.jit(jax.value_and_grad(
        fused_loss, has_aux=True))(fvi_s)
    with jax.enable_x64(True):
        f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)

        def ref_loss(fs):
            m = D._soft_mask_epilogue(fs, kbuf, empty_r, f64(xs), f64(ys_r),
                                      SIGMAINV, MULT)
            return jnp.sum(f64(weight) * m), m
        (_, mask_r), g_r = jax.jit(jax.value_and_grad(
            ref_loss, has_aux=True))(f64(fvi_s))
        mask_r, g_r = np.asarray(mask_r), np.asarray(g_r)
    same = np.asarray(weight) != 0
    err = float(np.abs(np.asarray(mask_f) - mask_r)[same].max())
    ok &= check(err <= 1e-5, f'soft mask vs float64 dibr.py: max abs err '
                f'{err:.2e} (atol 1e-5; kernel f32)')
    g_f = np.asarray(g_f)
    scale = float(np.abs(g_r).max())
    gerr = float(np.abs(g_f - g_r).max()) / scale
    p999 = float(np.quantile(np.abs(g_f - g_r), 0.999)) / scale
    ok &= check(gerr <= 1e-3,
                f'soft-mask gradient vs float64 dibr.py custom_vjp: max '
                f'|diff| / max|g| = {gerr:.2e} (rtol 1e-3, relative to the '
                f'largest entry; 99.9th pct {p999:.2e}); the kernel divides '
                f'the product where dibr.py takes exact cumprods')
    return ok, {'fused_selection_ms': t_f * 1e3,
                'jnp_zbuffer_selection_ms': t_j * 1e3}


# ---------------------------------------------------------------------------
# phase 2: the training step on the main path

def phase_train(num_faces=10_000, res=512, views=4, texture_res=256,
                steps=5, backend='auto'):
    import numpy as np
    import jax
    import jax.numpy as jnp
    import optax
    from kaolin_tpu.models import inverse_render as M
    from kaolin_tpu.render.mesh.rasterization import (
        pixel_coords, rasterize_selection)

    target, cams, faces, face_uvs = scene(num_faces, views, texture_res)
    render = jax.jit(lambda p: M.render_views(
        p, cams, faces, face_uvs, res, res, backend=backend)[:2])
    t_img, t_mask = render(target)
    key = jax.random.key(1)
    params = target._replace(
        vertices=target.vertices * 0.9,
        texture_map=jax.random.uniform(key, target.texture_map.shape))
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    def step(p, s):
        loss, g = jax.value_and_grad(M.render_loss)(
            p, cams, faces, face_uvs, t_img, t_mask, res, res,
            backend=backend)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss, g

    log(f'  {views} views, {int(faces.shape[0])} faces, {res}x{res}, '
        f'texture {texture_res}^2, SH lighting, backend={backend!r}')
    step_c = compile_timed('train step', step, params, opt_state)
    p, s = params, opt_state
    losses, times, g1 = [], [], None
    finite = True
    for i in range(steps):
        (p, s, loss, g), dt = timed(step_c, p, s)
        g1 = g if g1 is None else g1
        losses.append(float(loss))
        times.append(dt)
        finite &= bool(np.isfinite(float(loss))) and all(
            bool(jnp.all(jnp.isfinite(x)))
            for x in jax.tree_util.tree_leaves(g))
    log('  step ms: ' + ', '.join(f'{t * 1e3:.2f}' for t in times)
        + '; loss: ' + ', '.join(f'{x:.5f}' for x in losses))
    ok = check(finite, f'{steps} steps: loss and gradients finite')

    # reference: 'jnp' path, k-buffer deep enough to hold every covering
    # face (the fused product is uncapped), full-f32 matmuls
    fvc, fvi, fn = M._prepare(params, cams, faces)
    xs, ys = pixel_coords(res, res, MULT)
    empty = rasterize_selection(res, res, fvc[..., 2], fvi, fn[..., 2] >= 0.,
                                backend='jnp') < 0
    K = _pow2(max_coverage(fvi * MULT, empty, xs, ys))
    with jax.default_matmul_precision('highest'):
        g_ref = jax.jit(jax.grad(lambda p: M.render_loss(
            p, cams, faces, face_uvs, t_img, t_mask, res, res,
            backend='jnp', knum=K)))(params)
    for name, a, b in zip(params._fields, g1, g_ref):
        a, b = np.asarray(a), np.asarray(b)
        err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        ok &= check(err <= 2e-4, f'step-1 grad {name} vs jnp (k-buffer '
                    f'{K}, precision highest): max |diff| / max|g| = '
                    f'{err:.2e} (rtol 2e-4; a TF32 matmul is off by ~1e-3)')
    return ok, {'step_ms': [t * 1e3 for t in times[1:]],
                'first_step_s': times[0]}


# ---------------------------------------------------------------------------
# phase 3: SPC octree + coherent ray trace

def camera_rays(side):
    import numpy as np
    ys, xs = np.meshgrid(np.linspace(-0.9, 0.9, side),
                         np.linspace(-0.9, 0.9, side), indexing='ij')
    o = np.stack([xs.ravel(), ys.ravel(), np.full(side * side, -2.5)], -1)
    d = np.stack([xs.ravel() * 0.1, ys.ravel() * 0.1,
                  np.ones(side * side)], -1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def camera_ray_pairs(points, level, side, chunk=1 << 16):
    """(ray, voxel) pairs that can meet among the rays of
    ``camera_rays(side)``, for the brute-force reference.

    Ray ``(i, j)`` starts at ``(x0, y0, -2.5)`` with ``x0``, ``y0`` the
    j-th and i-th grid values and moves along ``(0.1 x0, 0.1 y0, 1)``, so
    at depth ``z`` it is at ``x0 * f(z)``, ``y0 * f(z)`` with
    ``f(z) = 1 + 0.1 (z + 2.5) > 0``.  A voxel can only be met by the
    grid columns and rows whose ``x0``, ``y0`` fall in its bounds divided
    by ``f`` over its depth span; one more column and row on each side
    absorb rounding.
    """
    import numpy as np
    s = 2. / (1 << level)
    step = 1.8 / (side - 1)
    rays, voxels = [], []
    for c in range(0, points.shape[0], chunk):
        lo = np.asarray(points[c:c + chunk], np.float64) * s - 1.
        hi = lo + s
        f = 1. + 0.1 * (np.stack([lo[:, 2], hi[:, 2]], -1) + 2.5)

        def grid_range(a, b):
            lo_ = np.minimum(a / f[:, 0], a / f[:, 1])
            hi_ = np.maximum(b / f[:, 0], b / f[:, 1])
            first = np.floor((lo_ + 0.9) / step).astype(np.int64) - 1
            last = np.ceil((hi_ + 0.9) / step).astype(np.int64) + 1
            return np.clip(first, 0, side), np.clip(last, -1, side - 1)
        j0, j1 = grid_range(lo[:, 0], hi[:, 0])
        i0, i1 = grid_range(lo[:, 1], hi[:, 1])
        nj = max(int((j1 - j0).max()) + 1, 0)
        ni = max(int((i1 - i0).max()) + 1, 0)
        dj = np.arange(nj)[None, None, :]
        di = np.arange(ni)[None, :, None]
        jj = j0[:, None, None] + dj
        ii = i0[:, None, None] + di
        ok = (jj <= j1[:, None, None]) & (ii <= i1[:, None, None])
        vid = np.broadcast_to(np.arange(c, c + lo.shape[0])[:, None, None],
                              ok.shape)
        rays.append((ii * side + jj)[ok])
        voxels.append(vid[ok])
    return np.concatenate(rays), np.concatenate(voxels)


def phase_spc(num_faces=40_000, level=10, side=1024, stride=16, knum=128):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from kaolin_tpu.ops.conversions.trianglemesh import (
        unbatched_mesh_to_spc_device)
    from kaolin_tpu.ops.spc.spc import generate_points, scan_octrees
    from kaolin_tpu.render.spc.raster import (
        CoherentHits, hits_to_nuggets, unbatched_raytrace_coherent)
    from kaolin_tpu.render.spc.raytrace import unbatched_raytrace
    from kaolin_tpu.utils.testing import (
        compare_ray_hits, ray_voxel_hits, seeded_uv_sphere)

    mesh = seeded_uv_sphere(num_faces, seed=0)
    v = np.asarray(mesh.vertices, np.float64)
    v = v / np.linalg.norm(v, axis=-1).max() * 0.5
    fv = jnp.asarray(v[np.asarray(mesh.faces)], jnp.float32)
    t0 = time.perf_counter()
    octree, *_ = jax.block_until_ready(unbatched_mesh_to_spc_device(fv,
                                                                    level))
    t_build = time.perf_counter() - t0
    octree = np.asarray(octree)
    _, pyramids, exsum = scan_octrees(octree, np.array([octree.shape[0]]))
    pyr = np.asarray(pyramids)[0]
    ph = generate_points(jnp.asarray(octree), pyramids, exsum)
    log(f'  level-{level} octree of {fv.shape[0]} faces: '
        f'{int(pyr[0, level])} voxels, built in {t_build:.2f} s (compile '
        f'included)')
    o_np, d_np = camera_rays(side)
    o, d = jnp.asarray(o_np), jnp.asarray(d_np)
    trace = compile_timed(
        'trace to k-buffer',
        lambda o_, d_: unbatched_raytrace_coherent(
            octree, ph, pyr, exsum, o_, d_, level, knum=knum), o, d)
    hits, t_trace = timed(trace, o, d)
    log(f'  {side * side} rays: {t_trace * 1e3:.2f} ms '
        f'({side * side / t_trace / 1e6:.2f} Mrays/s); '
        f'{int(jnp.sum(hits.count))} hits')
    ok = check(not bool(hits.saturated), 'no buffer saturated')

    # every ray against a float64 slab test of the level's voxels, which
    # shares no code with the BFS
    off, nvox = int(pyr[1, level]), int(pyr[0, level])
    pts = np.asarray(ph[off:off + nvox])
    t0 = time.perf_counter()
    ref = ray_voxel_hits(pts, level, o_np, d_np,
                         *camera_ray_pairs(pts, level, side))
    ridx, pidx, depths = (np.asarray(x) for x in hits_to_nuggets(hits))
    cmp = compare_ray_hits(ridx, pidx - off, depths, ref, nvox)
    ok &= check(cmp['missing'] == 0 and cmp['extra'] == 0
                and cmp['depth_err'] <= 1e-5,
                f'all rays vs float64 slab test: {cmp["traced"]} traced, '
                f'{cmp["reference"]} reference hits, {cmp["missing"]} '
                f'missing, {cmp["extra"]} extra, {cmp["grazing"]} grazing '
                f'pairs (within 1e-5 of a voxel boundary, either way); '
                f'depth max diff {cmp["depth_err"]:.1e} (atol 1e-5); '
                f'{time.perf_counter() - t0:.1f} s on the host')
    sub = CoherentHits(*(x[::stride] for x in hits[:4]), hits.saturated)

    def table(ridx, pidx, depths):
        t = np.concatenate([np.stack([ridx, pidx], -1).astype(np.float64),
                            np.asarray(depths, np.float64)], -1)
        return t[np.lexsort((t[:, 1], t[:, 0]))]
    a = table(*hits_to_nuggets(sub))
    b = table(*unbatched_raytrace(octree, ph, pyr, exsum, o[::stride],
                                  d[::stride], level, with_exit=True))
    same = a.shape == b.shape and bool((a[:, :2] == b[:, :2]).all())
    derr = float(np.abs(a[:, 2:] - b[:, 2:]).max()) if same and len(a) else 0.
    ok &= check(same and derr <= 1e-6,
                f'{o[::stride].shape[0]}-ray subset: {a.shape[0]} k-buffer '
                f'hits vs {b.shape[0]} unbatched_raytrace nuggets; same '
                f'(ray, voxel) list: {same}; depth max diff {derr:.1e}')
    return ok, {'trace_ms': t_trace * 1e3, 'build_s': t_build}


# ---------------------------------------------------------------------------
# phase 4: DefTet binned k-buffer render

def phase_deftet(num_faces=10_000, res=256, knum=30, max_candidates=4096,
                 pixel_chunk=1024):
    import numpy as np
    import jax
    import jax.numpy as jnp
    from kaolin_tpu.models import inverse_render as M
    from kaolin_tpu.render.mesh.deftet import deftet_sparse_render

    params, cams, faces, _ = scene(num_faces, 1, 16)
    fvc, fvi, fn = jax.lax.stop_gradient(M._prepare(params, cams, faces))
    ys, xs = jnp.meshgrid(jnp.linspace(-1., 1., res),
                          jnp.linspace(-1., 1., res), indexing='ij')
    pix = jnp.stack([xs.reshape(-1), ys.reshape(-1)], -1)[None]
    ranges = jnp.broadcast_to(jnp.asarray([[-1e4, 0.]]), (res * res, 2))[None]
    feats = jnp.broadcast_to(fn[:, :, None, :], fn.shape[:2] + (3, 3))

    def run(fvi_in, **kw):
        def loss(f):
            out, fidx = deftet_sparse_render(pix, ranges, fvc[..., 2], f,
                                             feats, knum=knum, **kw)
            return jnp.sum(jnp.where((fidx >= 0)[..., None], out, 0.)), (
                out, fidx)
        (_, (out, fidx)), g = jax.value_and_grad(loss, has_aux=True)(fvi_in)
        return out, fidx, g

    binned = compile_timed('deftet binned fwd+bwd', lambda f: run(
        f, max_candidates=max_candidates, pixel_chunk=pixel_chunk), fvi)
    dense = compile_timed('deftet dense fwd+bwd', run, fvi)
    (ob, ib, gb), t_b = timed(binned, fvi)
    (od, i_d, gd), t_d = timed(dense, fvi)
    log(f'  {int(faces.shape[0])} faces, {res}x{res}, knum={knum}: binned '
        f'{t_b * 1e3:.2f} ms, dense {t_d * 1e3:.2f} ms')
    ib, i_d = np.asarray(ib), np.asarray(i_d)
    ok = check((ib == i_d).all(), f'face ids identical ({int((ib >= 0).sum())}'
               f' k-buffer entries, max id {int(ib.max())})')
    ferr = float(np.abs(np.asarray(ob) - np.asarray(od)).max())
    ok &= check(ferr <= 1e-5, f'features max abs diff {ferr:.1e} (atol 1e-5)')
    gb, gd = np.asarray(gb), np.asarray(gd)
    gerr = float(np.abs(gb - gd).max() / max(np.abs(gd).max(), 1e-30))
    ok &= check(gerr <= 1e-4, f'gradient max |diff| / max|g| {gerr:.1e} '
                '(rtol 1e-4)')
    return ok, {'binned_ms': t_b * 1e3, 'dense_ms': t_d * 1e3}


# ---------------------------------------------------------------------------
# four cards: the (data, tile) sharded render loss

def phase_sharded(views=64, res=1024, num_faces=10_000, steps=3,
                  sub_views=8, mesh_shape=(2, 2)):
    import numpy as np
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from kaolin_tpu.models import inverse_render as M
    from kaolin_tpu.parallel import make_mesh, replicate
    from kaolin_tpu.parallel.tile import tile_sharded_render_loss

    params, cams, faces, face_uvs = scene(num_faces, views, 256)
    mesh = make_mesh(mesh_shape, ('data', 'tile'))
    rng = np.random.default_rng(0)
    t_img = rng.uniform(size=(views, res, res, 3)).astype(np.float32)
    t_mask = (rng.uniform(size=(views, res, res)) > 0.5).astype(np.float32)

    def loss_on(m):
        return lambda p, rot, trans, ti, tm: tile_sharded_render_loss(
            m, p, M.CameraViews(rot, trans, cams.camera_proj), faces,
            face_uvs, ti, tm, res, res)

    def put(m, x):
        return jax.device_put(x, NamedSharding(m, P('data')))

    opt = optax.adam(1e-3)
    loss_fn = loss_on(mesh)

    def step(p, s, rot, trans, ti, tm):
        loss, g = jax.value_and_grad(loss_fn)(p, rot, trans, ti, tm)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    args = [put(mesh, x) for x in (cams.camera_rot, cams.camera_trans,
                                   t_img, t_mask)]
    p = replicate(mesh, params)
    s = replicate(mesh, opt.init(params))
    log(f'  mesh (data, tile) = {mesh_shape}, {views} views, {res}x{res}, '
        f'{int(faces.shape[0])} faces')
    step_c = compile_timed('sharded train step', step, p, s, *args)
    times, finite = [], True
    for _ in range(steps):
        (p, s, loss), dt = timed(step_c, p, s, *args)
        times.append(dt)
        finite &= bool(np.isfinite(float(loss)))
    log('  step s: ' + ', '.join(f'{t:.3f}' for t in times)
        + f' ({views / min(times):.2f} views/s)')
    ok = check(finite, f'{steps} sharded steps finite')

    # 8 views: the same loss on the mesh and on one card
    one = make_mesh((1, 1), ('data', 'tile'), devices=jax.devices()[:1])
    sub = (cams.camera_rot[:sub_views], cams.camera_trans[:sub_views],
           t_img[:sub_views], t_mask[:sub_views])
    vg = lambda m: jax.jit(jax.value_and_grad(loss_on(m)))
    l4, g4 = vg(mesh)(replicate(mesh, params), *[put(mesh, x) for x in sub])
    l1, g1 = vg(one)(replicate(one, params), *[put(one, x) for x in sub])
    lerr = abs(float(l4) - float(l1)) / abs(float(l1))
    ok &= check(lerr <= 1e-5, f'{sub_views}-view loss, {mesh_shape} mesh vs '
                f'one card: rel diff {lerr:.1e} (rtol 1e-5)')
    for name, a, b in zip(params._fields, g4, g1):
        a, b = np.asarray(a), np.asarray(b)
        err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
        ok &= check(err <= 1e-4, f'grad {name}: max |diff| / max|g| '
                    f'{err:.1e} (rtol 1e-4)')
    import __graft_entry__
    __graft_entry__.dryrun_multichip(4, num_faces=num_faces)
    return ok, {'step_s': times}


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--cards', type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    from kaolin_tpu.utils import enable_compile_cache
    cache = enable_compile_cache()
    import jax
    dev = jax.devices()[0]
    if dev.platform != 'gpu':
        log(f'no GPU: JAX runs on {dev.platform}')
        return 2
    if len(jax.devices()) < args.cards:
        log(f'{args.cards} GPUs asked, {len(jax.devices())} found')
        return 2
    log(card_info())
    log(f'jax {jax.__version__}; {dev.device_kind} x {len(jax.devices())}; '
        f'compile cache {cache}')

    phases = ([('sharded', phase_sharded)] if args.cards == 4 else
              [('kernels', phase_kernels), ('train', phase_train),
               ('spc', phase_spc), ('deftet', phase_deftet)])
    ok = True
    for name, fn in phases:
        log(f'phase {name}')
        t0 = time.perf_counter()
        passed, _ = fn()
        log(f'phase {name}: {"ok" if passed else "FAILED"} in '
            f'{time.perf_counter() - t0:.1f} s')
        ok &= passed
    if not ok:
        return 1
    print(json.dumps({'ok': True, 'device': {
        'platform': dev.platform, 'kind': dev.device_kind,
        'count': len(jax.devices())}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
