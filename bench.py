"""Benchmark: DIB-R 512x512 fwd+bwd throughput + SPC raytrace throughput.

Prints JSON lines {"metric", "value", "unit", "vs_baseline", ...}; the
LAST stdout line is always the most complete result.  A provisional line
is emitted the moment the first (headline) number exists, so a driver
timeout cannot lose the run's measurement.

Structure:

* ``bench.py`` (no args) is a thin WATCHDOG that never imports JAX: it
  spawns ``bench.py --phases`` as a child, forwards the child's output
  live, and on a hard deadline (BENCH_HARD_CAP_S, default 1200 s) kills
  the child and re-prints the last JSON seen (or an error line) so rc is
  always 0 and stdout always ends in parseable JSON.
* ``--phases`` runs on a GPU only (it exits on any other platform) and
  orders work by value: DIB-R with ``backend='auto'`` first (headline
  Mpixels/s, driver config #2), then SPC raytrace (config #3, rays/s),
  DefTet (config #4), then the pure-XLA ``'jnp'`` baseline for
  ``vs_baseline`` — later phases are skipped when the soft budget
  (BENCH_BUDGET_S, default 900 s) runs out.

Workloads (inputs generated from a seed, ``utils.testing.seeded_uv_sphere``):
* DIB-R (config #2): ~10k-face UV sphere at 512^2 with UV textures + SH
  lighting, gradients to vertices/texture/lighting; a second point at
  ~40k faces.
* SPC (config #3): the ~40k-face sphere voxelized to a level-10 octree on
  the device, 1M camera rays traced into a per-ray k-buffer.

``vs_baseline`` is the speedup of ``backend='auto'`` over the pure-XLA
'jnp' backend on the same device (the reference publishes no absolute
numbers — see BASELINE.md).
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

T0 = time.perf_counter()
# the watchdog forwards every line live, so even if the driver kills this
# process first, everything emitted so far is already in its captured tail
SOFT_BUDGET = float(os.environ.get('BENCH_BUDGET_S', '900'))
HARD_CAP = float(os.environ.get('BENCH_HARD_CAP_S', '1200'))


def _elapsed():
    return time.perf_counter() - T0


def _log(msg):
    print(f'[bench {_elapsed():6.1f}s] {msg}', file=sys.stderr, flush=True)


def _emit(out):
    print(json.dumps(out), flush=True)


# --------------------------------------------------------------------------
# phases (child process)
# --------------------------------------------------------------------------

def _result(mpix, vs_baseline, tris_per_s=None, rays_per_s=None, errors=None):
    out = {
        "metric": "dibr_fwd_bwd_512",
        "value": round(mpix, 3),
        "unit": "Mpixels/s/chip",
        "vs_baseline": round(vs_baseline, 3),
    }
    if tris_per_s is not None:
        out["triangles_per_s"] = round(tris_per_s)
    if rays_per_s is not None:
        out["spc_raytrace_rays_per_s"] = round(rays_per_s)
    if errors:
        out["errors"] = errors
    return out


def _load_mesh(num_faces=10_000):
    import numpy as np
    from kaolin_tpu.utils.testing import seeded_uv_sphere
    mesh = seeded_uv_sphere(num_faces, seed=0)
    _log(f'seeded UV sphere: {np.asarray(mesh.faces).shape[0]} faces')
    return mesh


def _build_dibr(mesh, backend, height, width):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from kaolin_tpu.models import inverse_render as M

    faces = jnp.asarray(np.asarray(mesh.faces))
    face_uvs = jnp.asarray(np.asarray(mesh.uvs)[np.asarray(mesh.face_uvs_idx)])
    params = M.init_params(mesh, texture_res=256)
    views = M.make_views(1)
    target_images = jnp.zeros((1, height, width, 3))
    target_masks = jnp.zeros((1, height, width))

    def selection_raw(p):
        return M.compute_selection(p, views, faces, height, width,
                                   backend=backend)

    grad_raw = jax.grad(
        lambda p, sel: M.render_loss(
            p, views, faces, face_uvs, target_images, target_masks,
            height, width, selection=sel))

    def step_raw(p):
        """One full training step ending in a params-shaped pytree, so
        K steps chain inside a fori_loop (gradient applied with weight
        1e-30 — an untouched trajectory in fp32, but not a multiply
        XLA can constant-fold away like 0.0)."""
        g = grad_raw(p, selection_raw(p))
        return jax.tree_util.tree_map(lambda a, b: a - 1e-30 * b, p, g)

    return step_raw, params, int(faces.shape[0])


def _time_steps(step_fn, params, K):
    """Seconds per step of K dependency-chained steps inside ONE jitted
    fori_loop (one dispatch), after a compile-and-warm-up call."""
    import jax

    @jax.jit
    def multi(p):
        return jax.lax.fori_loop(0, K, lambda i, q: step_fn(q), p)

    jax.block_until_ready(multi(params))     # compile + first run
    t0 = time.perf_counter()
    jax.block_until_ready(multi(params))
    return (time.perf_counter() - t0) / K


def _phase_spc():
    """Config #3: level-10 octree of the ~40k-face sphere, 1M rays.

    The octree build goes through the jit-able DEVICE builder
    (``unbatched_mesh_to_spc_device``); the BFS trace fills a per-ray
    k-buffer with exact per-ray hit counts at knum=128.
    Returns (rays/s, saturation flag (device), total-hit count (device)).
    """
    import numpy as np
    import jax
    import jax.numpy as jnp
    from kaolin_tpu.ops.conversions.trianglemesh import (
        unbatched_mesh_to_spc_device)
    from kaolin_tpu.ops.spc.spc import scan_octrees, generate_points
    from kaolin_tpu.render.spc.raster import unbatched_raytrace_coherent
    from chip_smoke import camera_rays

    level, side = 10, 1024
    mesh = _load_mesh(40_000)
    v = np.asarray(mesh.vertices, np.float64)
    v = v / np.linalg.norm(v, axis=-1).max() * 0.5
    fv = jnp.asarray(v[np.asarray(mesh.faces)], jnp.float32)
    t0 = time.perf_counter()
    octree = np.asarray(unbatched_mesh_to_spc_device(fv, level)[0])
    _log(f'mesh_to_spc DEVICE level={level}: '
         f'{time.perf_counter()-t0:.1f}s')
    _, pyramids, exsum = scan_octrees(octree, np.array([octree.shape[0]]))
    pyr0 = np.asarray(pyramids)[0]
    point_hierarchy = generate_points(jnp.asarray(octree), pyramids, exsum)
    origin, direction = (jnp.asarray(x) for x in camera_rays(side))

    def trace(o):
        return unbatched_raytrace_coherent(
            octree, point_hierarchy, pyr0, exsum, o, direction, level,
            knum=128)

    t0 = time.perf_counter()
    jax.block_until_ready(trace(origin))
    _log(f'raytrace compiled+ran in {time.perf_counter()-t0:.1f}s')
    K = 4
    t0 = time.perf_counter()
    for _ in range(K):
        hits = trace(origin)
    jax.block_until_ready(hits)
    dt = (time.perf_counter() - t0) / K
    _log(f'raytrace: {dt*1e3:.1f} ms/iter')
    return side * side / dt, hits.saturated, jnp.sum(hits.count)


def _phase_dibr_breakdown(mesh, height, width):
    """Per-phase DIB-R timings: selection forward, epilogue forward,
    epilogue backward (``backend='auto'``)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from kaolin_tpu.models import inverse_render as M

    faces = jnp.asarray(np.asarray(mesh.faces))
    face_uvs = jnp.asarray(
        np.asarray(mesh.uvs)[np.asarray(mesh.face_uvs_idx)])
    params = M.init_params(mesh, texture_res=256)
    views = M.make_views(1)
    target_images = jnp.zeros((1, height, width, 3))
    target_masks = jnp.zeros((1, height, width))

    def sel_step(p):
        sel = M.compute_selection(p, views, faces, height, width)
        s0 = sel[0].reshape(-1)[0].astype(jnp.float32)
        return jax.tree_util.tree_map(lambda a: a - 1e-30 * s0, p)

    sel = jax.jit(lambda p: M.compute_selection(
        p, views, faces, height, width))(params)

    def loss_step(p):
        val = M.render_loss(p, views, faces, face_uvs, target_images,
                            target_masks, height, width, selection=sel)
        return jax.tree_util.tree_map(lambda a: a - 1e-30 * val, p)

    grad_fn = jax.grad(lambda p: M.render_loss(
        p, views, faces, face_uvs, target_images, target_masks,
        height, width, selection=sel))

    def grad_step(p):
        g = grad_fn(p)
        return jax.tree_util.tree_map(lambda a, b: a - 1e-30 * b, p, g)

    t_sel = _time_steps(sel_step, params, K=16)
    t_fwd = _time_steps(loss_step, params, K=16)
    t_grad = _time_steps(grad_step, params, K=16)
    phases = {
        'selection_fwd_ms': round(t_sel * 1e3, 3),
        'epilogue_fwd_ms': round(t_fwd * 1e3, 3),
        'epilogue_bwd_ms': round(max(t_grad - t_fwd, 0.) * 1e3, 3),
    }
    _log(f'dibr phases: {phases}')
    return phases


def _phase_deftet(mesh):
    """Config #4: DefTet sparse k-buffer render fwd+bwd at 256^2 over
    the mesh's face soup.  Returns pixels/s (k-buffer depth-sorted render
    + gradient to image-space vertices)."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from kaolin_tpu.models import inverse_render as M
    from kaolin_tpu.render.mesh.deftet import deftet_sparse_render

    H = W = 256
    P = H * W
    knum = 30
    faces = jnp.asarray(np.asarray(mesh.faces))
    params = M.init_params(mesh, texture_res=16)
    views = M.make_views(1)
    fvc, fvi, fn = jax.lax.stop_gradient(M._prepare(params, views, faces))
    fvz = fvc[..., 2]
    ys, xs = jnp.meshgrid(jnp.linspace(-1., 1., H),
                          jnp.linspace(-1., 1., W), indexing='ij')
    pixel_coords = jnp.stack([xs.reshape(-1), ys.reshape(-1)],
                             -1)[None]                       # (1, P, 2)
    render_ranges = jnp.broadcast_to(
        jnp.asarray([[-1e4, 0.]]), (P, 2))[None]
    feats = jnp.broadcast_to(fn[:, :, None, :],
                             fn.shape[:2] + (3, 3))          # normals

    def step(x):
        def loss_fn(fvi_in):
            out, fidx = deftet_sparse_render(
                pixel_coords, render_ranges, fvz, fvi_in, feats,
                knum=knum, max_candidates=2048, pixel_chunk=1024)
            return jnp.sum(jnp.where((fidx >= 0)[..., None], out, 0.))
        g = jax.grad(loss_fn)(x)
        return x - 1e-30 * g

    dt = _time_steps(step, fvi, K=4)
    _log(f'deftet: {dt*1e3:.1f} ms/step -> {P/dt/1e6:.2f} Mpix/s, '
         f'knum={knum}')
    return P / dt


def _device_info():
    """Platform, device kind and count from JAX; name and power limit
    from nvidia-smi (a child process)."""
    import jax
    dev = jax.devices()
    if dev[0].platform != 'gpu':
        return {'platform': dev[0].platform}
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    return {'platform': dev[0].platform, 'kind': dev[0].device_kind,
            'count': len(dev), 'nvidia_smi': smi}


def run_phases():
    height = width = 512
    errors = {}
    from kaolin_tpu.utils import enable_compile_cache
    _log(f'compile cache: {enable_compile_cache()}')
    device = _device_info()
    _log(f'device: {device}')
    if device['platform'] != 'gpu':
        _log('no GPU: nothing to measure')
        sys.exit(2)

    def result(*a, **k):
        out = _result(*a, **k)
        out['device'] = device
        return out

    mesh = _load_mesh()

    # ---- phase 1: DIB-R with backend='auto' (headline) ----------------
    mpix = 0.0
    tris_per_s = None
    try:
        step, params, n_faces = _build_dibr(mesh, 'auto', height, width)
        dt = _time_steps(step, params, K=16)
        mpix = (height * width / dt) / 1e6
        tris_per_s = n_faces / dt
        _log(f'auto: {dt*1e3:.2f} ms/step -> {mpix:.3f} Mpix/s')
    except Exception as e:  # pragma: no cover - defensive
        errors['auto'] = f'{type(e).__name__}: {e}'
        _log(f'auto FAILED: {errors["auto"]}')
    # bank the headline number immediately
    _emit(result(mpix, 0.0, tris_per_s, errors=errors or None))

    # ---- phase 1b: DIB-R phase breakdown + hires triangles point -----
    dibr_phases = None
    hires = None
    if mpix > 0 and _elapsed() < SOFT_BUDGET - 300:
        try:
            dibr_phases = _phase_dibr_breakdown(mesh, height, width)
        except Exception as e:
            errors['dibr_phases'] = f'{type(e).__name__}: {e}'
            _log(f'dibr breakdown FAILED: {errors["dibr_phases"]}')
        try:
            mesh_hi = _load_mesh(40_000)
            step_h, params_h, n_hi = _build_dibr(mesh_hi, 'auto', height,
                                                 width)
            dt_h = _time_steps(step_h, params_h, K=8)
            hires = (n_hi / dt_h, n_hi)
            _log(f'hires dibr ({n_hi} faces): {dt_h*1e3:.2f} ms/step')
        except Exception as e:
            errors['dibr_hires'] = f'{type(e).__name__}: {e}'
            _log(f'dibr hires FAILED: {errors["dibr_hires"]}')

    # ---- phase 2: SPC raytrace (config #3) ---------------------------
    rays_per_s = None
    spc_info = None
    if _elapsed() < SOFT_BUDGET - 120:
        try:
            rays_per_s, spc_sat, spc_cnt = _phase_spc()
            spc_info = (spc_sat, spc_cnt)
            _log(f'spc raytrace: {rays_per_s/1e6:.2f} Mrays/s')
        except Exception as e:
            errors['spc'] = f'{type(e).__name__}: {e}'
            _log(f'spc FAILED: {errors["spc"]}')
        _emit(result(mpix, 0.0, tris_per_s, rays_per_s,
                     errors=errors or None))
    else:
        _log('skipping SPC phase (soft budget)')

    # ---- phase 2b: DefTet k-buffer render (config #4) ----------------
    deftet_pix_per_s = None
    if _elapsed() < SOFT_BUDGET - 90:
        try:
            deftet_pix_per_s = _phase_deftet(mesh)
        except Exception as e:
            errors['deftet'] = f'{type(e).__name__}: {e}'
            _log(f'deftet FAILED: {errors["deftet"]}')
    else:
        _log('skipping deftet phase (soft budget)')

    # ---- phase 3: jnp baseline for vs_baseline -----------------------
    vs_baseline = 0.0
    if mpix > 0 and _elapsed() < SOFT_BUDGET - 60:
        try:
            step_j, params_j, _ = _build_dibr(mesh, 'jnp', height, width)
            dt_j = _time_steps(step_j, params_j, K=4)
            vs_baseline = dt_j * mpix * 1e6 / (height * width)
            _log(f'jnp: {dt_j*1e3:.1f} ms/step -> vs_baseline '
                 f'{vs_baseline:.2f}x')
        except Exception as e:
            errors['jnp'] = f'{type(e).__name__}: {e}'
            _log(f'jnp FAILED: {errors["jnp"]}')
    else:
        _log('skipping jnp baseline (soft budget)')

    out = result(mpix, vs_baseline, tris_per_s, rays_per_s,
                 errors=errors or None)
    if deftet_pix_per_s is not None:
        out["deftet_pixels_per_s"] = round(deftet_pix_per_s)
    if dibr_phases is not None:
        out["dibr_phase_ms"] = dibr_phases
    if hires is not None:
        out["triangles_per_s_hires"] = round(hires[0])
        out["hires_faces"] = hires[1]
    _emit(out)
    if spc_info is not None:
        _log(f'spc saturated={bool(spc_info[0])} '
             f'total_hits={int(spc_info[1])}')


# --------------------------------------------------------------------------
# watchdog (parent process)
# --------------------------------------------------------------------------

def run_watchdog():
    deadline = T0 + HARD_CAP
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--phases'],
        stdout=subprocess.PIPE, stderr=sys.stderr, text=True, bufsize=1)
    last_json = None
    import selectors
    sel = selectors.DefaultSelector()
    sel.register(child.stdout, selectors.EVENT_READ)
    buf = ''
    while True:
        timeout = deadline - time.perf_counter()
        if timeout <= 0:
            break
        if not sel.select(timeout=min(timeout, 1.0)):
            if child.poll() is not None:
                break
            continue
        chunk = child.stdout.readline()
        if chunk == '':
            break
        line = chunk.rstrip('\n')
        if line.startswith('{'):
            try:
                last_json = json.loads(line)
            except ValueError:
                pass
        print(line, flush=True)
    if child.poll() is None and time.perf_counter() >= deadline:
        _log(f'HARD CAP {HARD_CAP:.0f}s reached; killing child '
             f'{child.pid}')
        child.kill()
        child.wait()
        # re-print the freshest banked result as the final line
        if last_json is not None:
            _emit(last_json)
        else:
            _emit(_result(0.0, 0.0, errors={'watchdog': 'hard cap hit '
                                            'before any measurement'}))
    elif child.poll() is None:
        child.wait(timeout=60)  # clean EOF; let the child finish exiting
    child.stdout.close()


if __name__ == '__main__':
    if '--phases' in sys.argv:
        run_phases()
    else:
        run_watchdog()
