"""Tests of the per-ray k-buffer tracer (``render/spc/raster.py``).

``unbatched_raytrace_coherent`` must return exactly the packed nuggets of
``unbatched_raytrace``, ray by ray and near to far, and both must agree
with a float64 brute-force slab test of every ray against every voxel of
the level (``utils.testing.ray_voxel_hits``), up to pairs that graze a
voxel boundary.  Cases: random octrees with camera-style ray grids,
axis-aligned rays, rays starting inside the volume, and overflow of both
capacities.
"""
import numpy as np
import pytest

from kaolin_tpu.render import spc as spc_render
from kaolin_tpu.render.spc.raster import (
    unbatched_raytrace_coherent, hits_to_nuggets)
from kaolin_tpu.utils.testing import compare_ray_hits, ray_voxel_hits

from tests.test_spc_raytrace import build


def camera_grid(side, z=-2.5, spread=0.1, extent=0.9):
    ys, xs = np.meshgrid(np.linspace(-extent, extent, side),
                         np.linspace(-extent, extent, side), indexing='ij')
    o = np.stack([xs.ravel(), ys.ravel(), np.full(side * side, z)], -1)
    d = np.stack([xs.ravel() * spread, ys.ravel() * spread,
                  np.ones(side * side)], -1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def nugget_table(ridx, pidx, depths):
    """(n, 4) float table [ray, t_near, pidx, t_far], rows as given."""
    return np.stack([np.asarray(ridx, np.float64),
                     np.asarray(depths)[:, 0].astype(np.float64),
                     np.asarray(pidx, np.float64),
                     np.asarray(depths)[:, 1].astype(np.float64)], -1)


def reference_check(ph, pyramid, o, d, level, ridx, pidx, depths):
    """Traced hits against the float64 brute-force slab test."""
    off, nvox = int(pyramid[1, level]), int(pyramid[0, level])
    pts = np.asarray(ph[off:off + nvox])
    cmp = compare_ray_hits(np.asarray(ridx), np.asarray(pidx) - off,
                           depths, ray_voxel_hits(pts, level, o, d), nvox)
    assert cmp['missing'] == 0 and cmp['extra'] == 0, cmp
    assert cmp['depth_err'] <= 1e-5, cmp
    return cmp


def assert_matches(octree, pyramid, exsum, ph, o, d, level, knum=64):
    """k-buffer == packed BFS nuggets (exactly, in order) == brute force."""
    hits = unbatched_raytrace_coherent(
        octree, ph, pyramid, exsum, o, d, level, knum=knum)
    assert not bool(hits.saturated), 'raise knum in the test'
    ta = nugget_table(*hits_to_nuggets(hits))
    ridx, pidx, depths = spc_render.unbatched_raytrace(
        octree, ph, pyramid, exsum, o, d, level, with_exit=True)
    np.testing.assert_array_equal(ta, nugget_table(ridx, pidx, depths))
    reference_check(ph, pyramid, o, d, level, ridx, pidx,
                    np.asarray(depths))
    return ta


class TestCoherentKBuffer:
    @pytest.mark.parametrize('level', [2, 4, 6])
    def test_random_octree_camera_grid(self, level):
        rng = np.random.default_rng(level)
        pts = rng.integers(0, 2 ** level, size=(400, 3))
        octree, pyramid, exsum, ph = build(pts, level)
        o, d = camera_grid(24)
        ta = assert_matches(octree, pyramid, exsum, ph, o, d, level)
        assert ta.shape[0] > 0

    @pytest.mark.parametrize('knum', [4, 64])
    def test_kbuffer_layout(self, knum):
        """Exact per-ray counts, near-to-far live prefix, inf / -1
        padding, and saturation exactly when a ray overflows ``knum``."""
        level = 4
        rng = np.random.default_rng(14)
        pts = rng.integers(2, 2 ** level - 2, size=(300, 3))
        octree, pyramid, exsum, ph = build(pts, level)
        o, d = camera_grid(16, extent=1.2)   # edge rays miss everything
        hits = unbatched_raytrace_coherent(
            octree, ph, pyramid, exsum, o, d, level, knum=knum)
        ridx, _ = spc_render.unbatched_raytrace(
            octree, ph, pyramid, exsum, o, d, level, return_depth=False)
        count = np.bincount(np.asarray(ridx), minlength=o.shape[0])
        np.testing.assert_array_equal(np.asarray(hits.count), count)
        assert bool(hits.saturated) == bool(count.max() > knum)
        live = np.arange(knum)[None] < np.minimum(count, knum)[:, None]
        tn, tf, pidx = (np.asarray(x) for x in hits[:3])
        assert np.all(pidx[live] >= 0) and np.all(pidx[~live] == -1)
        assert np.all(np.isinf(tn[~live])) and np.all(np.isinf(tf[~live]))
        assert np.all(tf[live] > tn[live])
        assert np.all(np.diff(np.where(live, tn, 1e30), axis=1) >= 0)
        assert 0 < count.max() and count.min() == 0

    def test_knum_overflow_saturates(self):
        """Hits past ``knum`` are dropped from the k-buffer, still
        counted, and flag saturation."""
        level = 3
        pts = np.stack(np.meshgrid(*[np.arange(8)] * 3,
                                   indexing='ij'), -1).reshape(-1, 3)
        octree, pyramid, exsum, ph = build(pts, level)
        o = np.array([[0.01, 0.02, -2.]], np.float32)
        d = np.array([[0., 0., 1.]], np.float32)
        hits = unbatched_raytrace_coherent(
            octree, ph, pyramid, exsum, o, d, level, knum=4)
        assert int(hits.count[0]) == 8 and bool(hits.saturated)
        assert np.all(np.asarray(hits.pidx[0]) >= 0)
        assert np.all(np.diff(np.asarray(hits.t_near[0])) > 0)

    def test_nugget_overflow_saturates(self):
        """A traversal that overflows ``max_nuggets`` flags saturation."""
        level = 3
        pts = np.stack(np.meshgrid(*[np.arange(8)] * 3,
                                   indexing='ij'), -1).reshape(-1, 3)
        octree, pyramid, exsum, ph = build(pts, level)
        o = np.array([[0.01, 0.02, -2.], [0.3, -0.4, -2.]], np.float32)
        d = np.array([[0., 0., 1.], [0., 0., 1.]], np.float32)
        full = unbatched_raytrace_coherent(
            octree, ph, pyramid, exsum, o, d, level, knum=16)
        assert not bool(full.saturated)
        np.testing.assert_array_equal(np.asarray(full.count), [8, 8])
        hits = unbatched_raytrace_coherent(
            octree, ph, pyramid, exsum, o, d, level, knum=16,
            max_nuggets=4)
        assert bool(hits.saturated)

    def test_axis_aligned_rays_and_inside_origins(self):
        level = 3
        pts = np.stack(np.meshgrid(*[np.arange(8)] * 3,
                                   indexing='ij'), -1).reshape(-1, 3)
        pts = pts[(pts.sum(-1) % 3) == 0]        # sparse pattern
        octree, pyramid, exsum, ph = build(pts, level)
        side = 8
        ys, xs = np.meshgrid(np.linspace(-0.95, 0.95, side),
                             np.linspace(-0.95, 0.95, side), indexing='ij')
        # axis-aligned rays (two zero direction components), origins
        # inside the volume
        o = np.stack([xs.ravel(), ys.ravel(),
                      np.full(side * side, -0.5)], -1).astype(np.float32)
        d = np.tile(np.array([[0., 0., 1.]], np.float32), (side * side, 1))
        assert assert_matches(octree, pyramid, exsum, ph, o, d, level,
                              knum=16).shape[0] > 0

    def test_miss_all(self):
        level = 3
        pts = np.zeros((1, 3), np.int64)
        octree, pyramid, exsum, ph = build(pts, level)
        o = np.full((32, 3), 3., np.float32)
        d = np.ones((32, 3), np.float32)
        hits = unbatched_raytrace_coherent(
            octree, ph, pyramid, exsum, o, d, level)
        assert int(np.asarray(hits.count).sum()) == 0
        assert np.all(np.asarray(hits.pidx) == -1)
        assert hits_to_nuggets(hits)[0].shape == (0,)


def test_reference_catches_wrong_hits():
    """The brute-force comparison flags a dropped hit, a foreign hit and a
    wrong depth."""
    level = 4
    rng = np.random.default_rng(2)
    pts = rng.integers(0, 2 ** level, size=(200, 3))
    octree, pyramid, exsum, ph = build(pts, level)
    o, d = camera_grid(12)
    ridx, pidx, depths = (np.asarray(x) for x in spc_render.unbatched_raytrace(
        octree, ph, pyramid, exsum, o, d, level, with_exit=True))
    assert reference_check(ph, pyramid, o, d, level, ridx, pidx,
                           depths)['traced'] > 1
    off, nvox = int(pyramid[1, level]), int(pyramid[0, level])
    pts_l = np.asarray(ph[off:off + nvox])
    ref = ray_voxel_hits(pts_l, level, o, d)
    dropped = compare_ray_hits(ridx[1:], pidx[1:] - off, depths[1:], ref,
                               nvox)
    assert dropped['missing'] == 1 and dropped['extra'] == 0
    # the ray of the first hit paired with a voxel it does not come near
    far = next(v for v in range(nvox)
               if not np.any((ref[0] == ridx[0]) & (ref[1] == v)))
    foreign = compare_ray_hits(np.append(ridx, ridx[0]),
                               np.append(pidx - off, far),
                               np.concatenate([depths, depths[:1]]), ref,
                               nvox)
    assert foreign['extra'] == 1 and foreign['missing'] == 0
    shifted = compare_ray_hits(ridx, pidx - off, depths + 1e-3, ref, nvox)
    assert shifted['depth_err'] >= 1e-3 - 1e-9
