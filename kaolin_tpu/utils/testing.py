"""Tensor checkers and test helpers.

Parity: ``kaolin/utils/testing.py`` (reference).  Operates on JAX / numpy
arrays instead of torch tensors.
"""

import functools
import logging

import numpy as np
import jax.numpy as jnp

from kaolin_tpu.ops import random as _random

__all__ = [
    'BOOL_DTYPES', 'INT_DTYPES', 'FLOAT_DTYPES', 'NUM_DTYPES', 'ALL_DTYPES',
    'with_seed',
    'check_tensor',
    'check_packed_tensor',
    'check_padded_tensor',
    'check_spc_octrees',
    'tensor_info',
    'contained_allclose',
    'contained_equal',
    'check_allclose',
    'check_tensor_attribute_shapes',
    'print_dict_attributes',
    'print_namedtuple_attributes',
    'seeded_uv_sphere',
    'ray_voxel_hits',
    'compare_ray_hits',
]

BOOL_DTYPES = [jnp.bool_]
INT_DTYPES = [jnp.uint8, jnp.int16, jnp.int32]
FLOAT_DTYPES = [jnp.float16, jnp.bfloat16, jnp.float32]
NUM_DTYPES = INT_DTYPES + FLOAT_DTYPES
ALL_DTYPES = NUM_DTYPES + BOOL_DTYPES


def with_seed(seed=0, random_seed=None, numpy_seed=None):
    """Decorator fixing the module RNG seed around a test function.

    Parity: ``kaolin/utils/testing.py:45``.
    """
    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            state = _random.get_state()
            _random.manual_seed(seed, random_seed, numpy_seed)
            try:
                return func(*args, **kwargs)
            finally:
                _random.set_state(*state)
        return wrapper
    return decorator


def check_tensor(tensor, shape=None, dtype=None, throw=True):
    """Check an array's shape (None entries = wildcard) and dtype.

    Parity: ``kaolin/utils/testing.py:64`` (the ``device`` argument is
    dropped — placement is managed by jax shardings, not per-tensor).
    """
    if shape is not None:
        if len(shape) != tensor.ndim:
            if throw:
                raise ValueError(
                    f"tensor is of rank {tensor.ndim} but expected {len(shape)}")
            return False
        for i, (s, exp) in enumerate(zip(tensor.shape, shape)):
            if exp is not None and s != exp:
                if throw:
                    raise ValueError(
                        f"tensor shape {tuple(tensor.shape)} does not match "
                        f"expected {tuple(shape)} at dim {i}")
                return False
    if dtype is not None:
        if jnp.dtype(tensor.dtype) != jnp.dtype(dtype):
            if throw:
                raise TypeError(
                    f"tensor dtype {tensor.dtype} != expected {dtype}")
            return False
    return True


def check_packed_tensor(tensor, total_numel=None, last_dim=None, dtype=None,
                        throw=True):
    """Check a packed tensor ``(total_numel, last_dim)``.

    Parity: ``kaolin/utils/testing.py:98``.
    """
    return check_tensor(tensor, shape=(total_numel, last_dim), dtype=dtype,
                        throw=throw)


def check_padded_tensor(tensor, padding_value=None, shape_per_tensor=None,
                        batch_size=None, max_shape=None, last_dim=None,
                        dtype=None, throw=True):
    """Check a padded tensor and (optionally) its padding values.

    Parity: ``kaolin/utils/testing.py:126``.
    """
    shape = None
    if batch_size is not None or max_shape is not None or last_dim is not None:
        if max_shape is None:
            shape = None
        else:
            shape = (batch_size,) + tuple(max_shape) + (last_dim,)
    if shape is not None and not check_tensor(tensor, shape=shape, dtype=dtype,
                                              throw=throw):
        return False
    if shape is None and dtype is not None and not check_tensor(
            tensor, dtype=dtype, throw=throw):
        return False
    if padding_value is not None and shape_per_tensor is not None:
        arr = np.asarray(tensor)
        shape_per_tensor = np.asarray(shape_per_tensor)
        for i in range(shape_per_tensor.shape[0]):
            sub = arr[i]
            mask = np.zeros(sub.shape[:-1], dtype=bool)
            mask[tuple(slice(0, int(s)) for s in shape_per_tensor[i])] = True
            if not np.all(sub[~mask] == padding_value):
                if throw:
                    raise ValueError(
                        f"padding of sub-tensor {i} is not {padding_value}")
                return False
    return True


def check_spc_octrees(octrees, lengths, batch_size=None, level=None,
                      throw=True):
    """Validate a packed batch of SPC octrees byte arrays.

    Walks each octree breadth-first from its root byte, checking that the
    number of bytes matches the popcount-derived node counts and that each
    octree reaches the expected ``level``.

    Parity: ``kaolin/utils/testing.py:184``.
    """
    octrees = np.asarray(octrees)
    lengths = np.asarray(lengths)
    if octrees.dtype != np.uint8:
        if throw:
            raise TypeError(f"octrees must be uint8, got {octrees.dtype}")
        return False
    if batch_size is not None and lengths.shape[0] != batch_size:
        if throw:
            raise ValueError(
                f"expected batch_size {batch_size}, got {lengths.shape[0]}")
        return False
    if octrees.shape[0] != lengths.sum():
        if throw:
            raise ValueError(
                f"octrees has {octrees.shape[0]} bytes but lengths sum to "
                f"{lengths.sum()}")
        return False
    start = 0
    for b, length in enumerate(lengths):
        octree = octrees[start:start + int(length)]
        cursor, num_nodes, cur_level = 0, 1, 0
        while cursor < octree.shape[0]:
            nodes = octree[cursor:cursor + num_nodes]
            cursor += num_nodes
            num_nodes = int(np.unpackbits(nodes).sum())
            cur_level += 1
        if cursor != octree.shape[0]:
            if throw:
                raise ValueError(f"octree {b} is malformed")
            return False
        if level is not None and cur_level != level:
            if throw:
                raise ValueError(
                    f"octree {b} has level {cur_level}, expected {level}")
            return False
        start += int(length)
    return True


def tensor_info(t, name='', print_stats=False, detailed=False):
    """One-line human-readable summary of an array.

    Parity: ``kaolin/utils/testing.py:222``.
    """
    if t is None:
        return f"{name}: None"
    info = f"{name}: {tuple(t.shape)} ({t.dtype})"
    if print_stats or detailed:
        arr = np.asarray(t)
        if arr.size > 0 and np.issubdtype(arr.dtype, np.number):
            info += (f" min={arr.min():.4g} max={arr.max():.4g}"
                     f" mean={arr.astype(np.float64).mean():.4g}")
    if detailed:
        arr = np.asarray(t)
        info += f" numel={arr.size}"
    return info


def contained_allclose(left, right, rtol=1e-5, atol=1e-8):
    """Recursively compare containers of arrays / scalars / strings.

    Parity: ``kaolin/utils/testing.py:287`` (``contained_torch_equal`` with
    approx=True semantics).
    """
    if type(left) is not type(right) and not (
            isinstance(left, (int, float)) and isinstance(right, (int, float))):
        if not (hasattr(left, 'shape') and hasattr(right, 'shape')):
            return False
    if isinstance(left, dict):
        if left.keys() != right.keys():
            return False
        return all(contained_allclose(left[k], right[k], rtol, atol)
                   for k in left)
    if isinstance(left, (list, tuple)):
        if len(left) != len(right):
            return False
        return all(contained_allclose(l, r, rtol, atol)
                   for l, r in zip(left, right))
    if isinstance(left, str) or left is None:
        return left == right
    if hasattr(left, 'shape') or isinstance(left, (int, float, bool)):
        left_arr, right_arr = np.asarray(left), np.asarray(right)
        if left_arr.shape != right_arr.shape:
            return False
        if np.issubdtype(left_arr.dtype, np.floating):
            return bool(np.allclose(left_arr, right_arr, rtol=rtol, atol=atol))
        return bool(np.array_equal(left_arr, right_arr))
    return left == right


def check_allclose(tensor, other, rtol=1e-5, atol=1e-8, equal_nan=False):
    """assert_allclose with a readable diff message.

    Parity: ``kaolin/utils/testing.py:364``.
    """
    tensor = np.asarray(tensor)
    other = np.asarray(other)
    if not np.allclose(tensor, other, rtol=rtol, atol=atol,
                       equal_nan=equal_nan):
        diff = np.abs(tensor.astype(np.float64) - other.astype(np.float64))
        close = np.isclose(tensor, other, rtol=rtol, atol=atol,
                           equal_nan=equal_nan)
        raise ValueError(
            f"Tensors are not close: max abs diff {diff.max()}, "
            f"{int((~close).sum())}/{close.size} mismatched elements")

def contained_equal(elem, other, approximate=False, rtol=1e-5, atol=1e-8):
    """Recursive exact (or allclose) comparison of containers of arrays.

    Parity: ``kaolin/utils/testing.py:287`` (``contained_torch_equal``);
    ``approximate=True`` matches the reference's allclose mode. Supports
    dicts, (named)tuples, lists, slotted objects, arrays and scalars.
    """
    if type(elem) is not type(other) and not (
            isinstance(elem, (int, float, bool))
            and isinstance(other, (int, float, bool))):
        if not (hasattr(elem, 'shape') and hasattr(other, 'shape')):
            return False
    if isinstance(elem, dict):
        if elem.keys() != other.keys():
            return False
        return all(contained_equal(elem[k], other[k], approximate, rtol, atol)
                   for k in elem)
    if isinstance(elem, tuple) and hasattr(elem, '_fields'):  # namedtuple
        if set(elem._fields) != set(other._fields):
            return False
        return all(contained_equal(getattr(elem, f), getattr(other, f),
                                   approximate, rtol, atol)
                   for f in elem._fields)
    if isinstance(elem, (list, tuple)):
        if len(elem) != len(other):
            return False
        return all(contained_equal(a, b, approximate, rtol, atol)
                   for a, b in zip(elem, other))
    if isinstance(elem, str) or elem is None:
        return elem == other
    if hasattr(elem, 'shape') or isinstance(elem, (int, float, bool)):
        a, b = np.asarray(elem), np.asarray(other)
        if a.shape != b.shape:
            return False
        if approximate and np.issubdtype(a.dtype, np.floating):
            return bool(np.allclose(a, b, rtol=rtol, atol=atol))
        return bool(np.array_equal(a, b))
    if hasattr(elem, '__slots__'):
        return contained_equal(
            {k: getattr(elem, k) for k in elem.__slots__ if hasattr(elem, k)},
            {k: getattr(other, k) for k in other.__slots__ if hasattr(other, k)},
            approximate, rtol, atol)
    return elem == other


def check_tensor_attribute_shapes(container, throw=True, **attribute_info):
    """Check shapes of named attributes (or dict keys) of ``container``.

    Parity: ``kaolin/utils/testing.py`` (``check_tensor_attribute_shapes``).
    """
    success = True
    for k, shape in attribute_info.items():
        val = container[k] if isinstance(container, dict) \
            else getattr(container, k)
        if not check_tensor(val, shape=shape, throw=False):
            success = False
            message = f'Attribute {k} has shape {val.shape} (expected {shape})'
            if throw:
                raise ValueError(message)
            logging.error(message)
    return success


def print_dict_attributes(in_dict, name='', prefix='', **tensor_info_kwargs):
    """Print a summary line per dict entry (tensor_info for arrays).

    Parity: ``kaolin/utils/testing.py`` (``print_dict_attributes``).
    """
    if len(name) > 0:
        print(f'\nAttributes of {name}:')
    for k, v in in_dict.items():
        recurse = False
        if hasattr(v, 'shape') and hasattr(v, 'dtype'):
            tinfo = tensor_info(v, **tensor_info_kwargs)
        elif isinstance(v, (str, int, float)):
            tinfo = v
        elif isinstance(v, dict):
            tinfo = f'{type(v)} of length {len(v)}'
            recurse = True
        elif isinstance(v, (list, tuple)):
            tinfo = f'{type(v)} of length {len(v)}'
        else:
            tinfo = type(v)
        print(f'   {prefix}{k}: {tinfo}')
        if recurse:
            print_dict_attributes(v, prefix='  ', **tensor_info_kwargs)


def print_namedtuple_attributes(ntuple, name='', prefix='',
                                **tensor_info_kwargs):
    """Same as :func:`print_dict_attributes` for a namedtuple."""
    print_dict_attributes(ntuple._asdict(), name=name, prefix=prefix,
                          **tensor_info_kwargs)


def ray_voxel_hits(points, level, origin, direction, ray_ids=None,
                   voxel_ids=None, tol=1e-5, chunk=1 << 20):
    """Float64 slab test of rays against the voxels of one octree level:
    the plain reference for the SPC ray tracers.

    Voxel ``p`` spans ``[p * s - 1, (p + 1) * s - 1]`` per axis with
    ``s = 2 / 2**level``; a ray hits it where ``t_far > t_near > 0``, with
    the tracers' 1e-12 clamp on direction components.

    Args:
        points: (V, 3) integer voxel coordinates at ``level``.
        origin, direction: (N, 3) rays.
        ray_ids, voxel_ids: the (ray, voxel) pairs to test; every pair
            when both are None.
        tol: depth margin within which a pair counts as grazing.
        chunk: pairs tested per numpy pass.

    Returns:
        (ray_ids, voxel_ids, t_near, t_far, grazing) of the pairs that hit
        or miss by less than ``tol``; ``grazing`` marks those within
        ``tol`` of the boundary, which a float32 tracer may decide either
        way.
    """
    points = np.asarray(points, np.float64)
    o = np.asarray(origin, np.float64)
    d = np.asarray(direction, np.float64)
    if ray_ids is None:
        ray_ids, voxel_ids = (a.ravel() for a in np.meshgrid(
            np.arange(o.shape[0]), np.arange(points.shape[0]),
            indexing='ij'))
    ray_ids = np.asarray(ray_ids, np.int64)
    voxel_ids = np.asarray(voxel_ids, np.int64)
    d = np.where(np.abs(d) < 1e-12, np.where(d < 0, -1e-12, 1e-12), d)
    inv = 1. / d
    side = 2. / (1 << level)
    out = []
    for s in range(0, ray_ids.shape[0], chunk):
        r, v = ray_ids[s:s + chunk], voxel_ids[s:s + chunk]
        t0 = (points[v] * side - 1. - o[r]) * inv[r]
        t1 = t0 + side * inv[r]
        tn = np.minimum(t0, t1).max(-1)
        tf = np.maximum(t0, t1).min(-1)
        near = (tf - tn > -tol) & (tf > -tol) & (tn > -tol)
        graze = (tf - tn <= tol) | (tn <= tol)
        out.append((r[near], v[near], tn[near], tf[near], graze[near]))
    return tuple(np.concatenate(x) for x in zip(*out))


def compare_ray_hits(ridx, vidx, depths, reference, num_voxels):
    """Compare a tracer's hits with :func:`ray_voxel_hits`.

    Args:
        ridx, vidx: (n,) traced ray and level-local voxel ids.
        depths: (n, 2) traced entry and exit depths.
        reference: the output of :func:`ray_voxel_hits`.
        num_voxels: voxel count of the level (for the pair keys).

    Returns:
        dict with ``missing`` (reference hits, not grazing, that were not
        traced), ``extra`` (traced pairs the reference does not come near),
        ``grazing`` (reference pairs within ``tol`` of the boundary, which
        may go either way), ``depth_err`` (largest depth difference over
        the traced pairs) and the two hit counts.
    """
    rr, rv, rtn, rtf, graze = reference
    key_t = np.asarray(ridx, np.int64) * num_voxels + np.asarray(vidx)
    key_r = rr * num_voxels + rv
    order = np.argsort(key_r)
    key_r, rtn, rtf, graze = key_r[order], rtn[order], rtf[order], \
        graze[order]
    pos = np.clip(np.searchsorted(key_r, key_t), 0, max(len(key_r) - 1, 0))
    found = (key_r[pos] == key_t) if len(key_r) else \
        np.zeros(key_t.shape, bool)
    traced = np.zeros(key_r.shape, bool)
    traced[pos[found]] = True
    depths = np.asarray(depths, np.float64)
    err = np.abs(depths[found] - np.stack([rtn, rtf], -1)[pos[found]])
    return {'traced': int(key_t.shape[0]),
            'reference': int((~graze).sum()),
            'missing': int((~graze & ~traced).sum()),
            'extra': int((~found).sum()),
            'grazing': int(graze.sum()),
            'depth_err': float(err.max()) if err.size else 0.}


def _icosahedron():
    t = (1. + 5. ** 0.5) / 2.
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]],
                 np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]])
    return v / np.linalg.norm(v, axis=-1, keepdims=True), f


def seeded_uv_sphere(num_faces=10_000, seed=0, noise=0.02):
    """Closed, UV-mapped test mesh: a geodesic icosphere with radial noise.

    Each icosahedron face is split into ``k * k`` triangles with
    ``k = round(sqrt(num_faces / 20))`` (10k -> 9,680 faces, 40k -> 40,500),
    vertices are pushed to the unit sphere and scaled radially by
    ``1 + noise * u``, ``u ~ U(-1, 1)`` drawn from ``seed``.  UVs are
    spherical (longitude, latitude) per vertex.

    Returns:
        :class:`~kaolin_tpu.rep.SurfaceMesh` with numpy ``vertices (V, 3)``
        float32, ``faces (F, 3)`` int32, ``uvs (V, 2)`` float32 and
        ``face_uvs_idx`` (= ``faces``).
    """
    from kaolin_tpu.rep import SurfaceMesh
    k = max(1, int(round((num_faces / 20.) ** 0.5)))
    iv, ifc = _icosahedron()
    # lattice (i, j), i + j <= k, on every icosahedron face
    i, j = np.nonzero(np.add.outer(np.arange(k + 1), np.arange(k + 1)) <= k)
    lid = -np.ones((k + 1, k + 1), np.int64)
    lid[i, j] = np.arange(i.shape[0])
    a, b, c = (iv[ifc[:, n]][:, None] for n in range(3))
    pts = a + (b - a) * (i / k)[None, :, None] + (c - a) * (j / k)[None, :,
                                                                   None]
    pts = pts / np.linalg.norm(pts, axis=-1, keepdims=True)
    # shared edge points are recomputed per face: merge them by position
    _, vid, inv = np.unique(np.round(pts.reshape(-1, 3), 9), axis=0,
                            return_index=True, return_inverse=True)
    order = np.argsort(vid)                 # stable, first-seen order
    remap = np.empty_like(order)
    remap[order] = np.arange(order.shape[0])
    verts = pts.reshape(-1, 3)[vid[order]]
    glob = remap[inv.reshape(-1)].reshape(20, -1)
    ii, jj = np.nonzero(np.add.outer(np.arange(k), np.arange(k)) < k)
    up = np.stack([lid[ii, jj], lid[ii + 1, jj], lid[ii, jj + 1]], -1)
    ii, jj = np.nonzero(np.add.outer(np.arange(k), np.arange(k)) < k - 1)
    down = np.stack([lid[ii + 1, jj], lid[ii + 1, jj + 1], lid[ii, jj + 1]],
                    -1)
    faces = glob[:, np.concatenate([up, down])].reshape(-1, 3)
    rng = np.random.default_rng(seed)
    verts = verts * (1. + noise * rng.uniform(-1., 1., (verts.shape[0], 1)))
    n = verts / np.linalg.norm(verts, axis=-1, keepdims=True)
    uvs = np.stack([0.5 + np.arctan2(n[:, 2], n[:, 0]) / (2. * np.pi),
                    0.5 + np.arcsin(np.clip(n[:, 1], -1., 1.)) / np.pi], -1)
    faces = faces.astype(np.int32)
    return SurfaceMesh(vertices=verts.astype(np.float32), faces=faces,
                       uvs=uvs.astype(np.float32), face_uvs_idx=faces)
