"""Batched tensor layouts: packed and padded.

Re-design of the reference batching layer (``kaolin/ops/batch.py``).

Two batched layouts for ragged collections of tensors:

* **packed**: all sub-tensors flattened to 2D ``(numel_i / last_dim, last_dim)``
  and concatenated along the first axis. Ragged structure is carried by
  ``shape_per_tensor`` / ``first_idx``.
* **padded**: sub-tensors stacked into one dense array, padded up to
  ``max_shape`` with ``padding_value``.

Design notes:

* ``shape_per_tensor`` / ``first_idx`` / ``numel_per_tensor`` are **host
  numpy int64 arrays**, not device arrays.  Under ``jax.jit`` all shapes must
  be static; keeping the ragged metadata on host makes every op here
  jit-compatible (the metadata participates only in static slicing / shape
  computation).  This replaces the reference's device-resident long tensors
  (``kaolin/ops/batch.py:72-118``).
* ``tile_to_packed`` is a differentiable gather (``jnp.repeat`` with a static
  ``total_repeat_length``) instead of a CUDA kernel
  (``kaolin/csrc/ops/tile_to_packed_cuda.cu:40``); its VJP is the segment sum
  that the reference implements as ``packed_simple_sum``.
"""

from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

__all__ = [
    'get_shape_per_tensor',
    'list_to_packed',
    'get_first_idx',
    'tile_to_packed',
    'packed_to_list',
    'fill_max_shape',
    'list_to_padded',
    'padded_to_list',
    'packed_to_padded',
    'padded_to_packed',
]


def _check_same_ndim(tensor_list):
    ndim = tensor_list[0].ndim
    for i, t in enumerate(tensor_list):
        if t.ndim != ndim:
            raise ValueError(
                f"Expected all tensors to have {ndim} dimensions "
                f"but got {t.ndim} at index {i}")


def get_shape_per_tensor(tensor_list) -> np.ndarray:
    """Return the shapes (excluding last dim) of each tensor in the list.

    Parity: ``kaolin/ops/batch.py:37``.

    Args:
        tensor_list: sequence of arrays, all with the same number of
            dimensions and same last dimension.

    Returns:
        numpy int64 array of shape ``(B, ndim - 1)``.
    """
    _check_same_ndim(tensor_list)
    return np.array([t.shape[:-1] for t in tensor_list], dtype=np.int64)


def list_to_packed(tensor_list) -> Tuple[jnp.ndarray, np.ndarray]:
    """Concatenate a list of arrays into the packed layout.

    Parity: ``kaolin/ops/batch.py:72``.

    Args:
        tensor_list: sequence of arrays of identical ndim, dtype and last
            dimension.

    Returns:
        (packed_tensor, shape_per_tensor):
            packed_tensor is ``(sum_i numel_i / last_dim, last_dim)``,
            shape_per_tensor is host numpy ``(B, ndim - 1)``.

    Example:
        >>> import jax.numpy as jnp
        >>> packed, shapes = list_to_packed(
        ...     [jnp.array([[1., 2.]]), jnp.array([[3., 4.], [5., 6.]])])
        >>> packed.tolist()
        [[1.0, 2.0], [3.0, 4.0], [5.0, 6.0]]
        >>> shapes.tolist()
        [[1], [2]]
    """
    if len(tensor_list) == 0:
        raise ValueError("tensor_list is empty")
    shape_per_tensor = get_shape_per_tensor(tensor_list)
    last_dim = tensor_list[0].shape[-1]
    for i, t in enumerate(tensor_list):
        if t.shape[-1] != last_dim:
            raise ValueError(
                f"Expected last dimension {last_dim} but got {t.shape[-1]} "
                f"at index {i}")
    packed = jnp.concatenate(
        [jnp.reshape(t, (-1, last_dim)) for t in tensor_list], axis=0)
    return packed, shape_per_tensor


def get_first_idx(numel_per_tensor) -> np.ndarray:
    """First-index offsets of each sub-tensor in the packed layout.

    Parity: ``kaolin/ops/batch.py:120``.  Unlike the reference this returns a
    host numpy array (static metadata for jit).

    Args:
        numel_per_tensor: (B,) number of rows of each sub-tensor.

    Returns:
        numpy int64 array of shape ``(B + 1,)``, starting at 0, ending at the
        total number of rows.
    """
    numel_per_tensor = np.asarray(numel_per_tensor, dtype=np.int64)
    out = np.zeros(numel_per_tensor.shape[0] + 1, dtype=np.int64)
    np.cumsum(numel_per_tensor, out=out[1:])
    return out


def total_numel(shape_per_tensor) -> np.ndarray:
    """Rows per sub-tensor from shape_per_tensor: prod over the ragged dims."""
    shape_per_tensor = np.asarray(shape_per_tensor, dtype=np.int64)
    return np.prod(shape_per_tensor, axis=1)


def tile_to_packed(values, numel_per_tensor) -> jnp.ndarray:
    """Tile each per-tensor scalar over its packed rows.

    Output row ``r`` of sub-tensor ``i`` equals ``values[i]``; shape
    ``(total_rows, 1)``.  Differentiable (VJP = per-segment sum, the
    reference's ``packed_simple_sum``).

    Parity: ``kaolin/ops/batch.py:144`` + ``tile_to_packed_cuda.cu:40``.
    """
    numel_per_tensor = np.asarray(numel_per_tensor, dtype=np.int64)
    total = int(numel_per_tensor.sum())
    values = jnp.asarray(values)
    tiled = jnp.repeat(values, jnp.asarray(numel_per_tensor),
                       total_repeat_length=total)
    return tiled[:, None]


def packed_to_list(packed_tensor, shape_per_tensor, first_idx) -> List[jnp.ndarray]:
    """Split a packed tensor back into a list of arrays.

    Parity: ``kaolin/ops/batch.py:179``.
    """
    shape_per_tensor = np.asarray(shape_per_tensor)
    first_idx = np.asarray(first_idx)
    last_dim = packed_tensor.shape[-1]
    out = []
    for i in range(shape_per_tensor.shape[0]):
        lo, hi = int(first_idx[i]), int(first_idx[i + 1])
        shape = tuple(int(s) for s in shape_per_tensor[i]) + (last_dim,)
        out.append(jnp.reshape(packed_tensor[lo:hi], shape))
    return out


def fill_max_shape(shape_per_tensor, partial_max_shape=None) -> np.ndarray:
    """Resolve a partial max_shape (-1 = infer) against shape_per_tensor.

    Parity: ``kaolin/ops/batch.py:215``.
    """
    shape_per_tensor = np.asarray(shape_per_tensor, dtype=np.int64)
    max_shape = shape_per_tensor.max(axis=0)
    if partial_max_shape is None:
        return max_shape
    partial = np.asarray(partial_max_shape, dtype=np.int64)
    if partial.shape[0] != shape_per_tensor.shape[1]:
        raise ValueError(
            f"partial_max_shape has {partial.shape[0]} dims but "
            f"shape_per_tensor has {shape_per_tensor.shape[1]}")
    out = np.where(partial == -1, max_shape, partial)
    if (out < max_shape).any():
        raise ValueError(
            f"max_shape {out.tolist()} is too small for tensors of max shape "
            f"{max_shape.tolist()}")
    return out


def list_to_padded(tensor_list, padding_value, max_shape=None) -> Tuple[jnp.ndarray, np.ndarray]:
    """Stack a ragged list into a dense padded batch.

    Parity: ``kaolin/ops/batch.py:254``.

    Returns:
        (padded_tensor, shape_per_tensor): padded is
        ``(B, *max_shape, last_dim)``.

    Example:
        >>> import jax.numpy as jnp
        >>> padded, shapes = list_to_padded(
        ...     [jnp.array([[1., 2.]]), jnp.array([[3., 4.], [5., 6.]])], 0.)
        >>> padded.tolist()
        [[[1.0, 2.0], [0.0, 0.0]], [[3.0, 4.0], [5.0, 6.0]]]
    """
    shape_per_tensor = get_shape_per_tensor(tensor_list)
    max_shape = fill_max_shape(shape_per_tensor, max_shape)
    last_dim = tensor_list[0].shape[-1]
    padded = []
    for t in tensor_list:
        pads = [(0, int(m) - s) for m, s in zip(max_shape, t.shape[:-1])]
        pads.append((0, 0))
        padded.append(jnp.pad(t, pads, constant_values=padding_value))
    return jnp.stack(padded, axis=0), shape_per_tensor


def padded_to_list(padded_tensor, shape_per_tensor) -> List[jnp.ndarray]:
    """Slice a padded batch back into a ragged list.

    Parity: ``kaolin/ops/batch.py:306``.
    """
    shape_per_tensor = np.asarray(shape_per_tensor)
    out = []
    for i in range(shape_per_tensor.shape[0]):
        idx = (i,) + tuple(slice(0, int(s)) for s in shape_per_tensor[i])
        out.append(padded_tensor[idx])
    return out


def packed_to_padded(packed_tensor, shape_per_tensor, first_idx,
                     padding_value, max_shape=None) -> jnp.ndarray:
    """Convert packed layout to padded layout.

    Parity: ``kaolin/ops/batch.py:332``.
    """
    tensors = packed_to_list(packed_tensor, shape_per_tensor, first_idx)
    padded, _ = list_to_padded(tensors, padding_value, max_shape)
    return padded


def padded_to_packed(padded_tensor, shape_per_tensor) -> jnp.ndarray:
    """Convert padded layout to packed layout.

    Parity: ``kaolin/ops/batch.py:360``.
    """
    tensors = padded_to_list(padded_tensor, shape_per_tensor)
    packed, _ = list_to_packed(tensors)
    return packed
