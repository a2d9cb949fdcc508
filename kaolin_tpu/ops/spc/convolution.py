"""Sparse octree convolutions (SPC Conv3d / ConvTranspose3d).

Parity: ``kaolin/ops/spc/convolution.py`` + CUDA kernels
``kaolin/csrc/ops/spc/convolution_cuda.cu`` (reference).

Design (SURVEY.md A.2): the CUDA pipeline builds per-tap
kernel maps with a scan + compaction and host-synced sizes, then runs
gather-matmul-scatter per tap.  Here neighbor indices come from the
vectorized ``identify`` walk (shared with :func:`unbatched_query`), kept
dense as a (K, N_out) index array with a miss mask — masked
gather + per-tap matmul + sum runs with no host round-trip,
and autodiff yields exactly the reference backward (transposed maps).
"""

import math
from typing import Optional

import numpy as np
import jax
import jax.numpy as jnp
try:
    import flax.linen as nn
except ImportError:  # optional: only the layer classes need flax
    nn = None

from kaolin_tpu.ops.spc.spc import unbatched_query, \
    unbatched_get_level_points

__all__ = ['conv3d', 'conv_transpose3d', 'Conv3d', 'ConvTranspose3d']


def _per_octree_slices(pyramids, lengths):
    """Byte/point offsets per octree (host)."""
    pyr = np.asarray(pyramids)
    lengths = np.asarray(lengths)
    B = pyr.shape[0]
    byte_starts = np.concatenate([[0], np.cumsum(lengths)])
    point_counts = pyr[:, 1, -1]
    point_starts = np.concatenate([[0], np.cumsum(point_counts)])
    exsum_starts = np.concatenate(
        [[0], np.cumsum(lengths + 1)])
    return byte_starts, point_starts, exsum_starts


def _neighbor_indices(octree, exsum, coords, level):
    """Level-local point indices for integer coords (-1 = miss)."""
    idx = unbatched_query(octree, exsum, coords, level)
    # convert hierarchy-global to level-local by subtracting the level
    # offset; pyramid offset equals index of first point at level, which
    # also equals the number of bytes above the level == exsum-based value
    return idx


def conv3d(octrees, point_hierarchies, level, pyramids, exsum, input,
           weight, kernel_vectors, jump=0, bias=None, **kwargs):
    """Sparse convolution over an SPC: ``Y_o = sum_k W_k X_{n(o,k)} (+b)``.

    Parity: ``kaolin/ops/spc/convolution.py:68``.

    Args:
        octrees / point_hierarchies / pyramids / exsum: SPC scan products.
        level: level of the ``input`` features.
        input: packed ``(total_points_at_level, in_ch)`` features
            (concatenated over the batch).
        weight: ``(K, in_ch, out_ch)``.
        kernel_vectors: ``(K, 3)`` int offsets.
        jump: downsampling level delta (output level = level - jump).
        bias: optional ``(out_ch,)``.

    Returns:
        (output packed ``(total_points_at_out_level, out_ch)``, out_level).
    """
    out_level = level - jump
    if weight.shape[0] == 1 and jump == 0:
        out = input @ weight[0]
        if bias is not None:
            out = out + bias[None]
        return out, int(level)

    pyr = np.asarray(pyramids)
    # bytes per octree = points above the deepest level = pyramid prefix
    lengths = (np.asarray(kwargs['lengths']) if 'lengths' in kwargs
               else pyr[:, 1, -2])
    byte_starts, point_starts, exsum_starts = _per_octree_slices(
        pyramids, lengths)
    B = pyr.shape[0]
    kv = jnp.asarray(np.asarray(kernel_vectors), dtype=jnp.int32)
    s = 1 << jump

    outs = []
    in_start = 0
    for b in range(B):
        octree_b = octrees[int(byte_starts[b]):int(byte_starts[b + 1])]
        exsum_b = exsum[int(exsum_starts[b]):int(exsum_starts[b + 1])]
        ph_b = point_hierarchies[
            int(point_starts[b]):int(point_starts[b + 1])]
        n_in = int(pyr[b, 0, level])
        x = input[in_start:in_start + n_in]
        in_start += n_in

        out_pts = unbatched_get_level_points(
            ph_b, pyr[b], out_level).astype(jnp.int32)  # (N_out, 3)
        # neighbor coords for each tap: s * P_o + Kvec_k
        coords = (out_pts[None] * s + kv[:, None]).reshape(-1, 3)
        nidx = unbatched_query(octree_b, exsum_b,
                               coords.astype(jnp.int16), level)
        nidx = nidx.reshape(kv.shape[0], -1)  # (K, N_out), global
        local = nidx - int(pyr[b, 1, level])
        valid = nidx >= 0
        safe = jnp.clip(local, 0, n_in - 1)
        gathered = jnp.where(valid[..., None], x[safe], 0.)  # (K, N, Cin)
        out = jnp.einsum('knc,kcd->nd', gathered, weight,
                         preferred_element_type=jnp.float32)
        outs.append(out.astype(input.dtype))
    out = jnp.concatenate(outs, axis=0)
    if bias is not None:
        out = out + bias[None]
    return out, int(out_level)


def conv_transpose3d(octrees, point_hierarchies, level, pyramids, exsum,
                     input, weight, kernel_vectors, jump=0, bias=None,
                     **kwargs):
    """Transposed sparse convolution (upsampling): output level =
    level + jump.

    Parity: ``kaolin/ops/spc/convolution.py:285``; neighbor rule from
    ``convolution_cuda.cu:126-154``: for output point V and tap k,
    ``U = V - Kvec_k`` contributes iff ``U % s == 0`` with input
    ``Identify(U / s)``.
    """
    out_level = level + jump
    if weight.shape[0] == 1 and jump == 0:
        out = input @ weight[0]
        if bias is not None:
            out = out + bias[None]
        return out, int(level)

    pyr = np.asarray(pyramids)
    # bytes per octree = points above the deepest level = pyramid prefix
    lengths = (np.asarray(kwargs['lengths']) if 'lengths' in kwargs
               else pyr[:, 1, -2])
    byte_starts, point_starts, exsum_starts = _per_octree_slices(
        pyramids, lengths)
    B = pyr.shape[0]
    kv = jnp.asarray(np.asarray(kernel_vectors), dtype=jnp.int32)
    s = 1 << jump

    outs = []
    in_start = 0
    for b in range(B):
        octree_b = octrees[int(byte_starts[b]):int(byte_starts[b + 1])]
        exsum_b = exsum[int(exsum_starts[b]):int(exsum_starts[b + 1])]
        ph_b = point_hierarchies[
            int(point_starts[b]):int(point_starts[b + 1])]
        n_in = int(pyr[b, 0, level])
        x = input[in_start:in_start + n_in]
        in_start += n_in

        out_pts = unbatched_get_level_points(
            ph_b, pyr[b], out_level).astype(jnp.int32)  # (N_out, 3)
        U = out_pts[None] - kv[:, None]  # (K, N_out, 3)
        divisible = jnp.all(U % s == 0, axis=-1)
        Uq = U // s
        nidx = unbatched_query(octree_b, exsum_b,
                               Uq.reshape(-1, 3).astype(jnp.int16), level)
        nidx = nidx.reshape(kv.shape[0], -1)
        local = nidx - int(pyr[b, 1, level])
        valid = (nidx >= 0) & divisible
        safe = jnp.clip(local, 0, n_in - 1)
        gathered = jnp.where(valid[..., None], x[safe], 0.)
        out = jnp.einsum('knc,kcd->nd', gathered, weight,
                         preferred_element_type=jnp.float32)
        outs.append(out.astype(input.dtype))
    out = jnp.concatenate(outs, axis=0)
    if bias is not None:
        out = out + bias[None]
    return out, int(out_level)


if nn is None:
    def _needs_flax(*args, **kwargs):
        raise ImportError('this layer needs flax')

    Conv3d = _needs_flax
    ConvTranspose3d = _needs_flax
else:
    class Conv3d(nn.Module):
        """flax module wrapping :func:`conv3d`.

        Parity: ``kaolin/ops/spc/convolution.py:140``.

        Attributes:
            in_channels / out_channels: feature dims.
            kernel_vectors: (K, 3) numpy int offsets (static).
            jump: level delta.
            use_bias: add bias.
        """
        in_channels: int
        out_channels: int
        kernel_vectors: tuple  # tuple of (x, y, z) tuples for hashability
        jump: int = 0
        use_bias: bool = True

        @nn.compact
        def __call__(self, octrees, point_hierarchies, level, pyramids, exsum,
                     input, **kwargs):
            kv = np.asarray(self.kernel_vectors, dtype=np.int32)
            kdim = kv.shape[0]
            scale = math.sqrt(2.0 / (self.in_channels * kdim))
            weight = self.param(
                'weight',
                lambda key: jax.random.normal(
                    key, (kdim, self.in_channels, self.out_channels)) * scale)
            bias = (self.param('bias', nn.initializers.zeros,
                               (self.out_channels,))
                    if self.use_bias else None)
            return conv3d(octrees, point_hierarchies, level, pyramids, exsum,
                          input, weight, kv, self.jump, bias, **kwargs)


    class ConvTranspose3d(nn.Module):
        """flax module wrapping :func:`conv_transpose3d`.

        Parity: ``kaolin/ops/spc/convolution.py:358``.
        """
        in_channels: int
        out_channels: int
        kernel_vectors: tuple
        jump: int = 0
        use_bias: bool = True

        @nn.compact
        def __call__(self, octrees, point_hierarchies, level, pyramids, exsum,
                     input, **kwargs):
            kv = np.asarray(self.kernel_vectors, dtype=np.int32)
            kdim = kv.shape[0]
            scale = math.sqrt(2.0 / (self.in_channels * kdim))
            weight = self.param(
                'weight',
                lambda key: jax.random.normal(
                    key, (kdim, self.in_channels, self.out_channels)) * scale)
            bias = (self.param('bias', nn.initializers.zeros,
                               (self.out_channels,))
                    if self.use_bias else None)
            return conv_transpose3d(octrees, point_hierarchies, level, pyramids,
                                    exsum, input, weight, kv, self.jump, bias,
                                    **kwargs)
