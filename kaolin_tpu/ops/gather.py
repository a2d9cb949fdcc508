"""Flat row gather/scatter primitives.

Every hot gather in the render stack goes through these helpers, which
keep the compiled HLO a plain rank-2 row gather and its transpose a plain
row scatter-add:

* batch dims are flattened into the row index (``b * N + i``) so the
  compiled HLO is always a rank-2 row gather;
* the backward pass is a hand-written in-place ``.at[idx].add`` scatter
  chain via ``custom_vjp`` (autodiff's gather transpose generates separate
  zero-initialized scatter buffers + adds that fuse into a slow path).

Parity note: these replace the ad-hoc ``__getitem__`` gathers the reference
uses in python (e.g. ``kaolin/render/mesh/rasterization.py``), and the
atomicAdd feature-gradient scatters of its CUDA backward kernels
(``kaolin/csrc/render/mesh/rasterization_cuda.cu:239-442``) — scatter-add is
race-free in XLA by construction.
"""

import jax
import jax.numpy as jnp

__all__ = ['gather_rows', 'flat_index']


def flat_index(batched_idx, num_rows):
    """Flatten per-batch row indices into indices of the (B*N, ...) table.

    Args:
        batched_idx: ``(B, ...)`` int array of per-batch row ids in [0, N).
        num_rows: N, rows per batch element.

    Returns:
        ``(B * prod(...),)`` int32 flat row ids.
    """
    B = batched_idx.shape[0]
    per = batched_idx.reshape(B, -1)
    off = jnp.arange(B, dtype=jnp.int32)[:, None] * num_rows
    return (per.astype(jnp.int32) + off).reshape(-1)


@jax.custom_vjp
def gather_rows(table, idx):
    """Gather rows of a rank-2 table: ``table[idx]``.

    Args:
        table: ``(N, D)``.
        idx: ``(P,)`` int32 row ids in ``[0, N)``.

    Returns:
        ``(P, D)``; gradient w.r.t. ``table`` is a hand-written in-place
        scatter-add, no gradient w.r.t. ``idx``.
    """
    return table[idx]


def _gather_rows_fwd(table, idx):
    return table[idx], (idx, table.shape[0])


def _gather_rows_bwd(res, g):
    idx, num_rows = res
    dt = jnp.zeros((num_rows,) + g.shape[1:], g.dtype).at[idx].add(g)
    return dt, None


gather_rows.defvjp(_gather_rows_fwd, _gather_rows_bwd)
