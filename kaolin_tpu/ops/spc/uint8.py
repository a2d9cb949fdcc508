"""uint8 bit manipulation for octree bytes.

Parity: ``kaolin/ops/spc/uint8.py`` (reference).  The reference uses lookup
tables; here ``jax.lax.population_count`` and shift/mask vector
ops (int32 lanes) do the work.
"""

import jax
import jax.numpy as jnp

__all__ = ['uint8_to_bits', 'bits_to_uint8', 'uint8_bits_sum']


def uint8_to_bits(uint8_t):
    """Unpack uint8 values to 8 booleans (bit 0 first).

    Parity: ``kaolin/ops/spc/uint8.py:29``.

    Args:
        uint8_t: (...,) uint8 array.

    Returns:
        (..., 8) bool array.

    Example:
        >>> import jax.numpy as jnp
        >>> uint8_to_bits(jnp.array([5], dtype=jnp.uint8)).tolist()
        [[True, False, True, False, False, False, False, False]]
    """
    x = uint8_t.astype(jnp.int32)
    shifts = jnp.arange(8, dtype=jnp.int32)
    return ((x[..., None] >> shifts) & 1).astype(bool)


def bits_to_uint8(bool_t):
    """Pack (..., 8) booleans into uint8 (bit 0 first).

    Parity: ``kaolin/ops/spc/uint8.py:95``.
    """
    shifts = jnp.arange(8, dtype=jnp.int32)
    vals = (bool_t.astype(jnp.int32) << shifts).sum(axis=-1)
    return vals.astype(jnp.uint8)


def uint8_bits_sum(uint8_t):
    """Popcount of each byte.

    Parity: ``kaolin/ops/spc/uint8.py:66``.
    """
    return jax.lax.population_count(uint8_t.astype(jnp.uint8)).astype(
        jnp.int32)
