"""Hamming distance between packed 256-bit ORB descriptors, as a matmul.

The reference computes popcount(xor) one pair at a time
(Frame.descriptor_distance, Frame.py:324-326; ORBMatcher.py:12-14).
Here descriptors are unpacked to 0/1 bit-vectors once, then

    hamming(a, b) = popcnt(a) + popcnt(b) - 2 * bits(a) @ bits(b)^T

so the N x 256 x M contraction is one s8 x s8 -> s32 matrix product
(exact in any precision mode) instead of N x M scalar popcounts.  A
full-frame distance matrix (2048 x 2048) is ~1 GMAC.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def unpack_bits(desc: jnp.ndarray) -> jnp.ndarray:
    """uint32 (..., 8) -> int8 0/1 bits (..., 256)."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[..., :, None] >> shifts) & jnp.uint32(1)
    return bits.reshape(desc.shape[:-1] + (256,)).astype(jnp.int8)


def popcount(desc: jnp.ndarray) -> jnp.ndarray:
    """uint32 (..., 8) -> int32 (...,): number of set bits."""
    return jax.lax.population_count(desc).astype(jnp.int32).sum(axis=-1)


def hamming_matrix(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Full pairwise distance matrix (N, M) int32 from packed (N, 8)/(M, 8)."""
    bits_a = unpack_bits(desc_a)
    bits_b = unpack_bits(desc_b)
    common = jax.lax.dot_general(
        bits_a, bits_b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return popcount(desc_a)[:, None] + popcount(desc_b)[None, :] - 2 * common


def hamming_matrix_bits(bits_a: jnp.ndarray, pop_a: jnp.ndarray,
                        bits_b: jnp.ndarray, pop_b: jnp.ndarray) -> jnp.ndarray:
    """Same as :func:`hamming_matrix` with pre-unpacked bits/popcounts
    (amortizes the unpack when one side is reused across queries)."""
    common = jax.lax.dot_general(
        bits_a, bits_b,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return pop_a[:, None] + pop_b[None, :] - 2 * common


def hamming_pairwise(desc_a: jnp.ndarray, desc_b: jnp.ndarray) -> jnp.ndarray:
    """Element-wise distance between aligned rows: (N, 8), (N, 8) -> (N,)."""
    return jax.lax.population_count(desc_a ^ desc_b).astype(jnp.int32).sum(axis=-1)
