"""Hamming distance over packed 256-bit ORB descriptors.

Replaces the reference's SWAR popcount `ORBmatcher::DescriptorDistance`
(reference src/ORBmatcher.cc:46-63) with batched XOR+popcount producing
whole [N, M] distance matrices in one pass — brute-force dense matching is
the accelerator's substitute for the reference's grid/BoW candidate
pruning, because the device computes the full matrix faster than the host
could prune it. `distance_matrix` is what every matcher uses: XLA fuses
the XOR, popcount and 8-word sum into one loop.

Descriptors are [*, 8] uint32 (256 bits).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def popcount_u32(v: jnp.ndarray) -> jnp.ndarray:
    """Per-lane popcount of uint32 (classic SWAR bit tricks)."""
    v = v.astype(jnp.uint32)
    v = v - ((v >> 1) & jnp.uint32(0x55555555))
    v = (v & jnp.uint32(0x33333333)) + ((v >> 2) & jnp.uint32(0x33333333))
    v = (v + (v >> 4)) & jnp.uint32(0x0F0F0F0F)
    return ((v * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)


def distance(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Elementwise Hamming distance: a, b [..., 8] uint32 -> [...] int32."""
    return jnp.sum(popcount_u32(jnp.bitwise_xor(a, b)), axis=-1)


@jax.jit
def distance_matrix(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """All-pairs Hamming: a [N, 8], b [M, 8] -> [N, M] int32 (0..256)."""
    x = jnp.bitwise_xor(a[:, None, :], b[None, :, :])
    return jnp.sum(popcount_u32(x), axis=-1)
