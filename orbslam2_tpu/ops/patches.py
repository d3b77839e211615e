"""Batched square-patch gathering and intensity-centroid orientation.

Replaces the reference's per-keypoint pointer walks: `IC_Angle`
(reference src/ORBextractor.cc:78-105) becomes one vmapped masked moment
reduction over gathered patches.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def gather_patches(image: jnp.ndarray, xy: jnp.ndarray, half: int) -> jnp.ndarray:
    """Gather (2*half+1)^2 patches centered at integer keypoint coords.

    Args:
      image: [H, W] float32.
      xy: [N, 2] float32/int (x, y) keypoint centers (level coords).
      half: patch half-size.

    Returns: [N, 2*half+1, 2*half+1] float32.

    Implementation: pad once, vmap a dynamic_slice per keypoint. XLA turns
    this into a batched gather; N is static so the whole thing jits.
    """
    size = 2 * half + 1
    padded = jnp.pad(image, half, mode="edge")
    ix = jnp.clip(xy[:, 0].astype(jnp.int32), 0, image.shape[1] - 1)
    iy = jnp.clip(xy[:, 1].astype(jnp.int32), 0, image.shape[0] - 1)

    def one(y, x):
        return jax.lax.dynamic_slice(padded, (y, x), (size, size))

    return jax.vmap(one)(iy, ix)


def gather_patches_stack(
    stack: jnp.ndarray, level: jnp.ndarray, xy: jnp.ndarray, half: int
) -> jnp.ndarray:
    """Gather patches for keypoints spread across pyramid LEVELS in one
    batched call.

    Args:
      stack: [L, Hp, Wp] canvas of per-level images, each already
        edge-padded by `half` and placed at the origin (regions beyond a
        level's true extent are never read as long as keypoints sit at
        least `half` inside their level — the FAST edge border
        guarantees this).
      level: [N] int32 level index per keypoint.
      xy: [N, 2] keypoint centers in LEVEL-LOCAL coords.
      half: patch half-size.

    Returns: [N, 2*half+1, 2*half+1] float32. One fused gather replaces
    num_levels sequential per-level gathers in the extractor."""
    size = 2 * half + 1
    ix = jnp.clip(xy[:, 0].astype(jnp.int32), 0, stack.shape[2] - size)
    iy = jnp.clip(xy[:, 1].astype(jnp.int32), 0, stack.shape[1] - size)

    def one(l, y, x):
        return jax.lax.dynamic_slice(stack, (l, y, x), (1, size, size))[0]

    return jax.vmap(one)(level, iy, ix)


def gather_patches_stack_mc(
    stack: jnp.ndarray, level: jnp.ndarray, xy: jnp.ndarray, half: int
) -> jnp.ndarray:
    """Multi-channel variant of gather_patches_stack: stack [L, Hp, Wp, C]
    -> [N, 2*half+1, 2*half+1, C].

    Fetching the raw and blurred canvases as channels of ONE gather pays
    the per-slice gather overhead once instead of twice."""
    size = 2 * half + 1
    C = stack.shape[3]
    ix = jnp.clip(xy[:, 0].astype(jnp.int32), 0, stack.shape[2] - size)
    iy = jnp.clip(xy[:, 1].astype(jnp.int32), 0, stack.shape[1] - size)

    def one(l, y, x):
        return jax.lax.dynamic_slice(stack, (l, y, x, 0), (1, size, size, C))[0]

    return jax.vmap(one)(level, iy, ix)


@partial(jax.jit, static_argnames=("half",))
def ic_angle(patches: jnp.ndarray, half: int = 15) -> jnp.ndarray:
    """Intensity-centroid orientation per patch (radians).

    theta = atan2(m01, m10) over the circular region of radius `half`
    (reference IC_Angle, src/ORBextractor.cc:78-105).

    patches: [N, S, S] with S = 2*half+1.
    """
    size = 2 * half + 1
    ys = jnp.arange(size, dtype=jnp.float32) - half
    xs = jnp.arange(size, dtype=jnp.float32) - half
    yy = ys[:, None]
    xx = xs[None, :]
    mask = (yy * yy + xx * xx) <= float(half * half) + 1e-3
    wx = jnp.where(mask, xx, 0.0)
    wy = jnp.where(mask, yy, 0.0)
    m10 = jnp.einsum("nij,ij->n", patches, wx)
    m01 = jnp.einsum("nij,ij->n", patches, wy)
    return jnp.arctan2(m01, m10)
