"""FAST-9/16 corner detection as a whole-image vectorized kernel.

Dense replacement for the per-30x30-cell OpenCV `FAST` calls in the
reference (reference src/ORBextractor.cc:853-861). Instead of looping over
cells with a retry threshold, we score EVERY pixel in one dense pass:

* the 16 Bresenham-circle neighbors become 16 shifted image views;
* the "contiguous arc of >= 9 brighter/darker" test becomes bit tricks on a
  packed 16-bit ring mask (run-length via doubling shifts — no loops);
* the score is the max over the two polarities of the summed thresholded
  absolute differences (OpenCV-style corner strength);
* non-max suppression is a 3x3 max-pool comparison.

The low-threshold retry (reference th=20 -> 7) is preserved by computing
corners at both thresholds in the same pass and letting the selection stage
prefer high-threshold corners (see orb.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Bresenham circle of radius 3, clockwise from 12 o'clock: (dy, dx).
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LENGTH = 9


def _ring_stack(image: jnp.ndarray) -> jnp.ndarray:
    """[H, W] -> [16, H, W] of circle-neighbor intensities (zero-padded edges)."""
    padded = jnp.pad(image, 3, mode="edge")
    H, W = image.shape
    views = [
        jax.lax.dynamic_slice(padded, (3 + dy, 3 + dx), (H, W))
        for dy, dx in CIRCLE_OFFSETS
    ]
    return jnp.stack(views, axis=0)


def _has_arc(mask_bits: jnp.ndarray, arc: int = ARC_LENGTH) -> jnp.ndarray:
    """mask_bits: [H, W] int32 with 16 ring bits set. True if a circular run
    of >= `arc` consecutive set bits exists.

    Doubling the ring into 32 bits makes circular runs linear runs; then
    run-length->=9 is AND-of-shifts with doubling strides (1,2,4,1)."""
    x = mask_bits | (mask_bits << 16)
    x = x & (x >> 1)   # runs >= 2
    x = x & (x >> 2)   # runs >= 4
    x = x & (x >> 4)   # runs >= 8
    x = x & (x >> 1)   # runs >= 9
    return (x & 0xFFFF) != 0


@partial(jax.jit, static_argnames=())
def fast_score_map(image: jnp.ndarray, threshold: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Dense FAST response.

    Args:
      image: [H, W] float32 grayscale (0..255).
      threshold: scalar intensity threshold.

    Returns:
      (is_corner [H, W] bool, score [H, W] float32).
    """
    corner, _, score = fast_score_map2(image, threshold, threshold)
    return corner, score


@partial(jax.jit, static_argnames=())
def fast_score_map2(
    image: jnp.ndarray, th_lo: jnp.ndarray, th_hi: jnp.ndarray
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Dense FAST response at TWO thresholds sharing one ring-diff pass.

    The ring stack and diffs dominate the per-pixel cost; the reference's
    retry threshold (src/ORBextractor.cc:853-861) needs corner masks at both
    the high and low threshold, so compute both from the same diffs.

    Returns (corner_lo [H, W] bool, corner_hi [H, W] bool,
    score [H, W] float32 at th_lo).
    """
    ring = _ring_stack(image)          # [16, H, W]
    center = image[None]
    diff = ring - center               # [16, H, W]
    weights = (1 << jnp.arange(16, dtype=jnp.int32))[:, None, None]

    def corner_at(th):
        b_bits = jnp.sum(jnp.where(diff > th, weights, 0), axis=0)
        d_bits = jnp.sum(jnp.where(diff < -th, weights, 0), axis=0)
        return _has_arc(b_bits) | _has_arc(d_bits)

    corner_lo = corner_at(th_lo)
    corner_hi = corner_at(th_hi)

    # corner strength: total thresholded excursion of the stronger polarity
    b_score = jnp.sum(jnp.maximum(diff - th_lo, 0.0), axis=0)
    d_score = jnp.sum(jnp.maximum(-diff - th_lo, 0.0), axis=0)
    score = jnp.maximum(b_score, d_score)
    return corner_lo, corner_hi, score


def nms_3x3(score: jnp.ndarray) -> jnp.ndarray:
    """True where score is the strict-ish max of its 3x3 neighborhood."""
    padded = jnp.pad(score, 1, mode="constant", constant_values=-jnp.inf)
    H, W = score.shape
    neigh = jnp.stack(
        [
            jax.lax.dynamic_slice(padded, (1 + dy, 1 + dx), (H, W))
            for dy in (-1, 0, 1)
            for dx in (-1, 0, 1)
            if not (dy == 0 and dx == 0)
        ],
        axis=0,
    )
    return score >= jnp.max(neigh, axis=0)


def detect_stack(
    images: jnp.ndarray,
    shapes: tuple,
    ini_threshold: float,
    min_threshold: float,
    border: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched `detect` over a stack of pyramid levels sharing one canvas.

    `images` is [L, Hc, Wc] with each level's pixels placed at the origin
    and zeros elsewhere; `shapes` is the static per-level (H, W). One
    batched chain replaces L sequential per-level FAST programs.

    Exact vs the per-level path: FAST reads at most 3 px around a pixel and
    NMS 1 px, while the border mask keeps every survivor >= `border`
    (>= 19) px inside its own level, so the zero canvas padding beyond a
    level's true extent is never read by any kept corner.
    """
    corner_lo, corner_hi, score = jax.vmap(
        lambda im: fast_score_map2(
            im, jnp.float32(min_threshold), jnp.float32(ini_threshold)
        )
    )(images)
    Hc, Wc = images.shape[1], images.shape[2]
    ys = jnp.arange(Hc)[None, :, None]
    xs = jnp.arange(Wc)[None, None, :]
    hs = jnp.asarray([h for h, _ in shapes], jnp.int32)[:, None, None]
    ws = jnp.asarray([w for _, w in shapes], jnp.int32)[:, None, None]
    in_border = (
        (ys >= border) & (ys < hs - border) & (xs >= border) & (xs < ws - border)
    )
    keep = (
        corner_lo
        & in_border
        & jax.vmap(nms_3x3)(jnp.where(corner_lo, score, -jnp.inf))
    )
    score = jnp.where(keep, score, -jnp.inf)
    return score, corner_hi & keep


def detect(
    image: jnp.ndarray,
    ini_threshold: float,
    min_threshold: float,
    border: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Dual-threshold FAST with NMS and border masking.

    Returns (score [H, W], strong [H, W] bool). `score` is -inf where no
    corner passes even the low threshold; corners that pass only the low
    threshold get their (positive) score; `strong` marks high-threshold
    corners so selection can prefer them (reference's retry semantics,
    src/ORBextractor.cc:853-861).
    """
    corner_lo, corner_hi, score = fast_score_map2(
        image, jnp.float32(min_threshold), jnp.float32(ini_threshold)
    )

    H, W = image.shape
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    in_border = (
        (ys >= border) & (ys < H - border) & (xs >= border) & (xs < W - border)
    )

    keep = corner_lo & in_border & nms_3x3(jnp.where(corner_lo, score, -jnp.inf))
    score = jnp.where(keep, score, -jnp.inf)
    return score, corner_hi & keep
