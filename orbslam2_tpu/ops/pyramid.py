"""Image pyramid and separable Gaussian blur.

Static-shape replacement for the reference's `ComputePyramid`
(reference src/ORBextractor.cc:1153-1180, cv::resize + copyMakeBorder) and
the 7x7 sigma=2 `cv::GaussianBlur` (reference src/ORBextractor.cc:1130).
All shapes are static: level sizes are computed at trace time from the
config, so XLA sees one fixed graph per camera geometry.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from orbslam2_tpu.config import OrbConfig


def level_scales(orb: OrbConfig) -> list[float]:
    """Scale of each pyramid level (1.0, 1.2, 1.44, ...)."""
    return [orb.scale_factor**i for i in range(orb.num_levels)]


def level_shapes(height: int, width: int, orb: OrbConfig) -> list[tuple[int, int]]:
    """Static (H, W) per level, rounded like cv::resize(1/scale)."""
    shapes = []
    for s in level_scales(orb):
        shapes.append((max(int(round(height / s)), 32), max(int(round(width / s)), 32)))
    return shapes


def feature_budgets(orb: OrbConfig) -> list[int]:
    """Per-level feature budget with geometric decay 1/scale_factor.

    Mirrors the reference's allocation (reference src/ORBextractor.cc:498-559):
    nfeatures * (1-f)/(1-f^L) * f^l, remainder to the coarsest level.
    """
    f = 1.0 / orb.scale_factor
    n = orb.num_features
    first = n * (1 - f) / (1 - f**orb.num_levels)
    budgets = [int(round(first * f**i)) for i in range(orb.num_levels - 1)]
    budgets.append(max(n - sum(budgets), 0))
    return budgets


def build_pyramid(image: jnp.ndarray, orb: OrbConfig) -> list[jnp.ndarray]:
    """Grayscale image [H, W] float32 -> list of per-level images.

    Successive bilinear resizes (each level from the previous, like the
    reference) to avoid aliasing from direct large downscales.
    """
    levels = [image]
    shapes = level_shapes(image.shape[0], image.shape[1], orb)
    for lvl in range(1, orb.num_levels):
        prev = levels[-1]
        levels.append(
            jax.image.resize(prev, shapes[lvl], method="bilinear", antialias=False)
        )
    return levels


def gaussian_kernel_1d(size: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    half = size // 2
    x = jnp.arange(-half, half + 1, dtype=jnp.float32)
    k = jnp.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / jnp.sum(k)


@partial(jax.jit, static_argnames=("size",))
def gaussian_blur(image: jnp.ndarray, size: int = 7, sigma: float = 2.0) -> jnp.ndarray:
    """Separable Gaussian blur with reflect padding, [H, W] -> [H, W].

    Two 1-D convolutions (XLA fuses the taps)."""
    k = gaussian_kernel_1d(size, sigma)
    half = size // 2
    x = jnp.pad(image, ((half, half), (0, 0)), mode="reflect")
    # vertical pass: sum of shifted rows
    rows = sum(
        x[i : i + image.shape[0], :] * k[i] for i in range(size)
    )
    y = jnp.pad(rows, ((0, 0), (half, half)), mode="reflect")
    out = sum(y[:, i : i + image.shape[1]] * k[i] for i in range(size))
    return out
