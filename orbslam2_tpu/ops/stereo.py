"""Stereo correspondence for rectified pairs + RGB-D depth seeding.

Dense redesign of `Frame::ComputeStereoMatches`
(reference src/Frame.cc:513-699): the row-bucketed coarse descriptor match
becomes one gated dense Hamming matrix; the per-keypoint 11x11 SAD sliding
refinement becomes a vmapped strip correlation with a parabola sub-pixel
fit; the sequential median-based outlier cut becomes a sort + mask.

`compute_stereo_from_rgbd` mirrors reference src/Frame.cc:702-726 (virtual
right coordinate u - bf/d).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import jax
import jax.numpy as jnp

from orbslam2_tpu.ops import hamming
from orbslam2_tpu.ops.match import _masked_best2

_SAD_HALF = 5          # 11x11 window (reference w=5, src/Frame.cc:601)
_SLIDE = 5             # +-5 px search (reference L=5, src/Frame.cc:607)
_COARSE_TH = 75        # (TH_HIGH + TH_LOW) / 2 (reference src/Frame.cc:522)


class StereoMatches(NamedTuple):
    u_right: jnp.ndarray  # [N] float32, virtual right x; <0 if unmatched
    depth: jnp.ndarray    # [N] float32; <=0 if unmatched


def _stack_levels(levels: Sequence[jnp.ndarray], half_h: int, half_w: int) -> jnp.ndarray:
    """Stack a pyramid into one [L, H0+2hh, W0+2hw] array (edge-padded,
    top-left aligned). Indexing stacked[level] replaces a lax.switch over
    per-level shapes — vmap-of-switch made XLA compile times explode."""
    H0, W0 = levels[0].shape
    out = []
    for img in levels:
        p = jnp.pad(img, ((half_h, half_h), (half_w, half_w)), mode="edge")
        p = jnp.pad(
            p,
            ((0, H0 - img.shape[0]), (0, W0 - img.shape[1])),
            mode="edge",
        )
        out.append(p)
    return jnp.stack(out)


def _gather_level_patch(stacked: jnp.ndarray, level_idx, cy, cx, half_h: int, half_w: int,
                        level_shapes: Sequence[tuple[int, int]]):
    """Gather a (2hh+1, 2hw+1) patch CENTERED at (cy, cx) from the stacked
    pyramid. With edge padding of (hh, hw), the patch's top-left corner in
    padded coords equals the center in unpadded coords."""
    hs = jnp.asarray([s[0] for s in level_shapes], jnp.int32)
    ws = jnp.asarray([s[1] for s in level_shapes], jnp.int32)
    y = jnp.clip(cy, 0, hs[level_idx] - 1)
    x = jnp.clip(cx, 0, ws[level_idx] - 1)
    return jax.lax.dynamic_slice(
        stacked, (level_idx, y, x), (1, 2 * half_h + 1, 2 * half_w + 1)
    )[0]


def compute_stereo_matches(
    left_xy: jnp.ndarray,
    left_octave: jnp.ndarray,
    left_desc: jnp.ndarray,
    left_valid: jnp.ndarray,
    right_xy: jnp.ndarray,
    right_octave: jnp.ndarray,
    right_desc: jnp.ndarray,
    right_valid: jnp.ndarray,
    left_levels: Sequence[jnp.ndarray],
    right_levels: Sequence[jnp.ndarray],
    scale_factors: jnp.ndarray,
    bf: jnp.ndarray,
    fx: jnp.ndarray,
) -> StereoMatches:
    """Full stereo pipeline. Coordinates are level-0 pixels.

    Disparity range [0, bf/b] = [0, fx] like the reference
    (src/Frame.cc:530-532: minZ = baseline -> maxD = fx).
    """
    N = left_xy.shape[0]
    sf_l = scale_factors[jnp.clip(left_octave, 0, scale_factors.shape[0] - 1)]

    # ---- coarse: gated dense Hamming ----------------------------------
    row_tol = 2.0 * sf_l  # reference r = 2*scaleFactor^octave (src/Frame.cc:552)
    dy = jnp.abs(left_xy[:, 1:2] - right_xy[None, :, 1])
    gate = dy <= row_tol[:, None]
    d_oct = right_octave[None, :] - left_octave[:, None]
    gate &= (d_oct >= -1) & (d_oct <= 1)
    disp = left_xy[:, 0:1] - right_xy[None, :, 0]
    max_d = fx  # disparity at depth == baseline
    gate &= (disp >= -3.0) & (disp <= max_d)
    gate &= left_valid[:, None] & right_valid[None, :]

    dist = hamming.distance_matrix(left_desc, right_desc)
    best_idx, best, _ = _masked_best2(dist, gate)
    # left-right mutual consistency: the matched right feature's best left
    # partner must be this left feature. Occlusion silhouettes and
    # repeating texture produce one-sided matches whose wrong disparity
    # passes the SAD refine (the reference's per-row bucket walk is less
    # exposed because it only scans a 1-row band; the dense matrix needs
    # the explicit check). Kills ~2/3 of gross (>10 %) depth outliers.
    BIG = jnp.int32(1 << 16)
    dm = jnp.where(gate, dist, BIG)
    best_left_for_right = jnp.argmin(dm, axis=0)          # [N] per right feat
    mutual = best_left_for_right[jnp.clip(best_idx, 0, N - 1)] == jnp.arange(N)
    coarse_ok = (best < _COARSE_TH) & mutual

    # ---- fine: SAD strip correlation at the left keypoint's octave ----
    inv_sf = 1.0 / sf_l
    uL = left_xy[:, 0] * inv_sf
    vL = left_xy[:, 1] * inv_sf
    uR0 = right_xy[jnp.clip(best_idx, 0, N - 1), 0] * inv_sf

    lshapes = [img.shape for img in left_levels]
    left_stack = _stack_levels(left_levels, _SAD_HALF, _SAD_HALF)
    right_stack = _stack_levels(right_levels, _SAD_HALF, _SAD_HALF + _SLIDE)

    def refine_one(level, u_l, v_l, u_r0):
        iy = jnp.round(v_l).astype(jnp.int32)
        ixl = jnp.round(u_l).astype(jnp.int32)
        ixr = jnp.round(u_r0).astype(jnp.int32)
        pl = _gather_level_patch(left_stack, level, iy, ixl, _SAD_HALF, _SAD_HALF, lshapes)
        pl = pl - pl[_SAD_HALF, _SAD_HALF]
        strip = _gather_level_patch(
            right_stack, level, iy, ixr, _SAD_HALF, _SAD_HALF + _SLIDE, lshapes
        )
        W = 2 * _SAD_HALF + 1

        def sad(off):
            pr = jax.lax.dynamic_slice(strip, (0, off), (W, W))
            pr = pr - pr[_SAD_HALF, _SAD_HALF]
            return jnp.sum(jnp.abs(pl - pr))

        sads = jnp.stack([sad(o) for o in range(2 * _SLIDE + 1)])
        k = jnp.argmin(sads)
        # parabola sub-pixel (reference src/Frame.cc:648-659)
        km = jnp.clip(k - 1, 0, 2 * _SLIDE)
        kp_ = jnp.clip(k + 1, 0, 2 * _SLIDE)
        s0, sl, sr = sads[k], sads[km], sads[kp_]
        denom = jnp.maximum(2.0 * (sl + sr - 2.0 * s0), 1e-6)
        delta = (sl - sr) / denom
        delta_ok = (jnp.abs(delta) <= 1.0) & (k > 0) & (k < 2 * _SLIDE)
        delta = jnp.where(delta_ok, delta, 0.0)
        u_r_scaled = u_r0 + (k.astype(jnp.float32) - _SLIDE) + delta
        return u_r_scaled, s0

    u_r_scaled, sad_best = jax.vmap(refine_one)(
        jnp.clip(left_octave, 0, scale_factors.shape[0] - 1), uL, vL, uR0
    )
    u_right = u_r_scaled * sf_l
    disparity = left_xy[:, 0] - u_right
    fine_ok = coarse_ok & (disparity > 0.01) & (disparity < max_d)

    # ---- median outlier cut (reference src/Frame.cc:665-697) ----------
    sad_masked = jnp.where(fine_ok, sad_best, jnp.inf)
    order = jnp.sort(sad_masked)
    n_ok = jnp.sum(fine_ok)
    median = order[jnp.clip(n_ok // 2, 0, N - 1)]
    median = jnp.where(jnp.isfinite(median), median, 0.0)
    thresh = 1.5 * 1.4 * median
    final_ok = fine_ok & (sad_best <= thresh)

    depth = jnp.where(final_ok, bf / jnp.maximum(disparity, 1e-6), -1.0)
    return StereoMatches(
        u_right=jnp.where(final_ok, u_right, -1.0),
        depth=depth,
    )


def compute_stereo_from_rgbd(
    xy_raw: jnp.ndarray,
    xy_und: jnp.ndarray,
    valid: jnp.ndarray,
    depth_map: jnp.ndarray,
    depth_factor: jnp.ndarray,
    bf: jnp.ndarray,
) -> StereoMatches:
    """Sample the depth map at the RAW (distorted) keypoint coords and
    synthesize the virtual right coordinate from the UNDISTORTED x
    (reference src/Frame.cc:702-726: depth at kp.pt, u_right from kpU.pt.x
    — pose-opt/BA predict ur in undistorted coordinates, so mixing frames
    biases every stereo residual on distorted cameras)."""
    ix = jnp.clip(jnp.round(xy_raw[:, 0]).astype(jnp.int32), 0, depth_map.shape[1] - 1)
    iy = jnp.clip(jnp.round(xy_raw[:, 1]).astype(jnp.int32), 0, depth_map.shape[0] - 1)
    d = depth_map[iy, ix] * depth_factor
    # depth-discontinuity veto: FAST corners concentrate on occlusion
    # silhouettes where the descriptor mixes fore/background and the sampled
    # depth is a coin flip between them — a cluster of such high-leverage
    # wrong-depth stereo edges drags pose optimization. If the 3x3 depth
    # neighborhood spans > 10 % of the center depth (or holes), demote the
    # feature to a mono edge (keep uv, drop depth/ur).
    H, W = depth_map.shape
    nb_min = jnp.full_like(d, jnp.inf)
    nb_max = jnp.full_like(d, -jnp.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            dn = depth_map[
                jnp.clip(iy + dy, 0, H - 1), jnp.clip(ix + dx, 0, W - 1)
            ] * depth_factor
            nb_min = jnp.minimum(nb_min, dn)
            nb_max = jnp.maximum(nb_max, dn)
    flat = (nb_min > 0) & ((nb_max - nb_min) < 0.1 * jnp.maximum(d, 1e-6))
    ok = valid & (d > 0) & flat
    return StereoMatches(
        u_right=jnp.where(ok, xy_und[:, 0] - bf / jnp.maximum(d, 1e-6), -1.0),
        depth=jnp.where(ok, d, -1.0),
    )
