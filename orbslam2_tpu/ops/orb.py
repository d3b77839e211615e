"""ORB feature extraction: FAST + orientation + rotated BRIEF over a pyramid.

Dense, static-shape redesign of the reference's `ORBextractor::operator()`
(reference src/ORBextractor.cc:1084-1150):

* FAST runs densely over every pixel of every level (ops/fast.py) instead
  of per-30x30-cell loops;
* the quadtree `DistributeOctTree` (reference src/ORBextractor.cc:562-792)
  is replaced by grid-bucketed rank selection — keypoints are ranked within
  spatial cells and selected cell-round-robin by response, which preserves
  the spatial-uniformity intent with sort/top_k primitives XLA compiles
  well;
* orientation is a batched masked moment reduction (ops/patches.py);
* the descriptor is steered BRIEF over a deterministic generated point
  pattern — NOT the reference's hardcoded `bit_pattern_31_` table
  (reference src/ORBextractor.cc:175-432); the pattern is drawn once from a
  seeded Gaussian (ORB paper construction) and is a fixed constant
  thereafter. Descriptors are packed 256 bits -> 8 x uint32 for
  XOR+popcount matching.

Output shapes are fully static: `feature_slots` padded slots with a
validity mask.
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from orbslam2_tpu.config import OrbConfig
from orbslam2_tpu.ops import fast, patches, pyramid

# ---------------------------------------------------------------------------
# BRIEF sampling pattern
# ---------------------------------------------------------------------------

_PATTERN_RADIUS = 12.5


def make_brief_pattern(seed: int = 7, n_bits: int = 256) -> np.ndarray:
    """Generate a 256-pair BRIEF sampling pattern, [n_bits, 4] = (x1,y1,x2,y2).

    Pairs drawn i.i.d. from N(0, (patch/5)^2) clipped to a disk of radius
    12.5 so any rotation keeps samples inside the 31x31 patch (the ORB
    paper's Gaussian construction; deliberately not the reference's
    hardcoded table).
    """
    rng = np.random.default_rng(seed)
    sigma = 31.0 / 5.0
    pts = rng.normal(0.0, sigma, size=(n_bits * 2, 2))
    r = np.linalg.norm(pts, axis=1)
    scale = np.minimum(1.0, _PATTERN_RADIUS / np.maximum(r, 1e-9))
    pts = pts * scale[:, None]
    return pts.reshape(n_bits, 4).astype(np.float32)


_BRIEF_PATTERN = jnp.asarray(make_brief_pattern())


class FrameFeatures(NamedTuple):
    """Static-shape per-frame feature set (the fixed-size analogue of the keypoint
    vectors in reference include/Frame.h:147-160)."""

    xy: jnp.ndarray        # [S, 2] float32, level-0 pixel coords (distorted/raw)
    response: jnp.ndarray  # [S] float32
    angle: jnp.ndarray     # [S] float32 radians
    octave: jnp.ndarray    # [S] int32 pyramid level
    desc: jnp.ndarray      # [S, 8] uint32 packed 256-bit descriptors
    valid: jnp.ndarray     # [S] bool

    @property
    def num_slots(self) -> int:
        return self.xy.shape[0]


# ---------------------------------------------------------------------------
# selection: grid-bucketed rank ordering
# ---------------------------------------------------------------------------


def _scan_depth(n_keep: int, n_cells: int, cell_size: int) -> int:
    """Per-cell scan depth R: covers the budget even if only half the
    cells contain corners (see select_uniform)."""
    return int(min(max(2, 2 * -(-n_keep // max(n_cells, 1)) + 1), cell_size * cell_size))


def select_uniform(
    score: jnp.ndarray,
    strong: jnp.ndarray,
    n_keep: int,
    n_candidates: int,
    cell_size: int,
    n_scan: int | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Pick `n_keep` spatially-uniform keypoints from a dense score map.

    Returns (xy [n_keep, 2] float32, response [n_keep], valid [n_keep]).

    Priority = score + big bonus for high-threshold corners, so weak
    (retry-threshold) corners are used only where no strong corner exists —
    the reference's per-cell retry semantics (src/ORBextractor.cc:853-861).
    Selection order = (rank within cell, -priority): i.e. every cell's best
    corner is taken before any cell's second-best — the spatial-uniformity
    intent of DistributeOctTree (src/ORBextractor.cc:562-792).
    """
    H, W = score.shape
    prio_map = jnp.where(strong, score + 1e6, score)
    ncy = (H + cell_size - 1) // cell_size
    ncx = (W + cell_size - 1) // cell_size
    n_cells = ncy * ncx
    # pad to whole cells, tile into [n_cells, cell_size^2]
    padded = jnp.full((ncy * cell_size, ncx * cell_size), -jnp.inf, prio_map.dtype)
    padded = padded.at[:H, :W].set(prio_map)
    cells = (
        padded.reshape(ncy, cell_size, ncx, cell_size)
        .transpose(0, 2, 1, 3)
        .reshape(n_cells, cell_size * cell_size)
    )
    # per-cell top-R by iterated masked max: a global top_k over H*W pixels
    # sorts ~300k elements per level; R max-pool passes over the cell
    # tiles are plain reductions. R covers the budget even if
    # only half the cells contain corners.
    R = n_scan if n_scan is not None else _scan_depth(n_keep, n_cells, cell_size)
    rows = jnp.arange(n_cells)
    prios, within = [], []
    for _ in range(R):
        am = jnp.argmax(cells, axis=1)
        m = cells[rows, am]
        prios.append(m)
        within.append(am.astype(jnp.int32))
        cells = cells.at[rows, am].set(-jnp.inf)
    prio = jnp.concatenate(prios)              # [n_cells * R]
    within = jnp.concatenate(within)
    rank = jnp.repeat(jnp.arange(R, dtype=jnp.float32), n_cells)
    cid = jnp.tile(rows.astype(jnp.int32), R)
    valid = jnp.isfinite(prio)
    ys = (cid // ncx) * cell_size + within // cell_size
    xs = (cid % ncx) * cell_size + within % cell_size
    # key: ascending rank, then descending priority; invalid last (same
    # ordering as the reference's DistributeOctTree round-robin intent)
    key = rank * 1e7 - jnp.minimum(prio, 9e6)
    key = jnp.where(valid, key, jnp.inf)
    _, sel = jax.lax.top_k(-key, n_keep)
    strong_sel = strong[ys[sel], xs[sel]]
    resp = jnp.where(valid[sel], prio[sel] - jnp.where(strong_sel, 1e6, 0.0), 0.0)
    xy = jnp.stack([xs[sel], ys[sel]], axis=-1).astype(jnp.float32)
    return xy, resp, valid[sel]


# ---------------------------------------------------------------------------
# descriptors
# ---------------------------------------------------------------------------


def brief_from_patches(pt: jnp.ndarray, angle: jnp.ndarray, half: int = 16) -> jnp.ndarray:
    """Steered-BRIEF descriptors from pre-gathered blurred patches.

    For each keypoint: rotate the 256x2 sample offsets by its orientation,
    round to the nearest pixel, compare the two samples, pack bits
    (reference computeOrbDescriptor, src/ORBextractor.cc:120-161 — same
    steering math, batched).
    """
    pat = _BRIEF_PATTERN  # [256, 4]
    p1 = pat[:, 0:2]
    p2 = pat[:, 2:4]
    ca, sa = jnp.cos(angle), jnp.sin(angle)  # [N]

    def rotate(p):  # [256, 2] x [N] -> [N, 256, 2]
        x = p[None, :, 0] * ca[:, None] - p[None, :, 1] * sa[:, None]
        y = p[None, :, 0] * sa[:, None] + p[None, :, 1] * ca[:, None]
        return jnp.stack([x, y], axis=-1)

    r1 = jnp.round(rotate(p1)).astype(jnp.int32) + half  # patch coords
    r2 = jnp.round(rotate(p2)).astype(jnp.int32) + half

    size = 2 * half + 1
    flat = pt.reshape(pt.shape[0], size * size)
    i1 = r1[..., 1] * size + r1[..., 0]  # [N, 256]
    i2 = r2[..., 1] * size + r2[..., 0]
    # Sample via a FUSED one-hot reduction instead of take_along_axis:
    # bit = (v1 < v2) = (sum_j flat[j] * (onehot(i2) - onehot(i1)) > 0).
    # The compare-select-reduce fuses into one sweep with no gather, and is
    # EXACT — f32 subtraction of two exact values preserves the sign.
    iota = jnp.arange(size * size, dtype=jnp.int32)
    w = (i2[:, :, None] == iota).astype(flat.dtype) - (
        i1[:, :, None] == iota
    ).astype(flat.dtype)
    d = jnp.sum(flat[:, None, :] * w, axis=-1)  # [N, 256] = v2 - v1
    bits = (d > 0).astype(jnp.uint32)  # [N, 256]
    return _pack_bits(bits)


def brief_descriptors(
    blurred: jnp.ndarray,
    xy: jnp.ndarray,
    angle: jnp.ndarray,
    half: int = 16,
) -> jnp.ndarray:
    """Steered-BRIEF descriptors, [N, 8] uint32 (single-image variant)."""
    pt = patches.gather_patches(blurred, xy, half)  # [N, S, S]
    return brief_from_patches(pt, angle, half)


def _pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """[N, 256] {0,1} uint32 -> [N, 8] uint32."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    words = bits.reshape(bits.shape[0], 8, 32) * (jnp.uint32(1) << shifts)[None, None, :]
    return words.sum(axis=-1, dtype=jnp.uint32)


# ---------------------------------------------------------------------------
# full extractor
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("orb",))
def extract(image: jnp.ndarray, orb: OrbConfig) -> FrameFeatures:
    """Full ORB extraction on one grayscale image [H, W] float32 (0..255).

    The per-level loop is a Python loop over static shapes — XLA sees one
    fused graph (one compilation per camera geometry).
    """
    if orb.normalize_exposure:
        # Gain normalization: FAST compares absolute intensity differences
        # against a fixed threshold, so camera gain/exposure drift makes
        # borderline corners flicker between frames and destabilizes
        # tracking. Rescaling to a fixed mean makes detection
        # gain-invariant (BRIEF already is). One reduction.
        mean = jnp.mean(image)
        image = image * (120.0 / jnp.maximum(mean, 1.0))
    levels = pyramid.build_pyramid(image, orb)
    budgets = pyramid.feature_budgets(orb)
    scales = pyramid.level_scales(orb)
    L = orb.num_levels
    shapes = [lv.shape for lv in levels]

    # stage 1: FAST detection + spatially-uniform selection. Level 0 runs
    # at native resolution; levels 1..L-1 are stacked on a shared
    # level-1-sized canvas so their FAST + per-cell selection run as ONE
    # batched chain instead of L-1 sequential small programs. The canvas
    # wastes ~2.3x pixels of compute but the batched chain amortizes every
    # kernel launch across levels.
    xs_loc, xs, resps, octaves, valids = [], [], [], [], []
    if budgets[0] > 0:
        score0, strong0 = fast.detect(
            levels[0], orb.ini_th_fast, orb.min_th_fast, orb.edge_threshold
        )
        xy0, resp0, valid0 = select_uniform(
            score0, strong0, budgets[0], orb.candidates_per_level, orb.cell_size
        )
        xs_loc.append(xy0)
        xs.append(xy0 * scales[0])
        resps.append(resp0)
        octaves.append(jnp.full((budgets[0],), 0, jnp.int32))
        valids.append(valid0)

    hi_levels = [lvl for lvl in range(1, L) if budgets[lvl] > 0]
    stack = None
    if L > 1:
        H1, W1 = shapes[1]
        stack = jnp.stack(
            [
                jnp.pad(
                    levels[lvl],
                    ((0, H1 - shapes[lvl][0]), (0, W1 - shapes[lvl][1])),
                )
                for lvl in range(1, L)
            ]
        )
    if hi_levels:
        sub = [lvl - 1 for lvl in hi_levels]
        scoreS, strongS = fast.detect_stack(
            stack[jnp.asarray(sub)] if len(sub) < L - 1 else stack,
            tuple(shapes[lvl] for lvl in hi_levels),
            orb.ini_th_fast, orb.min_th_fast, orb.edge_threshold,
        )
        # uniform scan depth/top-k across the batch: take the max of each
        # level's requirement computed from its REAL cell count (the canvas
        # has more, permanently-empty, cells than a small level)
        def cells_of(shape):
            ncy = (shape[0] + orb.cell_size - 1) // orb.cell_size
            ncx = (shape[1] + orb.cell_size - 1) // orb.cell_size
            return ncy * ncx

        R = max(
            _scan_depth(budgets[lvl], cells_of(shapes[lvl]), orb.cell_size)
            for lvl in hi_levels
        )
        kmax = max(budgets[lvl] for lvl in hi_levels)
        xyS, respS, validS = jax.vmap(
            lambda s, st: select_uniform(
                s, st, kmax, orb.candidates_per_level, orb.cell_size, n_scan=R
            )
        )(scoreS, strongS)
        # per-level slices: select_uniform returns entries sorted by
        # (cell-rank, -priority), so the first budget[lvl] rows are exactly
        # what a per-level top-k of that size would return
        for i, lvl in enumerate(hi_levels):
            b = budgets[lvl]
            xs_loc.append(xyS[i, :b])
            xs.append(xyS[i, :b] * scales[lvl])
            resps.append(respS[i, :b])
            octaves.append(jnp.full((b,), lvl, jnp.int32))
            valids.append(validS[i, :b])

    xy_loc = jnp.concatenate(xs_loc, axis=0)
    xy = jnp.concatenate(xs, axis=0)
    resp = jnp.concatenate(resps, axis=0)
    octave = jnp.concatenate(octaves, axis=0)
    valid = jnp.concatenate(valids, axis=0)

    # stage 2: orientation + descriptors for ALL levels in one batch. The
    # per-level images (raw for IC angle, blurred for BRIEF) are edge-
    # padded and placed on a [L, Hp, Wp] canvas; a single stacked gather
    # then feeds one ic_angle and one BRIEF over every keypoint — the
    # per-level loop serialized num_levels small gather/moment/compare
    # chains. Exact: the FAST edge border (>= edge_threshold) keeps every
    # patch inside its own level, so canvas padding is never read.
    half_ic = orb.half_patch          # 31x31 IC-angle window (ref HALF_PATCH_SIZE)
    half_br = 16                      # 33x33 BRIEF sampling window
    H0, W0 = levels[0].shape
    Hp, Wp = H0 + 2 * half_br, W0 + 2 * half_br
    # raw (IC angle) and blurred (BRIEF) images ride as CHANNELS of one
    # canvas so a single gather fetches both patches per keypoint. The blur
    # for levels 1..L-1 runs
    # batched on the detection stack; the 16-px canvas margin is zeros
    # (never read: keypoints sit >= edge_threshold=19 px inside their
    # level, BRIEF samples <= 13 px from the keypoint, the blur reads
    # <= 3 px around a sample, and the IC window <= half_patch=15 px).
    pair0 = jnp.pad(
        jnp.stack([levels[0], pyramid.gaussian_blur(levels[0])], axis=-1),
        ((half_br, half_br), (half_br, half_br), (0, 0)),
    )
    if L > 1:
        H1, W1 = shapes[1]
        blurS = jax.vmap(pyramid.gaussian_blur)(stack)
        pairS = jnp.pad(
            jnp.stack([stack, blurS], axis=-1),
            (
                (0, 0),
                (half_br, Hp - half_br - H1),
                (half_br, Wp - half_br - W1),
                (0, 0),
            ),
        )
        canvas = jnp.concatenate([pair0[None], pairS], axis=0)
    else:
        canvas = pair0[None]
    both = patches.gather_patches_stack_mc(canvas, octave, xy_loc, half_br)
    raw_patches = both[..., 0]
    blur_patches = both[..., 1]
    crop = half_br - half_ic
    angle = patches.ic_angle(
        raw_patches[:, crop: crop + 2 * half_ic + 1, crop: crop + 2 * half_ic + 1],
        half_ic,
    )
    desc = brief_from_patches(blur_patches, angle, half_br)

    # pad to the static slot count
    S = orb.feature_slots
    n = xy.shape[0]
    pad = S - n
    if pad < 0:
        raise ValueError(f"feature budget {n} exceeds feature_slots {S}")
    if pad:
        xy = jnp.pad(xy, ((0, pad), (0, 0)))
        resp = jnp.pad(resp, (0, pad))
        angle = jnp.pad(angle, (0, pad))
        octave = jnp.pad(octave, (0, pad))
        desc = jnp.pad(desc, ((0, pad), (0, 0)))
        valid = jnp.pad(valid, (0, pad))
    return FrameFeatures(xy=xy, response=resp, angle=angle, octave=octave, desc=desc, valid=valid)
