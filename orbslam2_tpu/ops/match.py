"""Descriptor matching kernels: dense gated Hamming matching with ratio
tests, rotation-consistency filtering, projection-guided and epipolar-guided
search.

Dense redesign of `ORBmatcher` (reference src/ORBmatcher.cc). The
reference prunes candidates through grid cells / BoW buckets before
computing Hamming distances one pair at a time; here the device computes
the FULL [A, B] distance matrix and every pruning rule is a mask added to
it. Constants follow the reference: TH_HIGH=100, TH_LOW=50,
HISTO_LENGTH=30 (reference src/ORBmatcher.cc:37-39).

All matchers return per-A best-candidate indices plus a per-B (feature)
assignment with conflicts resolved by minimum distance — the parallel
equivalent of the reference's sequential overwrite logic.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam2_tpu.ops import hamming

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
_BIG = jnp.int32(1 << 20)


class MatchResult(NamedTuple):
    # per-query (A) results
    best_idx: jnp.ndarray    # [A] int32 index into B, -1 if no match
    best_dist: jnp.ndarray   # [A] int32
    # per-target (B) assignment after conflict resolution
    assigned: jnp.ndarray    # [B] int32 index into A, -1 if none

    @property
    def num_matches(self) -> jnp.ndarray:
        return jnp.sum(self.best_idx >= 0)


def _masked_best2(dist: jnp.ndarray, gate: jnp.ndarray):
    """Per-row best and second-best over a gated distance matrix.

    dist: [A, B] int32; gate: [A, B] bool. Returns (best_idx, best, second).
    """
    d = jnp.where(gate, dist, _BIG)
    best = jnp.min(d, axis=1)
    best_idx = jnp.argmin(d, axis=1).astype(jnp.int32)
    d2 = d.at[jnp.arange(d.shape[0]), best_idx].set(_BIG)
    second = jnp.min(d2, axis=1)
    return best_idx, best, second


def _resolve_conflicts(best_idx: jnp.ndarray, best_dist: jnp.ndarray, ok: jnp.ndarray, n_b: int):
    """Keep only the lowest-distance A for each B (parallel duplicate kill).

    Returns (kept_ok [A] bool, assigned [B] int32).
    """
    tgt = jnp.where(ok, best_idx, n_b)  # invalid -> scratch slot
    # scatter-min distances per target
    min_per_b = jnp.full((n_b + 1,), _BIG, jnp.int32).at[tgt].min(
        jnp.where(ok, best_dist, _BIG)
    )
    kept = ok & (best_dist == min_per_b[tgt])
    # tie-break equal distances: keep lowest A index
    a_ids = jnp.arange(best_idx.shape[0], dtype=jnp.int32)
    min_a = jnp.full((n_b + 1,), jnp.int32(1 << 30)).at[tgt].min(
        jnp.where(kept, a_ids, jnp.int32(1 << 30))
    )
    kept = kept & (a_ids == min_a[tgt])
    assigned = jnp.full((n_b + 1,), -1, jnp.int32).at[tgt].max(
        jnp.where(kept, a_ids, -1)
    )[:n_b]
    return kept, assigned


def rotation_consistency_mask(
    angle_a: jnp.ndarray, angle_b: jnp.ndarray, best_idx: jnp.ndarray, ok: jnp.ndarray
) -> jnp.ndarray:
    """Keep only matches whose angle difference falls in the 3 dominant
    histogram bins (reference ComputeThreeMaxima + usage,
    src/ORBmatcher.cc:1663-1696, 663-684)."""
    two_pi = 2.0 * jnp.pi
    diff = angle_a - angle_b[jnp.clip(best_idx, 0, angle_b.shape[0] - 1)]
    diff = jnp.mod(diff, two_pi)
    bins = jnp.clip((diff * (HISTO_LENGTH / two_pi)).astype(jnp.int32), 0, HISTO_LENGTH - 1)
    hist = jnp.zeros((HISTO_LENGTH,), jnp.int32).at[bins].add(ok.astype(jnp.int32))
    top_vals, top_idx = jax.lax.top_k(hist, 3)
    # reference drops bins 2 and 3 when much weaker than bin 1 (0.1 factor,
    # src/ORBmatcher.cc:1684-1695)
    admit2 = jnp.where(top_vals[1] > 0.1 * top_vals[0], top_idx[1], -1)
    admit3 = jnp.where(top_vals[2] > 0.1 * top_vals[0], top_idx[2], -1)
    keep_bin = (bins == top_idx[0]) | (bins == admit2) | (bins == admit3)
    return ok & keep_bin


def match_gated(
    desc_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    gate: jnp.ndarray,
    max_dist: int = TH_LOW,
    ratio: float = 1.0,
    angle_a: jnp.ndarray | None = None,
    angle_b: jnp.ndarray | None = None,
    check_rotation: bool = False,
) -> MatchResult:
    """Generic dense matcher: full Hamming matrix + gate mask + ratio test
    (+ optional rotation-consistency histogram filter)."""
    dist = hamming.distance_matrix(desc_a, desc_b)
    best_idx, best, second = _masked_best2(dist, gate)
    ok = best <= max_dist
    if ratio < 1.0:
        ok = ok & (best.astype(jnp.float32) <= ratio * second.astype(jnp.float32))
    if check_rotation:
        ok = rotation_consistency_mask(angle_a, angle_b, best_idx, ok)
    kept, assigned = _resolve_conflicts(best_idx, best, ok, desc_b.shape[0])
    return MatchResult(
        best_idx=jnp.where(kept, best_idx, -1),
        best_dist=jnp.where(kept, best, _BIG),
        assigned=assigned,
    )


def radius_gate(
    pred_uv: jnp.ndarray,
    feat_xy: jnp.ndarray,
    radius: jnp.ndarray,
    valid_a: jnp.ndarray,
    valid_b: jnp.ndarray,
) -> jnp.ndarray:
    """[A, B] mask: feature b within `radius[a]` pixels of projection a."""
    d = pred_uv[:, None, :] - feat_xy[None, :, :]
    r2 = jnp.sum(d * d, axis=-1)
    return (r2 <= (radius[:, None] ** 2)) & valid_a[:, None] & valid_b[None, :]


def octave_gate(
    pred_octave: jnp.ndarray, feat_octave: jnp.ndarray, lo: int = -1, hi: int = 1
) -> jnp.ndarray:
    """[A, B] mask: feature octave within [pred+lo, pred+hi]
    (reference src/ORBmatcher.cc:110-117 searches [nPredictedLevel-1, nPredictedLevel])."""
    d = feat_octave[None, :] - pred_octave[:, None]
    return (d >= lo) & (d <= hi)


def search_by_projection(
    point_desc: jnp.ndarray,
    point_uv: jnp.ndarray,
    point_octave: jnp.ndarray,
    point_valid: jnp.ndarray,
    feat_desc: jnp.ndarray,
    feat_xy: jnp.ndarray,
    feat_octave: jnp.ndarray,
    feat_valid: jnp.ndarray,
    radius: jnp.ndarray,
    max_dist: int = TH_HIGH,
    ratio: float = 0.8,
) -> MatchResult:
    """Project map points into a frame and match within per-point radii
    (reference SearchByProjection for the local map, src/ORBmatcher.cc:73-157:
    view-angle dependent radius, scale-band gate, best/second ratio)."""
    gate = radius_gate(point_uv, feat_xy, radius, point_valid, feat_valid)
    gate = gate & octave_gate(point_octave, feat_octave)
    return match_gated(point_desc, feat_desc, gate, max_dist=max_dist, ratio=ratio)


def search_frame_to_frame(
    prev_desc: jnp.ndarray,
    prev_uv_pred: jnp.ndarray,
    prev_octave: jnp.ndarray,
    prev_valid: jnp.ndarray,
    prev_angle: jnp.ndarray,
    feat_desc: jnp.ndarray,
    feat_xy: jnp.ndarray,
    feat_octave: jnp.ndarray,
    feat_valid: jnp.ndarray,
    feat_angle: jnp.ndarray,
    radius: jnp.ndarray,
    check_rotation: bool = True,
    max_dist=TH_HIGH,
) -> MatchResult:
    """Motion-model search: last frame's points projected into the current
    frame (reference SearchByProjection(Frame&, Frame&), src/ORBmatcher.cc:160-300:
    scale-gated radius, TH_HIGH, rotation histogram)."""
    gate = radius_gate(prev_uv_pred, feat_xy, radius, prev_valid, feat_valid)
    gate = gate & octave_gate(prev_octave, feat_octave)
    return match_gated(
        prev_desc,
        feat_desc,
        gate,
        max_dist=max_dist,
        ratio=0.9,
        angle_a=prev_angle,
        angle_b=feat_angle,
        check_rotation=check_rotation,
    )


def search_for_initialization(
    f1_desc: jnp.ndarray,
    f1_xy: jnp.ndarray,
    f1_octave: jnp.ndarray,
    f1_valid: jnp.ndarray,
    f1_angle: jnp.ndarray,
    f2_desc: jnp.ndarray,
    f2_xy: jnp.ndarray,
    f2_octave: jnp.ndarray,
    f2_valid: jnp.ndarray,
    f2_angle: jnp.ndarray,
    window: float = 100.0,
    max_level: int = 0,
) -> MatchResult:
    """Windowed search for monocular initialization
    (reference SearchForInitialization, src/ORBmatcher.cc:1055-1180:
    100px window, level 0 only, ratio 0.9, TH_LOW, rotation check).

    `max_level` > 0 extends the search to coarser octaves — useful when the
    scene's stable structure lives above level 0; coordinates are level-0
    pixels either way so the geometry is unchanged."""
    valid_a = f1_valid & (f1_octave <= max_level)
    valid_b = f2_valid & (f2_octave <= max_level)
    gate = radius_gate(f1_xy, f2_xy, jnp.full(f1_xy.shape[0], window), valid_a, valid_b)
    return match_gated(
        f1_desc,
        f2_desc,
        gate,
        max_dist=TH_LOW,
        ratio=0.9,
        angle_a=f1_angle,
        angle_b=f2_angle,
        check_rotation=True,
    )


def search_brute(
    desc_a: jnp.ndarray,
    valid_a: jnp.ndarray,
    angle_a: jnp.ndarray,
    desc_b: jnp.ndarray,
    valid_b: jnp.ndarray,
    angle_b: jnp.ndarray,
    max_dist: int = TH_LOW,
    ratio: float = 0.75,
    check_rotation: bool = True,
) -> MatchResult:
    """Unconstrained dense matcher — the dense substitute for SearchByBoW
    (reference src/ORBmatcher.cc:552-687). The BoW bucket gating there is a
    speed trick with a mild precision benefit; the full matrix plus the
    reference's ratio 0.75 + rotation filter subsumes it."""
    gate = valid_a[:, None] & valid_b[None, :]
    return match_gated(
        desc_a,
        desc_b,
        gate,
        max_dist=max_dist,
        ratio=ratio,
        angle_a=angle_a,
        angle_b=angle_b,
        check_rotation=check_rotation,
    )


def epipolar_distance2(
    xy1: jnp.ndarray, xy2: jnp.ndarray, F12: jnp.ndarray
) -> jnp.ndarray:
    """Squared point-to-epipolar-line distance of every pair.

    xy1 [A, 2] in image 1, xy2 [B, 2] in image 2, F12 fundamental matrix
    from image 1 to image 2. Returns [A, B] squared distances of x2 to the
    line F12^T? — convention: line in image 2 is l2 = F12^T x1? We follow
    the reference (CheckDistEpipolarLine, src/ORBmatcher.cc:1636-1660):
    l2 = (a,b,c) = x1^T F12, distance = (a u2 + b v2 + c)^2 / (a^2 + b^2).
    """
    ones = jnp.ones((*xy1.shape[:-1], 1), xy1.dtype)
    h1 = jnp.concatenate([xy1, ones], axis=-1)  # [A, 3]
    lines = h1 @ F12  # [A, 3]
    h2 = jnp.concatenate([xy2, jnp.ones((*xy2.shape[:-1], 1), xy2.dtype)], axis=-1)
    num = (lines @ h2.T) ** 2  # [A, B]
    den = lines[:, 0:1] ** 2 + lines[:, 1:2] ** 2
    return num / jnp.maximum(den, 1e-12)


def search_for_triangulation(
    f1_desc: jnp.ndarray,
    f1_xy: jnp.ndarray,
    f1_octave: jnp.ndarray,
    f1_valid: jnp.ndarray,
    f1_angle: jnp.ndarray,
    f2_desc: jnp.ndarray,
    f2_xy: jnp.ndarray,
    f2_octave: jnp.ndarray,
    f2_valid: jnp.ndarray,
    f2_angle: jnp.ndarray,
    F12: jnp.ndarray,
    epipole2: jnp.ndarray,
    level_sigma2: jnp.ndarray,
    stereo_mode: bool = False,
) -> MatchResult:
    """Match unbound features between two keyframes for triangulation
    (reference SearchForTriangulation, src/ORBmatcher.cc:1183-1362):
    epipolar-line gate at 3.84 * sigma^2(octave2), epipole-proximity veto
    for monocular, TH_LOW + rotation histogram."""
    ep2 = epipolar_distance2(f1_xy, f2_xy, F12)
    sigma2 = level_sigma2[jnp.clip(f2_octave, 0, level_sigma2.shape[0] - 1)]
    gate = ep2 < 3.84 * sigma2[None, :]
    if not stereo_mode:
        # reject features too close to the epipole in image 2
        d_ep = f2_xy - epipole2[None, :]
        scale = jnp.sqrt(sigma2)
        near_epipole = jnp.sum(d_ep * d_ep, axis=-1) < (100.0 * scale) ** 2
        gate = gate & ~near_epipole[None, :]
    gate = gate & f1_valid[:, None] & f2_valid[None, :]
    return match_gated(
        f1_desc,
        f2_desc,
        gate,
        max_dist=TH_LOW,
        ratio=1.0,
        angle_a=f1_angle,
        angle_b=f2_angle,
        check_rotation=True,
    )
