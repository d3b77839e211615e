"""Fused per-frame and per-keyframe XLA programs.

The functional building blocks in tracking.py/local_mapping.py are correct
but dispatch-heavy: a frame touched dozens of separate jitted calls plus
host synchronizations, and per-call latency then dominates wall-clock.
This module fuses the pipeline into three large programs:

* `track_step`   — motion-model AND reference-KF coarse tracking (both
  branches computed, branchlessly selected), two local-map re-association /
  pose-optimization passes, visibility counters. One call per frame; the
  host reads back a handful of scalars for the keyframe policy.
* `keyframe_step` — keyframe insertion, depth-seeded point creation,
  covisibility update, triangulation against the top covisible neighbors
  (lax.scan), bidirectional fusion, point-stat refresh.
* `local_ba_step` — local-BA assembly + two-phase LM + write-back.

The map pytree is donated in and out, so XLA updates buffers in place.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam2_tpu.geometry import camera as cam_geo
from orbslam2_tpu.geometry import se3
from orbslam2_tpu.ops import match
from orbslam2_tpu.pipeline import local_mapping as lm
from orbslam2_tpu.pipeline import tracking as trk
from orbslam2_tpu.pipeline.frame import FrameData
from orbslam2_tpu.slam_map import map_state as ms
from orbslam2_tpu.solvers import ba, pose_opt
from orbslam2_tpu.solvers.pallas_pose_opt import pose_optimize_fast


class TrackParams(NamedTuple):
    """Static-ish per-session parameters passed as device scalars."""

    scale_factors: jnp.ndarray
    inv_sigma2: jnp.ndarray
    bounds: jnp.ndarray          # [4] xmin, xmax, ymin, ymax
    radius_th: jnp.ndarray       # motion-model base radius (7 or 15)
    min_track: jnp.ndarray       # min inliers to accept a stage
    close_depth: jnp.ndarray     # ThDepth * baseline
    min_track_local: jnp.ndarray  # TrackLocalMap accept gate (reference
    #                               src/Tracking.cc:1035-1039, 30 inliers)
    match_max_dist: jnp.ndarray   # Hamming gate for projection searches.
    # The reference uses TH_HIGH=100 (src/ORBmatcher.cc:37) for its
    # bit_pattern_31_ BRIEF; our regenerated pattern yields tighter
    # true-match distances, and a 64 gate stops prediction-locked wrong
    # associations from dragging pose optimization (drift loop).


class TrackOut(NamedTuple):
    Tcw: jnp.ndarray
    point_idx: jnp.ndarray
    ok: jnp.ndarray              # bool: tracking healthy
    n_inliers: jnp.ndarray
    ref_tracked: jnp.ndarray
    close_tracked: jnp.ndarray
    close_free: jnp.ndarray


@partial(
    jax.jit,
    static_argnames=("max_local_kfs", "max_local_points", "num_levels"),
    donate_argnums=(0,),
)
def track_step(
    state: ms.MapState,
    frame: FrameData,
    last_xy,
    last_point_idx,
    last_octave,
    last_angle,
    last_desc,
    last_Tcw,
    velocity,
    has_velocity,
    ref_kf,
    K: cam_geo.Intrinsics,
    p: TrackParams,
    max_local_kfs: int = 80,
    max_local_points: int = 4096,
    num_levels: int = 8,
) -> tuple[ms.MapState, TrackOut]:
    """One fused tracking step (reference Track(), src/Tracking.cc:278-538,
    minus keyframe creation)."""

    # ---- coarse stage B: reference keyframe (always computed) -----------
    # PREFER the reference-KF anchor whenever it is healthy. The
    # motion-model associations are radius-censored around the velocity
    # prediction, so they can be wrong-but-self-consistent: once the
    # prediction drifts, the censored set holds the optimum near the
    # prediction and the error compounds ~2x per frame (measured on the
    # textured-room benchmark; ATE 10-17x worse than ref-anchored
    # tracking). The reference prefers the motion model because BoW search
    # is its expensive path on CPU (src/Tracking.cc:313-340); on the
    # device the dense gated brute match is cheap, so anchoring every frame to
    # the keyframe graph is the better operating point.
    bind_ref = trk.reference_kf_match.__wrapped__(
        state.kf_desc[ref_kf], state.kf_point_idx[ref_kf],
        state.kf_angle[ref_kf], state.kf_feat_valid[ref_kf],
        state.mp_valid, frame,
    )
    obs_ref = trk.build_pose_observations.__wrapped__(
        bind_ref, frame, state.mp_pos, state.mp_valid, p.inv_sigma2
    )
    # coarse stages only SEED the local-map passes below, which re-optimize
    # from scratch — a short robust schedule is enough (the full 4x10 costs
    # 40 sequential GN iterations of latency-bound [S]-sized kernels)
    res_ref = pose_optimize_fast(last_Tcw, obs_ref, K, rounds=2, iters=6)
    ok_ref = res_ref.num_inliers >= p.min_track
    use_ref = ok_ref & (res_ref.num_inliers >= 15)

    # ---- coarse stage A: motion model, ONLY when the ref anchor is weak --
    # (fast motion away from the keyframe). Its result is unused whenever
    # use_ref holds, so the whole fallback — two radius-gated matches and a
    # 2x6 schedule — lives in the untaken lax.cond branch on most frames.
    def mm_branch(_):
        Tcw_pred = velocity @ last_Tcw
        bind_r1, _ = trk.motion_model_match.__wrapped__(
            Tcw_pred, last_xy, last_point_idx, last_octave, last_angle,
            last_desc, state.mp_pos, state.mp_valid, frame, K,
            p.scale_factors, p.radius_th, p.match_max_dist,
        )
        bind_r2, _ = trk.motion_model_match.__wrapped__(
            Tcw_pred, last_xy, last_point_idx, last_octave, last_angle,
            last_desc, state.mp_pos, state.mp_valid, frame, K,
            p.scale_factors, 2.0 * p.radius_th, p.match_max_dist,
        )
        use_r1 = jnp.sum(bind_r1 >= 0) >= 20
        bind_mm = jnp.where(use_r1, bind_r1, bind_r2)
        obs_mm = trk.build_pose_observations.__wrapped__(
            bind_mm, frame, state.mp_pos, state.mp_valid, p.inv_sigma2
        )
        res_mm = pose_optimize_fast(Tcw_pred, obs_mm, K, rounds=2, iters=6)
        ok_mm = has_velocity & (res_mm.num_inliers >= p.min_track) & (
            jnp.sum(bind_mm >= 0) >= 20
        )
        return res_mm.Tcw, jnp.where(res_mm.inliers, bind_mm, -1), ok_mm

    def mm_skip(_):
        S_ = frame.xy.shape[0]
        return last_Tcw, jnp.full((S_,), -1, jnp.int32), jnp.asarray(False)

    mm_Tcw, mm_bind, ok_mm = jax.lax.cond(use_ref, mm_skip, mm_branch, None)
    use_mm = ok_mm & ~use_ref
    Tcw = jnp.where(use_mm, mm_Tcw, res_ref.Tcw)
    bind = jnp.where(use_mm, mm_bind,
                     jnp.where(res_ref.inliers, bind_ref, -1))
    coarse_ok = ok_mm | ok_ref

    # ---- local map: gather + two association/optimization passes --------
    lkf, lkf_mask, lpts, lpts_mask, _ = trk.gather_local_map.__wrapped__(
        state, bind, max_local_kfs=max_local_kfs, max_local_points=max_local_points
    )
    bounds = (p.bounds[0], p.bounds[1], p.bounds[2], p.bounds[3])

    def local_pass(Tcw, bind_seed, radius_mult, rounds=4, iters=10):
        b, vis = trk.search_local_points.__wrapped__(
            state, lpts, lpts_mask, Tcw, bind_seed, frame, K,
            p.scale_factors, bounds, radius_mult, num_levels=num_levels,
            max_dist=p.match_max_dist,
        )
        obs = trk.build_pose_observations.__wrapped__(
            b, frame, state.mp_pos, state.mp_valid, p.inv_sigma2
        )
        r = pose_optimize_fast(Tcw, obs, K, rounds=rounds, iters=iters)
        return r.Tcw, jnp.where(r.inliers, b, -1), r.num_inliers, vis

    # pass 1 refines the coarse seed (3x6); pass 2 runs the full reference
    # schedule (4x10 with per-round chi2 reclassification) on the final
    # association set — the only place the deep schedule pays for itself
    T1, b1, n1, vis1 = local_pass(Tcw, bind, jnp.float32(1.0), rounds=3, iters=6)
    acc1 = n1 >= p.min_track
    T1s = jnp.where(acc1, T1, Tcw)
    b1s = jnp.where(acc1, b1, bind)
    # second pass SEEDED with the first pass's inlier bindings: it only adds
    # matches for still-unbound features at the refined pose (the reference
    # runs a single TrackLocalMap search; a from-scratch re-association at a
    # smaller radius could return FEWER matches and was being accepted
    # whenever it cleared min_track, discarding a better first pass)
    T2, b2, n2, vis2 = local_pass(T1s, b1s, jnp.float32(0.6), rounds=4, iters=6)
    acc2 = (n2 >= n1) & (n2 >= p.min_track)
    Tcw_f = jnp.where(acc2, T2, T1s)
    bind_f = jnp.where(acc2, b2, b1s)
    n_inl = jnp.where(acc2, n2, jnp.where(acc1, n1, jnp.int32(0)))

    state = trk.update_seen_counters.__wrapped__(
        state, lpts, vis1 | vis2,
        jnp.clip(bind_f, 0, state.capacity_mp - 1), bind_f >= 0,
    )

    # ---- keyframe-policy scalars ---------------------------------------
    # reference TrackedMapPoints(minObs): only points observed by >= 3
    # keyframes count toward the reference-KF coverage (src/Tracking.cc:
    # 1056-1068; minObs = 3 once the map has > 2 KFs). Counting every bound
    # slot instead made `n_inliers < 0.75 * ref_tracked` true on every
    # frame and inserted a keyframe per frame (round-1 bench: 32 KFs for
    # 32 frames).
    rpid = state.kf_point_idx[ref_kf]
    rpid_c = jnp.clip(rpid, 0, state.capacity_mp - 1)
    min_obs = jnp.where(state.num_kf > 2, 3, 2)
    ref_tracked = jnp.sum(
        (rpid >= 0) & state.kf_feat_valid[ref_kf]
        & state.mp_valid[rpid_c] & (state.mp_n_obs[rpid_c] >= min_obs)
    )
    close = (frame.depth > 0) & (frame.depth < p.close_depth) & frame.valid
    close_tracked = jnp.sum(close & (bind_f >= 0))
    close_free = jnp.sum(close & (bind_f < 0))

    # health rides the FINAL evidence, not the seed: right after a loop
    # correction the coarse stage can fail (motion model dropped, anchors
    # freshly re-derived) while the local-map passes still converge with
    # hundreds of inliers from the re-anchored seed — the shipped round-4
    # pipeline declared such frames LOST (measured: deterministic LOST
    # with 323 local inliers one frame after every orbit closure). A
    # 3x-the-accept-gate local count cannot come from a diverged pose:
    # the association search is radius-gated around the seed and inliers
    # are chi2-classified per round.
    strong_local = n_inl >= 3 * p.min_track_local
    out = TrackOut(
        Tcw=Tcw_f,
        point_idx=bind_f,
        ok=(coarse_ok | strong_local) & (n_inl >= p.min_track),
        n_inliers=n_inl,
        ref_tracked=ref_tracked,
        close_tracked=close_tracked,
        close_free=close_free,
    )
    return state, out


# ---------------------------------------------------------------------------
# fused keyframe processing
# ---------------------------------------------------------------------------


@partial(
    jax.jit,
    static_argnames=("orb_cfg", "max_local_kfs", "max_local_points", "num_levels",
                     "has_distortion"),
    donate_argnums=(0,),
)
def track_frame_rgbd(
    state: ms.MapState,
    image,
    depth_map,
    frame_id,
    last_xy,
    last_point_idx,
    last_octave,
    last_angle,
    last_desc,
    last_Tcw,
    velocity,
    has_velocity,
    ref_kf,
    K: cam_geo.Intrinsics,
    p: TrackParams,
    inv_depth_factor,
    orb_cfg,
    max_local_kfs: int = 80,
    max_local_points: int = 4096,
    num_levels: int = 8,
    has_distortion: bool = False,
):
    """Frame construction (ORB extraction + RGB-D depth seeding +
    undistortion) AND the tracking step in ONE program, so per-call
    latency is paid once per frame. Returns (state, FrameData, TrackOut)."""
    from orbslam2_tpu.ops import orb as orb_mod
    from orbslam2_tpu.ops import stereo as stereo_mod
    from orbslam2_tpu.pipeline.frame import FrameData

    feats = orb_mod.extract.__wrapped__(image, orb_cfg)
    und = cam_geo.undistort_pixels(feats.xy, K) if has_distortion else feats.xy
    sm = stereo_mod.compute_stereo_from_rgbd(
        feats.xy, und, feats.valid, depth_map, inv_depth_factor, K.bf
    )
    frame = FrameData(
        frame_id=frame_id,
        timestamp=0.0,
        xy=und,
        xy_raw=feats.xy,
        ur=sm.u_right,
        depth=sm.depth,
        octave=feats.octave,
        angle=feats.angle,
        desc=feats.desc,
        valid=feats.valid,
    )
    state, out = track_step.__wrapped__(
        state, frame, last_xy, last_point_idx, last_octave, last_angle,
        last_desc, last_Tcw, velocity, has_velocity, ref_kf, K, p,
        max_local_kfs=max_local_kfs, max_local_points=max_local_points,
        num_levels=num_levels,
    )
    return state, frame, out


@partial(
    jax.jit,
    static_argnames=("n_neighbors", "n2_neighbors", "num_levels",
                     "create_close_points", "all_depths"),
    donate_argnums=(0,),
)
def keyframe_step(
    state: ms.MapState,
    frame: FrameData,
    Tcw,
    point_idx,
    K: cam_geo.Intrinsics,
    p: TrackParams,
    level_sigma2,
    scale_factor_last: float = 1.2**7,
    baseline: float = 0.1,
    covis_threshold: int = 15,
    n_neighbors: int = 5,
    n2_neighbors: int = 5,
    num_levels: int = 8,
    create_close_points: bool = True,
    all_depths: bool = False,
    recycle_min_age: int = 24,
) -> tuple[ms.MapState, jnp.ndarray, jnp.ndarray]:
    """Insert a keyframe and run the mapping stages (reference
    LocalMapping::Run body, src/LocalMapping.cc:48-97, sans BA).

    Returns (state, kf_id, new_point_ids [S], slot-aligned, -1 = none)."""
    S = frame.xy.shape[0]

    # 0) capacity-pressure recycling: this keyframe may allocate up to 2S
    # new points (depth seeds + triangulations); recycle the weakest mature
    # points if the pool is that close to saturation. Points the tracker
    # just bound are protected — add_keyframe is about to record their
    # observations, and binding a recycled slot would corrupt the tables.
    protect = jnp.zeros(state.capacity_mp, bool).at[
        jnp.where(point_idx >= 0, point_idx, state.capacity_mp)
    ].set(True, mode="drop")
    state = lm.ensure_free_slots(state, state.num_kf, headroom=2 * S,
                                 protect=protect, min_age=recycle_min_age)

    # 1) insert keyframe with current bindings
    state, kf_id = ms.add_keyframe.__wrapped__(
        state, jnp.int32(frame.frame_id), Tcw,
        frame.xy, frame.ur, frame.depth, frame.octave, frame.angle,
        frame.desc, frame.valid, point_idx,
    )

    # 2) depth-seeded points (stereo/RGB-D; reference src/Tracking.cc:1168-1216)
    if create_close_points:
        has_depth = frame.valid & (frame.depth > 0) & (point_idx < 0)
        if all_depths:
            create = has_depth
        else:
            depth_rank = jnp.sum(
                (frame.depth[None, :] < frame.depth[:, None]) & has_depth[None, :],
                axis=1,
            )
            create = has_depth & ((frame.depth < p.close_depth) | (depth_rank < 100))
        pc = cam_geo.backproject(frame.xy, frame.depth, K)
        pw = se3.apply(se3.inverse(Tcw), pc)
        Ow = se3.camera_center(Tcw)
        rays = pw - Ow
        dist = jnp.linalg.norm(rays, axis=-1)
        normal = rays / jnp.maximum(dist[:, None], 1e-9)
        scl = p.scale_factors[jnp.clip(frame.octave, 0, num_levels - 1)]
        max_d = dist * scl
        state, _ = ms.add_points.__wrapped__(
            state, pw, create, kf_id, jnp.arange(S, dtype=jnp.int32),
            frame.desc, normal, max_d / scale_factor_last, max_d, frame.ur,
        )

    # 3) triangulate against top covisible neighbors. All n_neighbors
    # epipolar matches run BATCHED against the same state (one
    # [n_neighbors, S, S] Hamming program; the previous
    # lax.scan serialized n_neighbors small matches and threaded the whole
    # MapState through every iteration). Slot arbitration — first valid
    # neighbor in covisibility order wins — reproduces the scan's
    # first-binder-wins semantics exactly, because triangulate_pair only
    # reads keyframe arrays that the scan iterations never modified.
    w = state.covis[kf_id] * state.kf_valid
    _, neigh = jax.lax.top_k(w, n_neighbors)
    neigh_ok = w[neigh] >= covis_threshold

    f2_all, pw_all, ok_all, dist1_all = jax.vmap(
        lambda nkf: lm.triangulate_pair.__wrapped__(
            state, kf_id, nkf, K, p.scale_factors, level_sigma2,
            jnp.float32(baseline), num_levels=num_levels,
        )
    )(neigh)
    ok_all = ok_all & neigh_ok[:, None] & (state.kf_point_idx[kf_id] < 0)[None, :]
    nsel = jnp.argmax(ok_all, axis=0)              # [S] winning neighbor row
    any_ok = jnp.any(ok_all, axis=0)
    cols = jnp.arange(S)
    pw = pw_all[nsel, cols]
    dist1 = dist1_all[nsel, cols]
    octv = state.kf_octave[kf_id]
    scl = p.scale_factors[jnp.clip(octv, 0, num_levels - 1)]
    max_d = dist1 * scl
    c1 = se3.camera_center(state.kf_Tcw[kf_id])
    rays = pw - c1
    normal = rays / jnp.maximum(jnp.linalg.norm(rays, axis=-1, keepdims=True), 1e-9)
    state, new_pids = ms.add_points.__wrapped__(
        state, pw, any_ok, kf_id, jnp.arange(S, dtype=jnp.int32),
        state.kf_desc[kf_id], normal, max_d / scale_factor_last, max_d,
        state.kf_ur[kf_id],
    )

    def bind_second_view(st: ms.MapState, args):
        i_n, nkf = args
        m = (nsel == i_n) & (new_pids >= 0)
        st = lm.bind_points_to_kf.__wrapped__(st, nkf, f2_all[i_n], new_pids, m)
        return st, None

    state, _ = jax.lax.scan(
        bind_second_view, state,
        (jnp.arange(n_neighbors, dtype=jnp.int32), neigh),
    )

    # 4) fuse with neighbors, both directions — the reference's
    # SearchInNeighbors (src/LocalMapping.cc:487-575): targets are the
    # first-level covisible neighbors PLUS n2_neighbors second-level
    # neighbors of each (reference :497-515 extends with 5 each). Fuse a
    # SNAPSHOT of this keyframe's matches into each target, then fuse the
    # DEDUPED union of all targets' points back into this keyframe once.
    # The expensive dense matches batch over targets (vmap) against the
    # snapshot; the cheap scatter updates apply sequentially so conflict
    # arbitration reads current observation counts.
    bounds = (p.bounds[0], p.bounds[1], p.bounds[2], p.bounds[3])
    mine = state.kf_point_idx[kf_id]
    Kcap = state.capacity_kf
    w2 = state.covis[neigh] * state.kf_valid          # [n1, K]
    w2 = jnp.where(neigh_ok[:, None], w2, 0)
    w2 = w2.at[:, kf_id].set(0)                       # not back to self
    _, neigh2 = jax.lax.top_k(w2, n2_neighbors)       # [n1, n2]
    ok2 = jnp.take_along_axis(w2, neigh2, axis=1) > 0
    targets = jnp.concatenate([neigh, neigh2.reshape(-1)])
    targets_ok = jnp.concatenate([neigh_ok, ok2.reshape(-1)])
    # dedupe targets (second-level sets overlap first-level and each other)
    Tn = targets.shape[0]
    tpos = jnp.full(Kcap, Tn, jnp.int32).at[
        jnp.where(targets_ok, targets, Kcap)
    ].min(jnp.arange(Tn, dtype=jnp.int32), mode="drop")
    targets_ok = targets_ok & (tpos[targets] == jnp.arange(Tn))

    feat_a = jax.vmap(
        lambda nkf: lm.fuse_match(
            state, mine, mine >= 0, nkf, K, p.scale_factors, bounds,
            num_levels=num_levels,
        )
    )(targets)                                        # [Tn, S]

    def apply_one(st: ms.MapState, args):
        nkf, ok_n, feat = args
        st = lm.fuse_apply(st, jnp.where(ok_n, mine, -1), feat, nkf)
        return st, None

    state, _ = jax.lax.scan(apply_one, state, (targets, targets_ok, feat_a))

    # union of ALL targets' points, first occurrence only (the
    # reference's vpFuseCandidates dedupe via mbFuseCandidate flags)
    theirs = jnp.where(
        targets_ok[:, None], state.kf_point_idx[targets], -1
    ).reshape(-1)
    P = state.capacity_mp
    tclip = jnp.clip(theirs, 0, P - 1)
    M = theirs.shape[0]
    occ = jnp.full(P, M, jnp.int32).at[
        jnp.where(theirs >= 0, tclip, P)
    ].min(jnp.arange(M, dtype=jnp.int32), mode="drop")
    first_occ = (theirs >= 0) & (occ[tclip] == jnp.arange(M, dtype=jnp.int32))
    theirs = jnp.where(first_occ, theirs, -1)
    state = lm.fuse_points_into_kf.__wrapped__(
        state, theirs, theirs >= 0, kf_id, K, p.scale_factors, bounds,
        num_levels=num_levels,
    )

    # 5) refresh stats of this KF's bound points + the new ones
    state = ms.recompute_point_stats.__wrapped__(
        state, state.kf_point_idx[kf_id], p.scale_factors
    )
    state = ms.recompute_point_stats.__wrapped__(state, new_pids, p.scale_factors)
    return state, kf_id, new_pids


@partial(
    jax.jit,
    static_argnames=("n_neighbors", "n2_neighbors", "num_levels",
                     "create_close_points", "all_depths",
                     "max_local", "max_fixed", "max_points", "obs_slots",
                     "iters1", "iters2", "run_ba"),
    donate_argnums=(0,),
)
def keyframe_full_step(
    state: ms.MapState,
    frame,
    Tcw,
    point_idx,
    probation_window,        # [W] int32 point ids (-1 pad) for culling
    K: cam_geo.Intrinsics,
    p: TrackParams,
    level_sigma2,
    inv_sigma2,
    scale_factor_last: float = 1.2**7,
    baseline: float = 0.1,
    covis_threshold: int = 15,
    n_neighbors: int = 5,
    n2_neighbors: int = 5,
    num_levels: int = 8,
    create_close_points: bool = True,
    all_depths: bool = False,
    max_local: int = 32,
    max_fixed: int = 64,
    max_points: int = 8192,
    obs_slots: int = 16,
    iters1: int = 5,
    iters2: int = 10,
    run_ba: bool = True,
    recycle_min_age: int = 24,
):
    """keyframe insertion + mapping + probation culling + local BA as ONE
    program (one dispatch per keyframe).

    Returns (state, kf_id, new_point_ids, window_keep_mask)."""
    state, kf_id, new_pids = keyframe_step.__wrapped__(
        state, frame, Tcw, point_idx, K, p, level_sigma2,
        scale_factor_last=scale_factor_last, baseline=baseline,
        covis_threshold=covis_threshold, n_neighbors=n_neighbors,
        n2_neighbors=n2_neighbors,
        num_levels=num_levels, create_close_points=create_close_points,
        all_depths=all_depths, recycle_min_age=recycle_min_age,
    )
    # "now" for probation ages = this keyframe's seq (slot ids are recycled)
    now_seq = state.kf_seq[jnp.clip(kf_id, 0, state.capacity_kf - 1)]
    state, keep = lm.cull_points.__wrapped__(state, probation_window, now_seq)
    if run_ba:
        state = local_ba_step.__wrapped__(
            state, kf_id, inv_sigma2, K,
            max_local=max_local, max_fixed=max_fixed,
            max_points=max_points, obs_slots=obs_slots,
            iters1=iters1, iters2=iters2,
        )
        state = _reanchor_depth_seeds.__wrapped__(state, kf_id, K)
    # keyframe-culling sweep (reference KeyFrameCulling,
    # src/LocalMapping.cc:684-752 sweeps ALL covisible keyframes every
    # iteration — round 3 only checked the top 10 by weight, so redundant
    # keyframes survived at 1000+ KF scale and inflated every [K,K]
    # structure): redundancy of EVERY covisible neighbor is computed HERE
    # so the host reads it in the same pull as the other keyframe outputs.
    Kc = state.capacity_kf
    wc = state.covis[kf_id] * state.kf_valid
    wc = wc.at[0].set(0)                      # never cull the origin
    cull_ids = jnp.arange(Kc, dtype=jnp.int32)
    cull_ok = (wc >= covis_threshold) & (cull_ids != kf_id)
    cull_red = jax.vmap(lambda c: lm.keyframe_redundancy.__wrapped__(state, c))(
        cull_ids
    )
    cull_red = jnp.where(cull_ok, cull_red, 0.0)
    cull_ids = jnp.where(cull_ok, cull_ids, -1)

    # return the (possibly BA-adjusted) anchors so the host needs no extra
    # gather dispatches to refresh the tracker
    return (state, kf_id, new_pids, keep, state.kf_Tcw[kf_id],
            state.kf_point_idx[kf_id], cull_ids, cull_red)


@partial(
    jax.jit,
    static_argnames=("orb_cfg", "max_local_kfs", "max_local_points", "num_levels",
                     "has_distortion"),
    donate_argnums=(0,),
)
def track_frame_stereo(
    state: ms.MapState,
    left,
    right,
    frame_id,
    last_xy,
    last_point_idx,
    last_octave,
    last_angle,
    last_desc,
    last_Tcw,
    velocity,
    has_velocity,
    ref_kf,
    K: cam_geo.Intrinsics,
    p: TrackParams,
    orb_cfg,
    max_local_kfs: int = 80,
    max_local_points: int = 4096,
    num_levels: int = 8,
    has_distortion: bool = False,
):
    """Stereo sibling of track_frame_rgbd: L/R extraction, stereo
    correspondence (reference's two transient threads, src/Frame.cc:82-85,
    become one batched graph) and tracking in one program."""
    from orbslam2_tpu.ops import orb as orb_mod
    from orbslam2_tpu.ops import pyramid as pyr_mod
    from orbslam2_tpu.ops import stereo as stereo_mod
    from orbslam2_tpu.pipeline.frame import FrameData

    fl = orb_mod.extract.__wrapped__(left, orb_cfg)
    fr = orb_mod.extract.__wrapped__(right, orb_cfg)
    lv_l = pyr_mod.build_pyramid(left, orb_cfg)
    lv_r = pyr_mod.build_pyramid(right, orb_cfg)
    sf = jnp.asarray(pyr_mod.level_scales(orb_cfg), jnp.float32)
    sm = stereo_mod.compute_stereo_matches(
        fl.xy, fl.octave, fl.desc, fl.valid,
        fr.xy, fr.octave, fr.desc, fr.valid,
        lv_l, lv_r, sf, K.bf, K.fx,
    )
    und = cam_geo.undistort_pixels(fl.xy, K) if has_distortion else fl.xy
    frame = FrameData(
        frame_id=frame_id, timestamp=0.0,
        xy=und, xy_raw=fl.xy, ur=sm.u_right, depth=sm.depth,
        octave=fl.octave, angle=fl.angle, desc=fl.desc, valid=fl.valid,
    )
    state, out = track_step.__wrapped__(
        state, frame, last_xy, last_point_idx, last_octave, last_angle,
        last_desc, last_Tcw, velocity, has_velocity, ref_kf, K, p,
        max_local_kfs=max_local_kfs, max_local_points=max_local_points,
        num_levels=num_levels,
    )
    return state, frame, out


class FrameStepOut(NamedTuple):
    """Host-visible results of the all-in-one frame program.

    The `next_*` fields are the DEVICE-side selections of the tracker
    anchors for the following frame (what the host branches in
    System._track_turbo would compute after pulling is_kf/accept). They
    let a pipelined caller dispatch frame N+1 using frame N's outputs
    WITHOUT a host round trip in between: the deferred host pull
    overlaps with the next frame's compute."""

    track: TrackOut
    is_kf: jnp.ndarray          # bool
    kf_id: jnp.ndarray          # int32 (-1 if no keyframe)
    kf_Tcw: jnp.ndarray         # [4,4] post-BA keyframe pose (or track pose)
    kf_point_idx: jnp.ndarray   # [S] post-BA bindings (or track bindings)
    new_pids: jnp.ndarray       # [S] (-1 when no keyframe)
    window_keep: jnp.ndarray    # [W] bool
    cull_ids: jnp.ndarray       # [K] covisible culling candidates (-1 = n/a)
    cull_red: jnp.ndarray       # [K] their redundancy fractions
    accept: jnp.ndarray         # bool: ok AND >= min_inliers_local
    next_Tcw: jnp.ndarray       # [4,4] anchor pose for the next frame
    next_point_idx: jnp.ndarray # [S] anchor bindings for the next frame
    next_velocity: jnp.ndarray  # [4,4] motion model for the next frame
    next_ref_kf: jnp.ndarray    # int32
    next_frames_since_kf: jnp.ndarray  # int32


@partial(
    jax.jit,
    static_argnames=(
        "orb_cfg", "max_local_kfs", "max_local_points", "num_levels",
        "has_distortion", "n_neighbors", "n2_neighbors", "create_close_points",
        "max_local", "max_fixed", "max_points", "obs_slots", "iters1", "iters2",
        "max_gap", "min_gap", "kf_ratio", "use_close_cond", "sensor",
        "defer_ba",
    ),
    donate_argnums=(0,),
)
def frame_and_keyframe_step(
    state: ms.MapState,
    image,
    depth_map,
    frame_id,
    last_xy,
    last_point_idx,
    last_octave,
    last_angle,
    last_desc,
    last_Tcw,
    velocity,
    has_velocity,
    ref_kf,
    frames_since_kf,
    n_keyframes,
    mapping_enabled,
    probation_window,
    K: cam_geo.Intrinsics,
    p: TrackParams,
    inv_depth_factor,
    level_sigma2,
    inv_sigma2,
    orb_cfg,
    scale_factor_last: float = 1.2**7,
    baseline: float = 0.1,
    covis_threshold: int = 15,
    max_local_kfs: int = 80,
    max_local_points: int = 4096,
    num_levels: int = 8,
    has_distortion: bool = False,
    n_neighbors: int = 5,
    n2_neighbors: int = 5,
    create_close_points: bool = True,
    max_local: int = 32,
    max_fixed: int = 64,
    max_points: int = 8192,
    obs_slots: int = 16,
    iters1: int = 5,
    iters2: int = 10,
    max_gap: int = 15,
    min_gap: int = 0,
    kf_ratio: float = 0.75,
    use_close_cond: bool = True,
    sensor: str = "rgbd",
    defer_ba: bool = False,
    recycle_min_age: int = 24,
):
    """The ENTIRE per-frame pipeline — frame build, tracking, on-device
    keyframe policy, and (conditionally, via lax.cond) keyframe insertion +
    mapping + probation culling + local BA — as ONE dispatch.

    `sensor` selects frame construction: "rgbd" (image + depth map),
    "stereo" (image = left, depth_map = right; the reference's two
    transient extraction threads become one batched graph), or "mono"
    (depth_map ignored). Tracking/keyframe logic is shared.

    This program brings the steady state to one call plus one small
    device_get per frame. Returns (state, frame, FrameStepOut).
    """
    if sensor == "rgbd":
        state, frame, out = track_frame_rgbd.__wrapped__(
            state, image, depth_map, frame_id,
            last_xy, last_point_idx, last_octave, last_angle, last_desc,
            last_Tcw, velocity, has_velocity, ref_kf, K, p, inv_depth_factor,
            orb_cfg,
            max_local_kfs=max_local_kfs, max_local_points=max_local_points,
            num_levels=num_levels, has_distortion=has_distortion,
        )
    elif sensor == "stereo":
        state, frame, out = track_frame_stereo.__wrapped__(
            state, image, depth_map, frame_id,
            last_xy, last_point_idx, last_octave, last_angle, last_desc,
            last_Tcw, velocity, has_velocity, ref_kf, K, p, orb_cfg,
            max_local_kfs=max_local_kfs, max_local_points=max_local_points,
            num_levels=num_levels, has_distortion=has_distortion,
        )
    else:  # mono
        from orbslam2_tpu.ops import orb as orb_mod

        feats = orb_mod.extract.__wrapped__(image, orb_cfg)
        und = (
            cam_geo.undistort_pixels(feats.xy, K) if has_distortion else feats.xy
        )
        S_ = feats.xy.shape[0]
        frame = FrameData(
            frame_id=frame_id, timestamp=0.0,
            xy=und, xy_raw=feats.xy,
            ur=jnp.full((S_,), -1.0, jnp.float32),
            depth=jnp.full((S_,), -1.0, jnp.float32),
            octave=feats.octave, angle=feats.angle,
            desc=feats.desc, valid=feats.valid,
        )
        state, out = track_step.__wrapped__(
            state, frame, last_xy, last_point_idx, last_octave, last_angle,
            last_desc, last_Tcw, velocity, has_velocity, ref_kf, K, p,
            max_local_kfs=max_local_kfs, max_local_points=max_local_points,
            num_levels=num_levels,
        )

    # ---- keyframe policy on device (reference src/Tracking.cc:1049-1139) --
    ratio = jnp.where(n_keyframes <= 2, 0.4, kf_ratio)
    need_ratio = out.n_inliers < ratio * jnp.maximum(out.ref_tracked, 1)
    close_cond = (
        (out.close_tracked < 100) & (out.close_free > 70)
        if use_close_cond
        else jnp.asarray(False)
    )
    c1 = frames_since_kf >= max_gap
    c2 = (need_ratio | close_cond) & (frames_since_kf >= min_gap)
    run_ba = n_keyframes >= 2
    # the device policy must not out-accept the host: the host declares the
    # frame LOST below min_inliers_local (system.py), so inserting a
    # keyframe there would orphan it (never registered with the mapper /
    # loop DB). Gate on the same threshold.
    need_kf = (
        out.ok & (c1 | c2) & (out.n_inliers > 15)
        & (out.n_inliers >= p.min_track_local)
        & jnp.any(~state.kf_valid) & mapping_enabled
    )

    W = probation_window.shape[0]
    S = frame.xy.shape[0]

    def kf_branch(st):
        # BA only from the third keyframe on; rerun the no-BA variant would
        # double-compile, so mask: when run_ba is false the caller has
        # n_keyframes < 2, where BA on <3 cameras is harmless (gauge-fixed).
        # With defer_ba the host dispatches `deferred_local_ba` as its own
        # program at resolve time instead (LocalMapping-thread semantics).
        return keyframe_full_step.__wrapped__(
            st, frame, out.Tcw, out.point_idx, probation_window, K, p,
            level_sigma2, inv_sigma2,
            scale_factor_last=scale_factor_last, baseline=baseline,
            covis_threshold=covis_threshold, n_neighbors=n_neighbors,
            n2_neighbors=n2_neighbors,
            num_levels=num_levels, create_close_points=create_close_points,
            max_local=max_local, max_fixed=max_fixed, max_points=max_points,
            obs_slots=obs_slots, iters1=iters1, iters2=iters2,
            run_ba=not defer_ba, recycle_min_age=recycle_min_age,
        )

    def no_kf(st):
        Kc = st.capacity_kf
        return (
            st,
            jnp.int32(-1),
            jnp.full((S,), -1, jnp.int32),
            jnp.zeros((W,), bool),
            out.Tcw,
            out.point_idx,
            jnp.full((Kc,), -1, jnp.int32),
            jnp.zeros((Kc,), jnp.float32),
        )

    state, kf_id, new_pids, keep, kf_Tcw, kf_bind, cull_ids, cull_red = jax.lax.cond(
        need_kf, kf_branch, no_kf, state
    )
    # device-side anchor selection for a pipelined caller (mirrors the host
    # branches in System._track_turbo: keyframe -> post-BA pose/bindings,
    # otherwise the tracked ones; accept mirrors the host LOST gate)
    accept = out.ok & (out.n_inliers >= p.min_track_local)
    res = FrameStepOut(
        track=out, is_kf=need_kf, kf_id=kf_id, kf_Tcw=kf_Tcw,
        kf_point_idx=kf_bind, new_pids=new_pids, window_keep=keep,
        cull_ids=cull_ids, cull_red=cull_red,
        accept=accept,
        next_Tcw=jnp.where(need_kf, kf_Tcw, out.Tcw),
        next_point_idx=jnp.where(need_kf, kf_bind, out.point_idx),
        next_velocity=out.Tcw @ se3.inverse(last_Tcw),
        next_ref_kf=jnp.where(need_kf, kf_id, ref_kf).astype(jnp.int32),
        next_frames_since_kf=jnp.where(
            need_kf, 0, frames_since_kf + 1
        ).astype(jnp.int32),
    )
    return state, frame, res


@partial(jax.jit, donate_argnums=(0,))
def _reanchor_depth_seeds(state: ms.MapState, kf_id, K: cam_geo.Intrinsics):
    """Re-anchor kf_id's single-observer depth-seeded points to its CURRENT
    (post-BA) pose. They were backprojected at the tracked (pre-BA) pose;
    BA moves the keyframe but cannot constrain 1-observation points,
    leaving a dense fresh cloud offset by the BA correction — the next
    frames then track against the stale cloud and the pose error is
    amplified at every keyframe insertion. Reads the frame data from the
    map (kf_xy/kf_depth were stored at insertion)."""
    pid = state.kf_point_idx[kf_id]
    pidc = jnp.clip(pid, 0, state.capacity_mp - 1)
    depth = state.kf_depth[kf_id]
    single = (
        (pid >= 0)
        & (jnp.sum(state.mp_obs_kf[pidc] >= 0, axis=1) == 1)
        & (state.mp_first_kf[pidc] == state.kf_seq[kf_id])
        & (depth > 0)
    )
    pc = cam_geo.backproject(state.kf_xy[kf_id], depth, K)
    pw = se3.apply(se3.inverse(state.kf_Tcw[kf_id]), pc)
    pid_w = jnp.where(single, pid, state.capacity_mp)
    return state._replace(
        mp_pos=state.mp_pos.at[pid_w].set(pw, mode="drop")
    )


@partial(
    jax.jit,
    static_argnames=("max_local", "max_fixed", "max_points", "obs_slots",
                     "iters1", "iters2"),
    donate_argnums=(0,),
)
def deferred_local_ba(
    state: ms.MapState,
    kf_id,
    inv_sigma2,
    K: cam_geo.Intrinsics,
    max_local: int = 32,
    max_fixed: int = 64,
    max_points: int = 8192,
    obs_slots: int = 16,
    iters1: int = 5,
    iters2: int = 10,
) -> ms.MapState:
    """Local BA as its OWN dispatch, issued by the host at keyframe-resolve
    time instead of inside the fused keyframe program (the reference's
    LocalMapping thread runs BA asynchronously the same way,
    src/LocalMapping.cc:92-97). Fire-and-forget: the result map chains into
    the next frame's dispatch on device; the host never waits on it — the
    keyframe frame's host pull stops waiting for the BA tail."""
    state = local_ba_step.__wrapped__(
        state, kf_id, inv_sigma2, K,
        max_local=max_local, max_fixed=max_fixed,
        max_points=max_points, obs_slots=obs_slots,
        iters1=iters1, iters2=iters2,
    )
    return _reanchor_depth_seeds.__wrapped__(state, kf_id, K)


@partial(
    jax.jit,
    static_argnames=("max_local", "max_fixed", "max_points", "obs_slots",
                     "iters1", "iters2"),
    donate_argnums=(0,),
)
def local_ba_step(
    state: ms.MapState,
    kf_id,
    inv_sigma2,
    K: cam_geo.Intrinsics,
    max_local: int = 32,
    max_fixed: int = 64,
    max_points: int = 8192,
    obs_slots: int = 16,
    iters1: int = 5,
    iters2: int = 10,
) -> ms.MapState:
    """Assembly + two-phase LM + write-back as one program."""
    prob, cam_ids, cam_present, pts, pt_ok = lm.build_local_ba_problem.__wrapped__(
        state, kf_id, inv_sigma2,
        max_local=max_local, max_fixed=max_fixed,
        max_points=max_points, obs_slots=obs_slots,
    )
    res1 = ba.bundle_adjust.__wrapped__(prob, K, iters=iters1, use_kernel=True)
    prob2 = prob._replace(
        cam_Tcw=res1.cam_Tcw, points=res1.points,
        obs_valid=prob.obs_valid & res1.obs_inlier,
    )
    res2 = ba.bundle_adjust.__wrapped__(prob2, K, iters=iters2, use_kernel=False)
    return lm.writeback_local_ba.__wrapped__(
        state, res2, prob, cam_ids, cam_present, pts, pt_ok
    )
