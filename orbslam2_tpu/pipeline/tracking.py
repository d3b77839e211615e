"""Tracking: the per-frame front-end state machine.

Redesign of the reference `Tracking` class (reference src/Tracking.cc):
the same state machine (NOT_INITIALIZED -> OK <-> LOST) and the same
per-frame flow — motion-model search, reference-KF fallback, local-map
refinement, keyframe policy — but every hot stage is a jitted fixed-shape
kernel over the device-resident map, and the host loop only sequences them.

Stage map (reference file:line):
* stereo/RGB-D init            src/Tracking.cc:541-599
* TrackWithMotionModel         src/Tracking.cc:924-992
* TrackReferenceKeyFrame       src/Tracking.cc:808-851
* TrackLocalMap + SearchLocalPoints   src/Tracking.cc:995-1046, 1225-1278
* UpdateLocalKeyFrames/Points  src/Tracking.cc:1281-1436
* NeedNewKeyFrame/CreateNewKeyFrame   src/Tracking.cc:1049-1221
"""

from __future__ import annotations

import enum
from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from orbslam2_tpu.config import SlamConfig, Sensor
from orbslam2_tpu.geometry import camera as cam_geo
from orbslam2_tpu.geometry import se3
from orbslam2_tpu.ops import match
from orbslam2_tpu.pipeline.frame import FrameBuilder, FrameData
from orbslam2_tpu.slam_map import map_state as ms
from orbslam2_tpu.solvers import initializer as mono_init
from orbslam2_tpu.solvers import pose_opt

LOG_SCALE = float(np.log(1.2))


class TrackState(enum.Enum):
    NOT_INITIALIZED = 0
    OK = 1
    LOST = 2


class TrackResult(NamedTuple):
    Tcw: np.ndarray
    state: TrackState
    num_inliers: int
    is_keyframe: bool


# ---------------------------------------------------------------------------
# jitted building blocks
# ---------------------------------------------------------------------------


@jax.jit
def motion_model_match(
    Tcw_pred,
    last_xy,
    last_point_idx,
    last_octave,
    last_angle,
    last_desc,
    mp_pos,
    mp_valid,
    frame: FrameData,
    K: cam_geo.Intrinsics,
    scale_factors,
    radius_th,
    max_dist=match.TH_HIGH,
):
    """Project last frame's bound points into the predicted pose and match
    (reference SearchByProjection Frame-to-Frame, src/ORBmatcher.cc:160-300).

    Returns (point_idx [S] int32 bindings for the current frame, pred_uv).
    """
    S = last_xy.shape[0]
    pid = jnp.clip(last_point_idx, 0, mp_pos.shape[0] - 1)
    has_point = (last_point_idx >= 0) & mp_valid[pid]
    pw = mp_pos[pid]
    pc = se3.apply(Tcw_pred, pw)
    uv = cam_geo.project(pc, K)
    vis = has_point & (pc[:, 2] > 0.1)
    radius = radius_th * scale_factors[jnp.clip(last_octave, 0, scale_factors.shape[0] - 1)]
    res = match.search_frame_to_frame(
        last_desc, uv, last_octave, vis, last_angle,
        frame.desc, frame.xy, frame.octave, frame.valid, frame.angle,
        radius, max_dist=max_dist,
    )
    # per current-feature binding: assigned[s] = index into last frame slots
    assigned = res.assigned  # [S] -> last-frame slot or -1
    cur_point = jnp.where(
        assigned >= 0, last_point_idx[jnp.clip(assigned, 0, S - 1)], -1
    )
    return cur_point, uv


@jax.jit
def reference_kf_match(
    kf_desc, kf_point_idx, kf_angle, kf_feat_valid,
    mp_valid,
    frame: FrameData,
):
    """Match frame descriptors against a keyframe's bound features
    (reference SearchByBoW KF-Frame, src/ORBmatcher.cc:552-687 — here a
    dense gated matcher, ratio 0.7)."""
    pid = jnp.clip(kf_point_idx, 0, mp_valid.shape[0] - 1)
    valid_a = kf_feat_valid & (kf_point_idx >= 0) & mp_valid[pid]
    res = match.search_brute(
        kf_desc, valid_a, kf_angle,
        frame.desc, frame.valid, frame.angle,
        max_dist=match.TH_LOW, ratio=0.7, check_rotation=True,
    )
    assigned = res.assigned  # current feature -> kf slot
    cur_point = jnp.where(
        assigned >= 0, kf_point_idx[jnp.clip(assigned, 0, kf_desc.shape[0] - 1)], -1
    )
    return cur_point


@partial(jax.jit, static_argnames=("max_local_kfs", "max_local_points"))
def gather_local_map(
    state: ms.MapState,
    cur_point_idx,
    max_local_kfs: int = 80,
    max_local_points: int = 4096,
):
    """Local keyframes = observers of current points + top covisibles;
    local points = points bound in those KFs
    (reference UpdateLocalKeyFrames/UpdateLocalPoints, src/Tracking.cc:1281-1436).

    Returns (local_kf_ids [L], local_kf_mask [L] bool,
             local_point_ids [M], local_point_mask [M] bool, ref_kf).
    """
    P = state.capacity_mp
    K = state.capacity_kf
    max_local_kfs = min(max_local_kfs, K)
    pid = jnp.clip(cur_point_idx, 0, P - 1)
    bound = (cur_point_idx >= 0) & state.mp_valid[pid]
    # votes per KF: each bound point votes for its observers
    obs_kf = state.mp_obs_kf[pid]  # [S, O]
    obs_ok = bound[:, None] & (obs_kf >= 0)
    votes = jnp.zeros(K + 1, jnp.int32).at[jnp.where(obs_ok, obs_kf, K)].add(1)[:K]
    votes = jnp.where(state.kf_valid, votes, 0)
    ref_kf = jnp.argmax(votes).astype(jnp.int32)
    # K1 = voting KFs; K2 = best covisibles of K1 — approximate by adding
    # covisibility weights of voting KFs
    covis_boost = (state.covis * (votes > 0)[:, None].astype(jnp.int32)).max(0)
    score = votes * 1000 + jnp.where(votes > 0, 0, covis_boost)
    score = jnp.where(state.kf_valid, score, -1)
    _, local_kfs = jax.lax.top_k(score, max_local_kfs)
    local_kf_mask = score[local_kfs] > 0
    # local points: any point bound in a local KF. When they overflow
    # max_local_points, keep the points of the MOST RELEVANT keyframes
    # first (top_k order = voting score), newest slot on ties — a plain
    # first-K-set-flags cut kept the OLDEST slots and silently dropped
    # every newly created point once the local window outgrew the cap,
    # starving tracking of exactly the points covering new scenery
    # (full-res orbit: inliers sawtoothed down and tracking died).
    L = local_kfs.shape[0]
    ids = state.kf_point_idx[local_kfs]  # [L, S]
    ids_w = jnp.where(local_kf_mask[:, None] & (ids >= 0), ids, P)
    # rank of the best (lowest-index = highest-score) local KF binding
    # each point; L = unbound
    rank_l = jnp.broadcast_to(
        jnp.arange(L, dtype=jnp.int32)[:, None], ids_w.shape
    )
    pri = jnp.full(P + 1, L, jnp.int32).at[ids_w.reshape(-1)].min(
        rank_l.reshape(-1)
    )[:P]
    flagged = (pri < L) & state.mp_valid
    # score: relevance first, then newest slot id as tie-break
    score_pt = jnp.where(
        flagged,
        (L - pri).astype(jnp.int32) * (P + 1) + jnp.arange(P, dtype=jnp.int32),
        -1,
    )
    top_score, local_points = jax.lax.top_k(score_pt, max_local_points)
    local_point_mask = top_score >= 0
    local_points = jnp.clip(local_points, 0, P - 1)
    return local_kfs, local_kf_mask, local_points, local_point_mask, ref_kf


@partial(jax.jit, static_argnames=("num_levels",))
def search_local_points(
    state: ms.MapState,
    local_points,
    local_point_mask,
    Tcw,
    cur_point_idx,
    frame: FrameData,
    K: cam_geo.Intrinsics,
    scale_factors,
    image_bounds,         # (xmin, xmax, ymin, ymax)
    radius_mult,
    num_levels: int = 8,
    max_dist=match.TH_HIGH,
):
    """Frustum-check local points, predict scale, and project-match into the
    frame's unbound features (reference Frame::isInFrustum src/Frame.cc:288-345
    + SearchLocalPoints src/Tracking.cc:1225-1278 + projection matcher radius
    policy src/ORBmatcher.cc:83-96).

    Returns (new point_idx bindings [S], n_visible [M] visibility mask).
    """
    pw = state.mp_pos[local_points]
    pc = se3.apply(Tcw, pw)
    uv = cam_geo.project(pc, K)
    z_ok = pc[:, 2] > 0.1
    xmin, xmax, ymin, ymax = image_bounds
    in_img = (
        (uv[:, 0] >= xmin) & (uv[:, 0] < xmax) & (uv[:, 1] >= ymin) & (uv[:, 1] < ymax)
    )
    Ow = se3.camera_center(Tcw)
    rays = pw - Ow
    dist = jnp.linalg.norm(rays, axis=-1)
    mind = state.mp_min_dist[local_points] * 0.8
    maxd = state.mp_max_dist[local_points] * 1.2
    dist_ok = (dist >= mind) & (dist <= maxd)
    normal = state.mp_normal[local_points]
    viewcos = jnp.sum(rays * normal, axis=-1) / jnp.maximum(dist, 1e-9)
    view_ok = viewcos > 0.5
    visible = local_point_mask & z_ok & in_img & dist_ok & view_ok

    # already-bound points must not be re-matched (reference flags
    # mnLastFrameSeen, src/Tracking.cc:1232-1240)
    P = state.capacity_mp
    bound_flag = jnp.zeros(P + 1, bool).at[
        jnp.where(cur_point_idx >= 0, cur_point_idx, P)
    ].set(True)
    already = bound_flag[local_points]
    visible = visible & ~already

    # predicted octave from distance (reference MapPoint::PredictScale)
    ratio = state.mp_max_dist[local_points] / jnp.maximum(dist, 1e-9)
    # log(scale_factor) from the runtime pyramid, not a hardcoded 1.2
    log_scale = jnp.log(scale_factors[1])
    pred_octave = jnp.clip(
        jnp.ceil(jnp.log(jnp.maximum(ratio, 1e-9)) / log_scale).astype(jnp.int32),
        0,
        num_levels - 1,
    )
    r = jnp.where(viewcos > 0.998, 2.5, 4.0) * radius_mult
    radius = r * scale_factors[pred_octave]

    free_feat = frame.valid & (cur_point_idx < 0)
    res = match.search_by_projection(
        state.mp_desc[local_points], uv, pred_octave, visible,
        frame.desc, frame.xy, frame.octave, free_feat,
        radius, max_dist=max_dist, ratio=0.8,
    )
    assigned = res.assigned  # feature -> local point row
    new_bind = jnp.where(
        assigned >= 0,
        local_points[jnp.clip(assigned, 0, local_points.shape[0] - 1)],
        -1,
    ).astype(jnp.int32)
    merged = jnp.where(cur_point_idx >= 0, cur_point_idx, new_bind)
    return merged, visible


@jax.jit
def build_pose_observations(
    point_idx, frame: FrameData, mp_pos, mp_valid, inv_sigma2_per_octave
) -> pose_opt.PoseObservations:
    pid = jnp.clip(point_idx, 0, mp_pos.shape[0] - 1)
    mask = (point_idx >= 0) & mp_valid[pid] & frame.valid
    return pose_opt.PoseObservations(
        pw=mp_pos[pid],
        uv=frame.xy,
        ur=frame.ur,
        inv_sigma2=inv_sigma2_per_octave[
            jnp.clip(frame.octave, 0, inv_sigma2_per_octave.shape[0] - 1)
        ],
        mask=mask,
    )


@jax.jit
def update_seen_counters(state: ms.MapState, visible_pts, visible_mask, found_pts, found_mask):
    """mnVisible / mnFound bookkeeping (reference src/Tracking.cc:1232-1249,
    MapPoint::IncreaseVisible/IncreaseFound)."""
    P = state.capacity_mp
    vis_w = jnp.where(visible_mask, visible_pts, P)
    fnd_w = jnp.where(found_mask, found_pts, P)
    return state._replace(
        mp_visible=state.mp_visible.at[vis_w].add(1, mode="drop"),
        mp_found=state.mp_found.at[fnd_w].add(1, mode="drop"),
    )


# ---------------------------------------------------------------------------
# host-side tracker
# ---------------------------------------------------------------------------


class Tracker:
    """Host orchestration of the per-frame pipeline over jitted stages."""

    def __init__(self, cfg: SlamConfig, builder: FrameBuilder, state: ms.MapState):
        self.cfg = cfg
        self.builder = builder
        self.map = state
        self.K = builder.K
        nl = cfg.orb.num_levels
        sf = cfg.orb.scale_factor
        self.scale_factors = jnp.asarray([sf**i for i in range(nl)], jnp.float32)
        self.inv_sigma2 = jnp.asarray([1.0 / sf ** (2 * i) for i in range(nl)], jnp.float32)
        self.bounds = cam_geo.compute_image_bounds(cfg.camera)
        self.state = TrackState.NOT_INITIALIZED
        self.velocity: Optional[jnp.ndarray] = None
        self.last_Tcw: Optional[jnp.ndarray] = None
        self.last_frame: Optional[FrameData] = None
        self.last_point_idx: Optional[jnp.ndarray] = None
        self.ref_kf: int = -1
        self.frames_since_kf = 0
        self.last_inliers = 0
        self.n_keyframes = 0
        self._params = None
        self._ref_pose_np = np.eye(4)
        # localization-only visual-odometry fallback engaged (reference
        # mbVO, src/Tracking.cc:142,365-412)
        self.mb_vo = False
        # set when the policy requests a keyframe; consumed by System
        self.kf_request = None
        self.new_keyframe_ids: list[int] = []
        # monocular-initialization state (reference mInitialFrame /
        # mvIniMatches, include/Tracking.h:98-104)
        self.init_frame: Optional[FrameData] = None
        self._init_key = jax.random.PRNGKey(cfg.seed)
        # per-frame trajectory log (reference mlRelativeFramePoses,
        # include/Tracking.h:112-115)
        self.trajectory: list[tuple[float, np.ndarray, int, bool]] = []

    # -- initialization ----------------------------------------------------

    def _stereo_initialize(self, frame: FrameData) -> bool:
        # reference gates on total feature count (> 500 of 1000,
        # src/Tracking.cc:545); scale to the configured budget and require a
        # usable number of depth seeds
        n_feat = int(jnp.sum(frame.valid))
        n_depth = int(jnp.sum(frame.valid & (frame.depth > 0)))
        if n_feat < self.cfg.orb.num_features // 2 or n_depth < 100:
            return False
        Tcw = se3.identity()
        S = frame.xy.shape[0]
        st, kf0 = ms.add_keyframe(
            self.map, jnp.int32(frame.frame_id), Tcw,
            frame.xy, frame.ur, frame.depth, frame.octave, frame.angle,
            frame.desc, frame.valid, jnp.full((S,), -1, jnp.int32),
        )
        st, pids = self._create_depth_points(st, int(kf0), frame, Tcw,
                                             jnp.full((S,), -1, jnp.int32),
                                             all_depths=True)
        self.map = st
        self.ref_kf = int(kf0)
        self.last_point_idx = st.kf_point_idx[int(kf0)]
        self.new_keyframe_ids.append(int(kf0))
        self.n_keyframes = 1
        self._ref_pose_np = np.eye(4)
        return True

    def _create_depth_points(self, st, kf_id, frame: FrameData, Tcw, existing_bind,
                             all_depths: bool = False):
        """Create map points for unbound features with valid depth.

        At initialization every depth>0 feature becomes a point (reference
        src/Tracking.cc:564-592); at later keyframes only close points
        (depth < ThDepth*baseline) plus the 100 nearest regardless
        (reference src/Tracking.cc:1168-1216)."""
        th = self.cfg.tracking.th_depth * self.cfg.camera.baseline
        has_depth = frame.valid & (frame.depth > 0) & (existing_bind < 0)
        if all_depths:
            create = has_depth
        else:
            depth_rank = jnp.sum(
                (frame.depth[None, :] < frame.depth[:, None]) & has_depth[None, :],
                axis=1,
            )
            create = has_depth & ((frame.depth < th) | (depth_rank < 100))
        pc = cam_geo.backproject(frame.xy, frame.depth, self.K)
        Twc = se3.inverse(Tcw)
        pw = se3.apply(Twc, pc)
        Ow = se3.camera_center(Tcw)
        rays = pw - Ow
        dist = jnp.linalg.norm(rays, axis=-1)
        normal = rays / jnp.maximum(dist[:, None], 1e-9)
        scale = self.scale_factors[jnp.clip(frame.octave, 0, self.scale_factors.shape[0] - 1)]
        max_d = dist * scale
        min_d = max_d / float(self.cfg.orb.scale_factor ** (self.cfg.orb.num_levels - 1))
        S = frame.xy.shape[0]
        st, pids = ms.add_points(
            st, pw, create, jnp.int32(kf_id), jnp.arange(S, dtype=jnp.int32),
            frame.desc, normal, min_d, max_d, frame.ur,
        )
        return st, pids

    def _monocular_initialize(self, frame: FrameData) -> bool:
        """Two-view bootstrap (reference MonocularInitialization
        src/Tracking.cc:604-685 + CreateInitialMapMonocular :687-788)."""
        min_m = self.cfg.tracking.mono_init_min_matches
        n_feat = int(jnp.sum(frame.valid))
        if self.init_frame is None:
            if n_feat > min_m:  # reference requires > 100 features
                self.init_frame = frame
            return False
        f0 = self.init_frame
        res = match.search_for_initialization(
            f0.desc, f0.xy, f0.octave, f0.valid, f0.angle,
            frame.desc, frame.xy, frame.octave, frame.valid, frame.angle,
            max_level=self.cfg.orb.num_levels - 1,
        )
        n = int(res.num_matches)
        if n < min_m:
            self.init_frame = frame if n_feat >= min_m else None
            return False
        # align match arrays: per f0 slot -> frame slot
        f2_idx = res.best_idx
        matched = f2_idx >= 0
        f2c = jnp.clip(f2_idx, 0, frame.xy.shape[0] - 1)
        self._init_key, sub = jax.random.split(self._init_key)
        init = mono_init.initialize(
            f0.xy, frame.xy[f2c], matched, self.K, sub,
            sigma=self.cfg.solver.init_sigma,
            iters=self.cfg.solver.init_ransac_iters,
        )
        if not bool(init.success):
            return False
        good = init.good & matched
        n_good = int(jnp.sum(good))
        if n_good < min_m:
            return False
        # median-depth scale normalization (reference src/Tracking.cc:737-763)
        z = init.points3d[:, 2]
        med = jnp.nanmedian(jnp.where(good, z, jnp.nan))
        inv_med = 1.0 / jnp.maximum(med, 1e-6)
        pts = init.points3d * inv_med
        T21 = init.T21.at[:3, 3].mul(inv_med)

        S = frame.xy.shape[0]
        st, kf0 = ms.add_keyframe(
            self.map, jnp.int32(f0.frame_id), se3.identity(),
            f0.xy, f0.ur, f0.depth, f0.octave, f0.angle,
            f0.desc, f0.valid, jnp.full((S,), -1, jnp.int32),
        )
        st, kf1 = ms.add_keyframe(
            st, jnp.int32(frame.frame_id), T21,
            frame.xy, frame.ur, frame.depth, frame.octave, frame.angle,
            frame.desc, frame.valid, jnp.full((S,), -1, jnp.int32),
        )
        # seed points bound to kf0's feature slots
        rays = pts
        dist = jnp.linalg.norm(rays, axis=-1)
        normal = rays / jnp.maximum(dist[:, None], 1e-9)
        nl = self.cfg.orb.num_levels
        scale = self.scale_factors[jnp.clip(f0.octave, 0, nl - 1)]
        max_d = dist * scale
        min_d = max_d / float(self.cfg.orb.scale_factor ** (nl - 1))
        st, pids = ms.add_points(
            st, pts, good, kf0, jnp.arange(S, dtype=jnp.int32),
            f0.desc, normal, min_d, max_d, jnp.full((S,), -1.0),
        )
        from orbslam2_tpu.pipeline import local_mapping as lm_mod

        st = lm_mod.bind_points_to_kf(st, kf1, f2c.astype(jnp.int32), pids, pids >= 0)
        st = ms.update_covisibility_row(st, kf1)
        st = ms.recompute_point_stats(st, pids, self.scale_factors)
        self.map = st
        self.ref_kf = int(kf1)
        self.last_Tcw = T21
        self.last_point_idx = st.kf_point_idx[int(kf1)]
        self.new_keyframe_ids.extend([int(kf0), int(kf1)])
        self.n_keyframes = 2
        self._ref_pose_np = np.asarray(T21)
        return True

    # -- localization-only dual hypothesis (reference mbVO) ----------------

    def localization_vo_step(self, frame: FrameData, reloc_db) -> "TrackResult":
        """Dual-hypothesis localization-mode tracking (reference
        src/Tracking.cc:365-412): when the frozen map has fallen out of
        view, keep the camera pose flowing by pure frame-to-frame visual
        odometry against points backprojected from the LAST frame's depth
        (the reference's temporal 'visual odometry' points, UpdateLastFrame
        src/Tracking.cc:855-922), while attempting relocalization against
        the map every frame. Relocalization wins as soon as it succeeds."""
        from orbslam2_tpu.ops import match as match_mod
        from orbslam2_tpu.solvers import pose_opt as po

        # hypothesis A: relocalization against the frozen map
        if self.relocalize(frame, reloc_db):
            self.mb_vo = False
            self.last_frame = frame
            Tcw_np = np.asarray(self.last_Tcw)
            self._log_pose(frame, True, Tcw_np)
            self.last_inliers = max(self.last_inliers, 50)
            return TrackResult(Tcw_np, self.state, self.last_inliers, False)

        # hypothesis B: frame-to-frame VO on last-frame depth
        self.mb_vo = True
        velocity = self.velocity if self.velocity is not None else jnp.eye(4)
        Tcw_pred = velocity @ self.last_Tcw
        lf = self.last_frame
        pc = cam_geo.backproject(lf.xy, lf.depth, self.K)
        pw = se3.apply(se3.inverse(self.last_Tcw), pc)
        has = lf.valid & (lf.depth > 0)
        pc_pred = se3.apply(Tcw_pred, pw)
        uv_pred = cam_geo.project(pc_pred, self.K)
        radius = 14.0 * self.scale_factors[
            jnp.clip(lf.octave, 0, self.scale_factors.shape[0] - 1)
        ]
        res = match_mod.search_frame_to_frame(
            lf.desc, uv_pred, lf.octave, has & (pc_pred[:, 2] > 0.1), lf.angle,
            frame.desc, frame.xy, frame.octave, frame.valid, frame.angle,
            radius, max_dist=self.cfg.tracking.match_max_dist,
        )
        assigned = res.assigned
        S = assigned.shape[0]
        ac = jnp.clip(assigned, 0, S - 1)
        obs = po.PoseObservations(
            pw=pw[ac],
            uv=frame.xy,
            ur=frame.ur,
            inv_sigma2=self.inv_sigma2[
                jnp.clip(frame.octave, 0, self.inv_sigma2.shape[0] - 1)
            ],
            mask=(assigned >= 0) & frame.valid,
        )
        r = po.pose_optimize(Tcw_pred, obs, self.K)
        n_inl = int(r.num_inliers)
        ok = n_inl >= self.cfg.tracking.min_inliers_track
        Tcw = r.Tcw if ok else Tcw_pred
        self.velocity = Tcw @ se3.inverse(self.last_Tcw)
        self.last_Tcw = Tcw
        self.last_frame = frame
        self.last_point_idx = jnp.full((S,), -1, jnp.int32)
        self.last_inliers = n_inl
        self.state = TrackState.OK if ok else TrackState.LOST
        Tcw_np = np.asarray(Tcw)
        self._log_pose(frame, ok, Tcw_np)
        return TrackResult(Tcw_np, self.state, n_inl, False)

    # -- relocalization ----------------------------------------------------

    def warmup_reloc(self, db):
        """Precompile every program `relocalize` dispatches, with the live
        map's shapes and a dummy frame. The relocalization chain is only
        exercised when tracking is already LOST, and compiling its ~6
        fresh programs in the middle of a recovery attempt would stall it —
        pay them at session startup instead (same rationale as
        LoopCloser.warmup_correction)."""
        if db is None:
            return
        from orbslam2_tpu.solvers import epnp as epnp_mod
        from orbslam2_tpu.vocab import bow as bow_mod

        st = self.map
        S = self.cfg.orb.feature_slots
        f = FrameData(
            frame_id=0, timestamp=0.0,
            xy=jnp.zeros((S, 2), jnp.float32),
            xy_raw=jnp.zeros((S, 2), jnp.float32),
            ur=jnp.full((S,), -1.0, jnp.float32),
            depth=jnp.full((S,), -1.0, jnp.float32),
            octave=jnp.zeros((S,), jnp.int32),
            angle=jnp.zeros((S,), jnp.float32),
            desc=jnp.zeros((S, 8), jnp.uint32),
            valid=jnp.zeros((S,), bool),
        )
        vec = bow_mod.bow_vector(f.desc, f.valid, db.codebook)
        db.query(vec, ~st.kf_valid, 0.0, st.covis)
        bind = reference_kf_match(
            st.kf_desc[0], st.kf_point_idx[0], st.kf_angle[0],
            st.kf_feat_valid[0], st.mp_valid, f,
        )
        pid = jnp.clip(bind, 0, st.capacity_mp - 1)
        pnp = epnp_mod.ransac_pnp(
            st.mp_pos[pid], f.xy, (bind >= 0) & st.mp_valid[pid],
            self.inv_sigma2[jnp.clip(f.octave, 0, self.inv_sigma2.shape[0] - 1)],
            self.K, jax.random.PRNGKey(0),
            iters=self.cfg.solver.pnp_ransac_iters,
            min_inliers=self.cfg.solver.pnp_min_inliers,
        )
        obs = build_pose_observations(bind, f, st.mp_pos, st.mp_valid, self.inv_sigma2)
        res = pose_opt.pose_optimize(st.kf_Tcw[0], obs, self.K)
        _, _, lpts, lptsm, _ = gather_local_map(
            st, st.kf_point_idx[0],
            max_local_kfs=self.cfg.map.max_local_keyframes,
            max_local_points=self.cfg.map.max_local_points,
        )
        b2, _ = search_local_points(
            st, lpts, lptsm, res.Tcw, bind, f, self.K,
            self.scale_factors, self.bounds, jnp.float32(2.5),
            num_levels=self.cfg.orb.num_levels,
        )
        jax.block_until_ready((pnp.Tcw, b2))

    def relocalize(self, frame: FrameData, db) -> bool:
        """Recover from LOST using the keyframe database
        (reference Tracking::Relocalization, src/Tracking.cc:1441-1603).

        The reference seeds EPnP from scratch; here each candidate keyframe
        seeds a robust pose optimization from ITS OWN pose (the candidate
        matched visually, so its pose is a good basin), followed by the
        reference's escalating projection search until >= 50 inliers.
        """
        from orbslam2_tpu.vocab import bow as bow_mod

        if db is None:
            return False
        st = self.map
        vec = bow_mod.bow_vector(frame.desc, frame.valid, db.codebook)
        # no covisibility exclusion and no min-score gate for reloc, but the
        # SAME top-10 covisibility-group accumulation as loop detection
        # (reference DetectRelocalizationCandidates,
        # src/KeyFrameDatabase.cc:219-326)
        # exclude culled slots whose DB row is still stale (slots recycle)
        cand, mask, _ = db.query(vec, ~st.kf_valid, 0.0, st.covis)
        cands = [int(c) for c, m in zip(np.asarray(cand), np.asarray(mask)) if m][:5]
        for c in cands:
            bind = reference_kf_match(
                st.kf_desc[c], st.kf_point_idx[c], st.kf_angle[c],
                st.kf_feat_valid[c], st.mp_valid, frame,
            )
            if int(jnp.sum(bind >= 0)) < self.cfg.tracking.min_matches_ref:
                continue
            # EPnP RANSAC seeds the pose (reference :1486-1551); the matched
            # candidate keyframe's own pose is the fallback initialization
            from orbslam2_tpu.solvers import epnp as epnp_mod

            pid = jnp.clip(bind, 0, st.capacity_mp - 1)
            self._init_key, sub = jax.random.split(self._init_key)
            pnp = epnp_mod.ransac_pnp(
                st.mp_pos[pid], frame.xy, (bind >= 0) & st.mp_valid[pid],
                self.inv_sigma2[jnp.clip(frame.octave, 0, self.inv_sigma2.shape[0] - 1)],
                self.K, sub,
                iters=self.cfg.solver.pnp_ransac_iters,
                min_inliers=self.cfg.solver.pnp_min_inliers,
            )
            T_init = pnp.Tcw if bool(pnp.success) else st.kf_Tcw[c]
            obs = build_pose_observations(bind, frame, st.mp_pos, st.mp_valid, self.inv_sigma2)
            res = pose_opt.pose_optimize(T_init, obs, self.K)
            if int(res.num_inliers) < self.cfg.tracking.min_inliers_track:
                continue
            Tcw = res.Tcw
            bind = jnp.where(res.inliers, bind, -1)
            # escalating projection search (reference :1554-1588)
            lkf, lkfm, lpts, lptsm, _ = gather_local_map(
                st, st.kf_point_idx[c],
                max_local_kfs=self.cfg.map.max_local_keyframes,
                max_local_points=self.cfg.map.max_local_points,
            )
            for radius_mult in (2.5, 1.0):
                bind, _ = search_local_points(
                    st, lpts, lptsm, Tcw, bind, frame, self.K,
                    self.scale_factors, self.bounds, jnp.float32(radius_mult),
                    num_levels=self.cfg.orb.num_levels,
                )
                obs = build_pose_observations(bind, frame, st.mp_pos, st.mp_valid, self.inv_sigma2)
                res = pose_opt.pose_optimize(Tcw, obs, self.K)
                Tcw = res.Tcw
                bind = jnp.where(res.inliers, bind, -1)
            if int(res.num_inliers) >= self.cfg.tracking.min_inliers_local_after_reloc:
                self.state = TrackState.OK
                self.last_Tcw = Tcw
                self.last_frame = frame
                self.last_point_idx = bind
                self.velocity = None
                self.ref_kf = c
                self.refresh_ref_pose()
                return True
        return False

    # -- main entry --------------------------------------------------------

    def process(self, frame: FrameData, reloc_db=None) -> TrackResult:
        is_kf = False
        if self.state == TrackState.LOST:
            if self.relocalize(frame, reloc_db):
                self._log_pose(frame, True, self.last_Tcw)
                return TrackResult(
                    np.asarray(self.last_Tcw), self.state, self.last_inliers, False
                )
            self._log_pose(frame, False)
            return TrackResult(
                np.asarray(self.last_Tcw if self.last_Tcw is not None else jnp.eye(4)),
                self.state, 0, False,
            )
        if self.state == TrackState.NOT_INITIALIZED:
            if self.cfg.sensor in (Sensor.STEREO, Sensor.RGBD):
                if self._stereo_initialize(frame):
                    self.state = TrackState.OK
                    self.last_Tcw = se3.identity()
                    self.last_frame = frame
                    self.frames_since_kf = 0
                    self._log_pose(frame, True)
                    return TrackResult(np.eye(4), self.state, 0, True)
            else:
                if self._monocular_initialize(frame):
                    self.state = TrackState.OK
                    self.last_frame = frame
                    self.frames_since_kf = 0
                    self._log_pose(frame, True, self.last_Tcw)
                    return TrackResult(np.asarray(self.last_Tcw), self.state, 0, True)
            self._log_pose(frame, False)
            return TrackResult(np.eye(4), TrackState.NOT_INITIALIZED, 0, False)

        # ---- fused per-frame step (pipeline/fused.py) ----
        from orbslam2_tpu.pipeline import fused

        self._ensure_params()
        velocity = self.velocity if self.velocity is not None else jnp.eye(4)
        st, out = fused.track_step(
            self.map, frame,
            self.last_frame.xy, self.last_point_idx,
            self.last_frame.octave, self.last_frame.angle, self.last_frame.desc,
            self.last_Tcw, velocity,
            jnp.asarray(self.velocity is not None),
            jnp.int32(self.ref_kf), self.K, self._params,
            max_local_kfs=self.cfg.map.max_local_keyframes,
            max_local_points=self.cfg.map.max_local_points,
            num_levels=self.cfg.orb.num_levels,
        )
        self.map = st
        # single host sync for everything the policy needs
        Tcw_np, ok, n_inliers, ref_tracked, close_t, close_f = jax.device_get(
            (out.Tcw, out.ok, out.n_inliers, out.ref_tracked,
             out.close_tracked, out.close_free)
        )
        ok = bool(ok)
        n_inliers = int(n_inliers)
        Tcw = out.Tcw
        cur_point_idx = out.point_idx

        if not ok or n_inliers < self.cfg.tracking.min_inliers_local:
            self.state = TrackState.LOST
            self.velocity = None
            self._log_pose(frame, False)
            return TrackResult(Tcw_np, self.state, n_inliers, False)

        self.state = TrackState.OK
        # motion model (reference src/Tracking.cc:447-456)
        self.velocity = Tcw @ se3.inverse(self.last_Tcw)

        # ---- keyframe policy ----
        if self._need_new_keyframe(n_inliers, int(ref_tracked), int(close_t), int(close_f)):
            self.kf_request = (frame, Tcw, cur_point_idx)
            is_kf = True
            self.frames_since_kf = 0
        else:
            self.frames_since_kf += 1

        self.last_Tcw = Tcw
        self.last_frame = frame
        self.last_point_idx = cur_point_idx
        self.last_inliers = n_inliers
        self._log_pose(frame, True, Tcw_np)
        return TrackResult(Tcw_np, self.state, n_inliers, is_kf)

    def _ensure_params(self):
        if self._params is not None:
            return
        from orbslam2_tpu.pipeline import fused

        radius_th = 7.0 if self.cfg.sensor != Sensor.MONOCULAR else 15.0
        if self.cfg.tracking.search_radius > 0:
            radius_th = float(self.cfg.tracking.search_radius)
        self._params = fused.TrackParams(
            scale_factors=self.scale_factors,
            inv_sigma2=self.inv_sigma2,
            bounds=jnp.asarray(self.bounds, jnp.float32),
            radius_th=jnp.float32(radius_th),
            min_track=jnp.int32(self.cfg.tracking.min_inliers_track),
            close_depth=jnp.float32(
                self.cfg.tracking.th_depth * self.cfg.camera.baseline
            ),
            min_track_local=jnp.int32(self.cfg.tracking.min_inliers_local),
            match_max_dist=jnp.int32(self.cfg.tracking.match_max_dist),
        )

    def process_rgbd_fast(self, image, depth_map, timestamp: float) -> TrackResult:
        """Single-dispatch RGB-D frame: extraction + depth seeding + tracking
        fused into one device program (state must be OK)."""
        from orbslam2_tpu.pipeline import fused

        self._ensure_params()
        frame_id = self.builder._fresh_id()
        velocity = self.velocity if self.velocity is not None else jnp.eye(4)
        st, frame, out = fused.track_frame_rgbd(
            self.map, image, depth_map, jnp.int32(frame_id),
            self.last_frame.xy, self.last_point_idx,
            self.last_frame.octave, self.last_frame.angle, self.last_frame.desc,
            self.last_Tcw, velocity,
            jnp.asarray(self.velocity is not None),
            jnp.int32(self.ref_kf), self.K, self._params,
            jnp.float32(1.0 / self.cfg.tracking.depth_map_factor),
            self.cfg.orb,
            max_local_kfs=self.cfg.map.max_local_keyframes,
            max_local_points=self.cfg.map.max_local_points,
            num_levels=self.cfg.orb.num_levels,
            has_distortion=self.cfg.camera.has_distortion(),
        )
        self.map = st
        frame = frame._replace(frame_id=frame_id, timestamp=timestamp)
        Tcw_np, ok, n_inliers, ref_tracked, close_t, close_f = jax.device_get(
            (out.Tcw, out.ok, out.n_inliers, out.ref_tracked,
             out.close_tracked, out.close_free)
        )
        ok = bool(ok)
        n_inliers = int(n_inliers)
        if not ok or n_inliers < self.cfg.tracking.min_inliers_local:
            self.state = TrackState.LOST
            self.velocity = None
            self._log_pose(frame, False)
            return TrackResult(Tcw_np, self.state, n_inliers, False)

        self.state = TrackState.OK
        self.velocity = out.Tcw @ se3.inverse(self.last_Tcw)
        is_kf = False
        if self._need_new_keyframe(n_inliers, int(ref_tracked), int(close_t), int(close_f)):
            self.kf_request = (frame, out.Tcw, out.point_idx)
            is_kf = True
            self.frames_since_kf = 0
        else:
            self.frames_since_kf += 1
        self.last_Tcw = out.Tcw
        self.last_frame = frame
        self.last_point_idx = out.point_idx
        self.last_inliers = n_inliers
        self._log_pose(frame, True, Tcw_np)
        return TrackResult(Tcw_np, self.state, n_inliers, is_kf)

    def process_stereo_fast(self, left, right, timestamp: float) -> TrackResult:
        """Fused stereo frame (state must be OK): extraction + stereo
        correspondence + tracking in one device program."""
        from orbslam2_tpu.pipeline import fused

        self._ensure_params()
        frame_id = self.builder._fresh_id()
        velocity = self.velocity if self.velocity is not None else jnp.eye(4)
        st, frame, out = fused.track_frame_stereo(
            self.map, left, right, jnp.int32(frame_id),
            self.last_frame.xy, self.last_point_idx,
            self.last_frame.octave, self.last_frame.angle, self.last_frame.desc,
            self.last_Tcw, velocity,
            jnp.asarray(self.velocity is not None),
            jnp.int32(self.ref_kf), self.K, self._params, self.cfg.orb,
            max_local_kfs=self.cfg.map.max_local_keyframes,
            max_local_points=self.cfg.map.max_local_points,
            num_levels=self.cfg.orb.num_levels,
            has_distortion=self.cfg.camera.has_distortion(),
        )
        self.map = st
        frame = frame._replace(frame_id=frame_id, timestamp=timestamp)
        Tcw_np, ok, n_inliers, ref_tracked, close_t, close_f = jax.device_get(
            (out.Tcw, out.ok, out.n_inliers, out.ref_tracked,
             out.close_tracked, out.close_free)
        )
        ok = bool(ok)
        n_inliers = int(n_inliers)
        if not ok or n_inliers < self.cfg.tracking.min_inliers_local:
            self.state = TrackState.LOST
            self.velocity = None
            self._log_pose(frame, False)
            return TrackResult(Tcw_np, self.state, n_inliers, False)

        self.state = TrackState.OK
        self.velocity = out.Tcw @ se3.inverse(self.last_Tcw)
        is_kf = False
        if self._need_new_keyframe(n_inliers, int(ref_tracked), int(close_t), int(close_f)):
            self.kf_request = (frame, out.Tcw, out.point_idx)
            is_kf = True
            self.frames_since_kf = 0
        else:
            self.frames_since_kf += 1
        self.last_Tcw = out.Tcw
        self.last_frame = frame
        self.last_point_idx = out.point_idx
        self.last_inliers = n_inliers
        self._log_pose(frame, True, Tcw_np)
        return TrackResult(Tcw_np, self.state, n_inliers, is_kf)

    # -- keyframe policy ---------------------------------------------------

    def _need_new_keyframe(self, n_inliers, ref_tracked, close_tracked, close_free) -> bool:
        """Condensed version of reference src/Tracking.cc:1049-1139, fed by
        scalars computed inside the fused track step."""
        min_gap = self.cfg.tracking.kf_min_gap
        max_gap = max(int(self.cfg.camera.fps) // 2, 5)
        ratio = 0.75 if self.cfg.sensor != Sensor.MONOCULAR else 0.9
        if self.n_keyframes <= 2:
            ratio = 0.4
        need_ratio = n_inliers < ratio * max(ref_tracked, 1)
        close_cond = (
            self.cfg.sensor != Sensor.MONOCULAR
            and close_tracked < 100
            and close_free > 70
        )
        c1 = self.frames_since_kf >= max_gap
        c2 = (need_ratio or close_cond) and self.frames_since_kf >= min_gap
        return (c1 or c2) and n_inliers > 15

    def on_new_keyframe(self, kf_id: int, ref_pose_np=None):
        """Bookkeeping after the (fused) keyframe step ran. Passing
        `ref_pose_np` (already-fetched pose) avoids a device round trip."""
        self.ref_kf = kf_id
        self.n_keyframes += 1
        self.new_keyframe_ids.append(kf_id)
        if ref_pose_np is not None:
            self._ref_pose_np = np.asarray(ref_pose_np)
        else:
            self.refresh_ref_pose()

    def refresh_ref_pose(self):
        """Pull the current reference-KF pose to host (used to log poses
        relative to the reference; called after BA moves keyframes)."""
        if self.ref_kf >= 0:
            self._ref_pose_np = np.asarray(self.map.kf_Tcw[self.ref_kf])

    # -- logging -----------------------------------------------------------

    def _log_pose(self, frame: FrameData, tracked: bool, Tcw=None):
        """Log the pose RELATIVE to the current reference keyframe
        (reference src/Tracking.cc:518-536 stores Tcr = Tcw * Trw^-1), so the
        final trajectory picks up loop/BA corrections of keyframe poses.
        Pure host math against the cached reference pose — no device sync."""
        T = np.asarray(Tcw) if Tcw is not None else (
            np.asarray(self.last_Tcw) if self.last_Tcw is not None else np.eye(4)
        )
        if not np.isfinite(T).all():
            # a failed/uninitialized pose (e.g. the mbVO arbitration losing
            # both hypotheses) must not poison the trajectory with NaNs
            T = self.trajectory[-1][1] @ self._ref_pose_np if (
                self.trajectory and self.trajectory[-1][2] == self.ref_kf
            ) else np.eye(4)
            tracked = False
        if self.ref_kf >= 0 and np.isfinite(self._ref_pose_np).all():
            Tcr = T @ np.linalg.inv(self._ref_pose_np)
        else:
            Tcr = T
        self.trajectory.append((frame.timestamp, Tcr, self.ref_kf, tracked))

    def remap_trajectory_ref(self, old_ref: int, new_ref: int, Tcp: np.ndarray):
        """Re-anchor logged frames from a CULLED keyframe to its spanning-
        tree parent: Tcw = Tcr @ Tcw[culled] = (Tcr @ Tcp) @ Tcw[parent].
        The reference instead stores mTcp on SetBadFlag and walks up the
        tree at export time (src/KeyFrame.cc:552-556, src/System.cc:
        377-384); folding the relative pose in at cull time is equivalent
        and keeps the export loop trivial."""
        self.trajectory = [
            (t, Tcr @ Tcp, new_ref, ok) if ref == old_ref else (t, Tcr, ref, ok)
            for (t, Tcr, ref, ok) in self.trajectory
        ]
