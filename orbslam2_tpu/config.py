"""Typed configuration for the SLAM engine.

Mirrors every settings key the reference reads from its OpenCV YAML files
(reference src/Tracking.cc:44-152, src/Viewer.cc:34-52, src/MapDrawer.cc:31-43)
plus the fixed-capacity knobs the static-shape design needs (feature
slots, keyframe/point capacities, RANSAC iteration counts).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class Sensor(enum.Enum):
    """Sensor modes (reference include/System.h:55-59)."""

    MONOCULAR = 0
    STEREO = 1
    RGBD = 2


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics + distortion (reference src/Tracking.cc:50-108)."""

    fx: float = 525.0
    fy: float = 525.0
    cx: float = 319.5
    cy: float = 239.5
    # radial/tangential distortion k1,k2,p1,p2[,k3]
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    # stereo baseline times fx (reference "Camera.bf")
    bf: float = 40.0
    fps: float = 30.0
    # image geometry (static for the whole session; array shapes derive from it)
    width: int = 640
    height: int = 480
    # true if images arrive RGB (reference "Camera.RGB")
    rgb: bool = True

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2, self.k3))


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORB extractor settings (reference src/Tracking.cc:111-115, ORBextractor ctor).

    `num_features` is the live budget; `feature_slots` is the padded static
    array size every downstream kernel sees (a power-of-two multiple).
    """

    num_features: int = 1000
    scale_factor: float = 1.2
    num_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # --- static shape/capacity knobs ---
    feature_slots: int = 1024          # padded keypoint capacity per frame
    cell_size: int = 32                # spatial-uniformity grid cell (px, level 0)
    max_per_cell: int = 8              # per-cell cap before global top-k
    candidates_per_level: int = 4096   # FAST candidates kept per pyramid level
    # rescale each image to a fixed mean before detection so FAST's absolute
    # threshold is invariant to camera gain / exposure drift. Off by
    # default: the scene-content dependence of the mean injects its own
    # gain jitter under stable exposure (the reference has no equivalent;
    # its datasets have locked exposure).
    normalize_exposure: bool = False
    patch_size: int = 31               # orientation/descriptor patch
    half_patch: int = 15
    edge_threshold: int = 19           # border margin for keypoints


@dataclasses.dataclass(frozen=True)
class MapConfig:
    """Fixed capacities for the device-resident map pytree."""

    max_keyframes: int = 256
    max_points: int = 32768
    # covisibility thresholds (reference src/KeyFrame.cc:364 th=15,
    # src/Optimizer.cc:800 minFeat=100)
    covis_threshold: int = 15
    essential_threshold: int = 100
    # local map bounds (reference src/Tracking.cc:1378 caps local KFs at 80)
    max_local_keyframes: int = 80
    max_local_points: int = 8192
    # capacity-pressure recycling never touches points created within the
    # last N INSERTED keyframes (seq units). Under keyframe churn (one
    # insert per frame entering new territory) a small maturity age lets
    # recycling eat the active frontier: each insert recycles the points
    # the next frames needed, coverage drops, the policy inserts MORE
    # keyframes, and the loop starves tracking to LOST (observed on the
    # 205-frame orbit at a saturated 16k pool — inliers 93 -> 36 -> lost).
    # 24 matches the local-BA window: the points local BA still optimizes
    # are exactly the ones tracking still needs.
    recycle_min_age_kfs: int = 24


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    """Tracking-policy constants (reference src/Tracking.cc)."""

    # depth threshold multiplier: close stereo points within th_depth * baseline
    # (reference src/Tracking.cc:118-121)
    th_depth: float = 40.0
    # RGB-D depth map scaling (reference "DepthMapFactor", src/Tracking.cc:128-133)
    depth_map_factor: float = 1.0
    # minimum matches to accept motion-model / reference tracking
    # (reference src/Tracking.cc:850,962-992)
    min_matches_motion: int = 20
    min_matches_ref: int = 15
    min_inliers_track: int = 10
    # TrackLocalMap acceptance (reference src/Tracking.cc:1035-1039)
    min_inliers_local: int = 30
    min_inliers_local_after_reloc: int = 50
    # mono init needs >= 100 matches (reference src/Tracking.cc:617,636)
    mono_init_min_matches: int = 100
    # minimum frames between keyframes (reference mMinFrames = 0; raise to
    # damp insertion rate in the synchronous pipeline)
    kf_min_gap: int = 0
    # hard cap on frames between keyframes; 0 = the reference's fps/2
    # (src/Tracking.cc:1072 mMaxFrames = fps). Fast-rotating trajectories
    # at high resolution decay matches within the default window — a
    # tighter cap keeps fresh depth seeds coming.
    kf_max_gap: int = 0
    # pipelined tracking: 0 = resolve each frame's host pull immediately
    # (exact reference-order semantics; the default for tests); N >= 1 =
    # keep up to N frames in flight and defer each pull N frames, so the
    # host round trip overlaps device compute (depth 2 gives the async
    # host copy a FULL frame of slack). Keyframe bookkeeping/loop closing run
    # N frames late, like the reference's asynchronous
    # LocalMapping/LoopClosing threads.
    pipeline_depth: int = 0
    # defer local BA to its OWN device dispatch issued at keyframe-resolve
    # time (the reference's LocalMapping thread runs BA asynchronously the
    # same way, src/LocalMapping.cc:92-97). Only active in pipelined
    # (turbo) mode. DEFAULT OFF since the round-4 on-chip A/B: BA landing
    # 1-2 frames late degraded forward-dolly ATE 0.0066 -> 0.0089 (the
    # frames after a keyframe track against pre-BA anchors) and measured
    # NO fps win — the next frame's dispatch waits on the BA result on
    # device anyway, so deferral only hides the host pull.
    defer_local_ba: bool = False
    # motion-model projection search radius in LEVEL-0 pixels (reference
    # src/Tracking.cc:139: th=7 stereo/RGB-D, 15 mono; scaled by octave).
    # 0 = the reference per-sensor default. Fast rotation (deg-scale per
    # frame) at high resolution needs a wider gate: the velocity model's
    # angular error converts to 2x the pixels at 2x the focal length.
    search_radius: float = 0.0
    # Hamming gate for motion-model / local-map projection searches. The
    # reference uses TH_HIGH=100 (src/ORBmatcher.cc:37) tuned to its
    # bit_pattern_31_; our regenerated BRIEF produces true-match distances
    # ~25-40, and the loose gate admits prediction-biased wrong matches
    # whose quadratic pull (vs Huber-capped correct ones) locks pose
    # optimization to the motion prediction. 64 keeps 2x headroom over
    # true-match distances. Set 100 for reference parity.
    match_max_dist: int = 64


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """RANSAC / optimizer schedules (all static so they jit)."""

    # monocular initializer: 200 RANSAC iterations of 8-point sets
    # (reference src/Initializer.cc:86-110); we batch them all.
    init_ransac_iters: int = 256
    init_sigma: float = 1.0
    # PnP (EPnP) RANSAC (reference src/PnPsolver.cc:84)
    pnp_ransac_iters: int = 256
    pnp_min_inliers: int = 10
    # Sim3 RANSAC (reference src/LoopClosing.cc:311 — 5 iters/slice, 300 max)
    sim3_ransac_iters: int = 128
    sim3_min_inliers: int = 20
    # pose optimization: 4 rounds x 10 iterations (reference src/Optimizer.cc:262-268)
    pose_opt_rounds: int = 4
    pose_opt_iters: int = 10
    # local BA: 5 + 10 iterations (reference src/Optimizer.cc:660-693)
    local_ba_iters_first: int = 5
    local_ba_iters_second: int = 10
    # global BA: the reference uses 10 (src/LoopClosing.cc:690) on g2o's
    # double-precision LM; our batched LM slices are ~free (2/frame,
    # time-sliced off the frame path) and the essential graph moves every
    # keyframe before GBA runs, so a deeper schedule measurably recovers
    # the post-closure map (round 5: closure ATE 0.065 > no-loop drift
    # 0.045 at 10 iters — GBA was folding back under-converged)
    global_ba_iters: int = 24
    # time-sliced global BA after a loop correction (the device-side
    # equivalent of the reference's detached GBA thread,
    # src/LoopClosing.cc:615,683-790): instead of stalling tracking for
    # the full solve, dispatch `gba_slice_iters` LM iterations per tracked
    # frame against a snapshot problem and fold the result back in (with
    # spanning-tree propagation to keyframes/points created meanwhile)
    # when all `global_ba_iters` have run. False = inline synchronous GBA.
    gba_async: bool = True
    gba_slice_iters: int = 2
    # essential graph: 20 iterations (reference src/Optimizer.cc:916)
    pose_graph_iters: int = 20
    # essential-graph inner solver: dense direct solve up to this keyframe
    # capacity (a small (7K)^3 dense solve is cheap), matrix-free block-Jacobi PCG
    # above it (O(E * cg_iters), the scalable path)
    pose_graph_dense_max_k: int = 128
    pose_graph_cg_iters: int = 64
    # robust kernel thresholds: chi2 95% for 2 and 3 dof
    # (reference src/Optimizer.cc:273-274)
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    # local BA capacities (padded static shapes)
    ba_max_local_kfs: int = 32
    ba_max_fixed_kfs: int = 64
    ba_max_points: int = 8192
    # LOCAL BA reads at most this many observation slots per point (the
    # map keeps obs_slots=16): past ~8 local observers the extra edges
    # barely constrain the point but the [P,O] edge/assembly work is
    # linear in O (zero dropped observations on typical local windows at
    # O=8). Global BA and
    # loop closing always use the full table.
    ba_max_obs_per_point: int = 8


@dataclasses.dataclass(frozen=True)
class VocabConfig:
    """Bag-of-words vocabulary (replaces DBoW2; reference include/ORBVocabulary.h)."""

    branching: int = 10
    depth: int = 4                      # 10^4 = 10k leaves (dense-matmul friendly)
    # effective-word-count ceiling of the session vocabulary (vocab/bow.py).
    # Flat codebook up to 4096 words (one exact Hamming matmul); beyond
    # that a TWO-LEVEL codebook (256 coarse cells x up to 256 fine words
    # per cell = 65536 effective words — the dense-matmul shape of DBoW2's tree,
    # reference include/ORBVocabulary.h:25-31). The live size follows the
    # descriptor reservoir in power-of-4 buckets up to this ceiling.
    vocab_size: int = 65536
    # reservoir sample of session descriptors the vocabulary trains on;
    # the usable word count is ~reservoir/4, so raise this (e.g. 262144)
    # for long sessions that should reach the two-level sizes. Default
    # keeps CPU-test warmups cheap.
    reservoir_cap: int = 32768
    # prebuilt vocabulary file (the analogue of the reference's shipped
    # ORBvoc.txt, loaded at startup in src/System.cc:65-78; built by
    # tools/train_vocab.py). "builtin" loads orbslam2_tpu/data/vocab.npz
    # when present, an absolute path loads that file, None/"" forces the
    # session-trained reservoir vocabulary. A loaded vocabulary is FROZEN:
    # no mid-run retrains (and none of their compile/latency spikes).
    vocab_file: str | None = "builtin"
    train_iters: int = 6
    seed: int = 0
    # loop/reloc candidate capacities
    max_candidates: int = 16
    # covisibility consistency threshold (reference src/LoopClosing.cc:43)
    covisibility_consistency_th: int = 3
    # keyframes a consistency group may MISS before it resets. 0 = the
    # reference's strict consecutive-keyframe rule (src/LoopClosing.cc:
    # 156-232); >0 tolerates gaps for deliberately tiny vocabularies
    consistency_miss_grace: int = 0
    # exclude the newest N keyframes from loop candidacy. The reference
    # relies on covisibility exclusion alone (src/KeyFrameDatabase.cc:96-115);
    # the session-trained vocabulary is weaker than DBoW2's offline tree, so
    # temporally-adjacent keyframes that fell just below the covisibility
    # threshold need an explicit guard
    recent_exclusion: int = 8
    # precompile the FULL loop-correction chain (Sim3 RANSAC through
    # pose graph + global-BA slices) at loop-closer init, which moves the
    # first loop's compile stalls to session startup. Off by default: the
    # hermetic CPU test suite would pay
    # the chain's compile in every session that never closes a loop.
    warmup_correction: bool = False
    # precompile the relocalization chain (BoW query + reference-KF match
    # + EPnP RANSAC + escalating projection search) at loop-closer init.
    # Without it the FIRST LOST frame pays ~6 fresh compiles inside the
    # tracking loop. Off by default for the same reason as
    # warmup_correction.
    warmup_reloc: bool = False


@dataclasses.dataclass(frozen=True)
class ViewerConfig:
    """Offline renderer sizes (parity with reference src/Viewer.cc:34-52)."""

    keyframe_size: float = 0.05
    keyframe_line_width: float = 1.0
    graph_line_width: float = 0.9
    point_size: float = 2.0
    camera_size: float = 0.08
    camera_line_width: float = 3.0
    viewpoint_x: float = 0.0
    viewpoint_y: float = -0.7
    viewpoint_z: float = -1.8
    viewpoint_f: float = 500.0


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    """Top-level engine configuration."""

    sensor: Sensor = Sensor.RGBD
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    orb: OrbConfig = dataclasses.field(default_factory=OrbConfig)
    map: MapConfig = dataclasses.field(default_factory=MapConfig)
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    vocab: VocabConfig = dataclasses.field(default_factory=VocabConfig)
    viewer: ViewerConfig = dataclasses.field(default_factory=ViewerConfig)
    seed: int = 0

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


def load_yaml_settings(path: str, sensor: Sensor) -> SlamConfig:
    """Parse an ORB-SLAM2-style YAML settings file into a SlamConfig.

    The reference reads these via cv::FileStorage (reference src/System.cc:55,
    src/Tracking.cc:44-152). We parse the simple `Key: value` subset those
    files use (`%YAML:1.0` header, flat keys) without requiring a YAML lib.
    """
    values: dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if not line or line.startswith("%") or ":" not in line:
                continue
            key, _, raw = line.partition(":")
            raw = raw.strip()
            if not raw:
                continue
            try:
                values[key.strip()] = float(raw)
            except ValueError:
                continue

    def get(key: str, default: float) -> float:
        return values.get(key, default)

    cam = CameraConfig(
        fx=get("Camera.fx", 525.0),
        fy=get("Camera.fy", 525.0),
        cx=get("Camera.cx", 319.5),
        cy=get("Camera.cy", 239.5),
        k1=get("Camera.k1", 0.0),
        k2=get("Camera.k2", 0.0),
        p1=get("Camera.p1", 0.0),
        p2=get("Camera.p2", 0.0),
        k3=get("Camera.k3", 0.0),
        bf=get("Camera.bf", 40.0),
        fps=get("Camera.fps", 30.0) or 30.0,
        width=int(get("Camera.width", 640)),
        height=int(get("Camera.height", 480)),
        rgb=bool(int(get("Camera.RGB", 1))),
    )
    orb = OrbConfig(
        num_features=int(get("ORBextractor.nFeatures", 1000)),
        scale_factor=get("ORBextractor.scaleFactor", 1.2),
        num_levels=int(get("ORBextractor.nLevels", 8)),
        ini_th_fast=int(get("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(get("ORBextractor.minThFAST", 7)),
    )
    tracking = TrackingConfig(
        th_depth=get("ThDepth", 40.0),
        depth_map_factor=get("DepthMapFactor", 1.0) or 1.0,
    )
    viewer = ViewerConfig(
        keyframe_size=get("Viewer.KeyFrameSize", 0.05),
        keyframe_line_width=get("Viewer.KeyFrameLineWidth", 1.0),
        graph_line_width=get("Viewer.GraphLineWidth", 0.9),
        point_size=get("Viewer.PointSize", 2.0),
        camera_size=get("Viewer.CameraSize", 0.08),
        camera_line_width=get("Viewer.CameraLineWidth", 3.0),
        viewpoint_x=get("Viewer.ViewpointX", 0.0),
        viewpoint_y=get("Viewer.ViewpointY", -0.7),
        viewpoint_z=get("Viewer.ViewpointZ", -1.8),
        viewpoint_f=get("Viewer.ViewpointF", 500.0),
    )
    return SlamConfig(sensor=sensor, camera=cam, orb=orb, tracking=tracking, viewer=viewer)
