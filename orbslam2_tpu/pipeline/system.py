"""Public session API — the device-resident analogue of `ORB_SLAM2::System`
(reference include/System.h:65-136, src/System.cc).

Where the reference spawns LocalMapping/LoopClosing/Viewer threads and
cross-wires raw pointers (src/System.cc:85-115), this engine runs the
stages synchronously in a deterministic order per frame: track -> (if new
keyframe) local mapping -> (periodically) loop closing. The map is a single
device-resident pytree passed between jitted stages — no mutexes, no
condition variables, bitwise-reproducible runs.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from orbslam2_tpu.config import SlamConfig, Sensor
from orbslam2_tpu.io import trajectory as traj_io
from orbslam2_tpu.pipeline.frame import FrameBuilder, FrameData
from orbslam2_tpu.pipeline.local_mapping import LocalMapper
from orbslam2_tpu.pipeline.tracking import Tracker, TrackResult, TrackState
from orbslam2_tpu.slam_map import map_state as ms
from orbslam2_tpu.utils.eventlog import EventLog


class _TurboRec:
    """In-flight pipelined frame: device results + raw inputs (retained so
    an invalidated dispatch can be reprocessed on the exact path).
    `epoch` is the map epoch at dispatch time (System._map_epoch): results
    from a pre-reset epoch must never be folded into the new map."""

    __slots__ = ("res", "frame", "inputs", "prev_anchors", "epoch",
                 "window_ids")

    def __init__(self, res, frame, inputs, prev_anchors, epoch,
                 window_ids=None):
        self.res = res
        self.frame = frame
        self.inputs = inputs
        self.prev_anchors = prev_anchors
        self.epoch = epoch
        # dispatch-time probation-window snapshot (host ids): the device
        # `window_keep` mask indexes THIS array, not whatever the mapper's
        # rolling window looks like by resolve time
        self.window_ids = window_ids


class System:
    """One SLAM session.

    Usage:
        slam = System(cfg)
        for image, depth, t in frames:
            Tcw = slam.track_rgbd(image, depth, t)
        slam.save_trajectory_tum("out.txt")
    """

    def __init__(
        self,
        cfg: SlamConfig,
        enable_mapping: bool = True,
        enable_loop_closing: bool = True,
        log_path: Optional[str] = None,
    ):
        self.cfg = cfg
        # per-frame event/inlier stream (in-memory; JSONL when log_path set).
        # Records are built only from scalars the pipeline already pulls —
        # logging never adds a device round trip.
        self.log = EventLog(log_path)
        # On the GPU, f32 matmuls default to TF32 (about three decimal
        # digits); the SE3 chains and normal-equation products in the
        # solvers need full f32, so pin "highest" for the whole session.
        # Descriptor matching uses explicit precisions already.
        jax.config.update("jax_default_matmul_precision", "highest")
        self.builder = FrameBuilder(cfg)
        self.map = ms.allocate(cfg.map, cfg.orb)
        self.tracker = Tracker(cfg, self.builder, self.map)
        self.local_mapper = LocalMapper(cfg, self.builder.K, self.tracker.bounds)
        self.enable_mapping = enable_mapping
        self.enable_loop_closing = enable_loop_closing
        self.localization_only = False
        self.results: list[TrackResult] = []
        # loop closer is created lazily: its vocabulary is trained on the
        # first keyframe's descriptors (no shipped DBoW2 file; SURVEY.md §2a)
        self.loop_closer = None
        self._loop_key = None
        self._dummy_b = None
        # pipelined tracking (cfg.tracking.pipeline_depth >= 1): FIFO of
        # in-flight frame records whose host pulls are deferred, plus the
        # device-side anchor scalars (has_velocity / ref_kf /
        # frames_since_kf) selected by the previous frame's program.
        # Depth 1 overlaps each pull with one frame of device compute;
        # depth 2 gives the pull a FULL frame of slack, so by resolve time
        # the async host copy has already landed and the get is free.
        self._pending: list[_TurboRec] = []
        self._anchor = None
        self._in_resolve = False
        # bumped whenever the map pytree is replaced wholesale (reset,
        # load_map): in-flight device results from an older epoch must not
        # be folded into the new map
        self._map_epoch = 0

    # -- per-frame entries (reference src/System.cc:119-266) ---------------

    def track_rgbd(self, image, depth, timestamp: float = 0.0) -> np.ndarray:
        t = self.tracker
        if (
            self.localization_only
            and t.last_frame is not None
            and (t.mb_vo or t.state == TrackState.LOST)
        ):
            # mbVO dual-hypothesis mode (reference src/Tracking.cc:365-412)
            t.map = self.map
            frame = self.builder.rgbd(jnp.asarray(image), jnp.asarray(depth), timestamp)
            reloc_db = self.loop_closer.db if self.loop_closer is not None else None
            res = t.localization_vo_step(frame, reloc_db)
            self.results.append(res)
            self.log.emit("frame", frame_id=int(frame.frame_id),
                          t=float(frame.timestamp),
                          state="VO" if t.mb_vo else res.state.name,
                          n_inliers=int(res.num_inliers), is_kf=False)
            return res.Tcw
        if t.state == TrackState.OK:
            return self._track_turbo("rgbd", image, depth, timestamp)
        frame = self.builder.rgbd(jnp.asarray(image), jnp.asarray(depth), timestamp)
        return self._track(frame)

    def _track_turbo(self, sensor: str, a, b, timestamp: float):
        """Steady-state frame (any sensor): ONE device dispatch covering
        frame build + tracking + on-device keyframe policy +
        (conditionally) keyframe/mapping/local-BA, plus one small
        device_get. `a`/`b` are (image, depth) for RGB-D, (left, right)
        for stereo, (image, ignored) for monocular.

        With cfg.tracking.pipeline_depth = N >= 1 the host pulls are a
        depth-N FIFO: each frame's pull + bookkeeping is deferred N frames
        behind its dispatch, so the host round trip overlaps device
        compute (the device-side `next_*` anchor selections in FrameStepOut
        make every dispatch independent of the pending pulls). Keyframe
        bookkeeping and loop closing then run N frames late — like the
        reference's asynchronous LocalMapping/LoopClosing threads.

        Events discovered while resolving a pull are routed by kind:
        * "loop" (a loop correction landed): the in-flight frames' device
          results are VALID — each dispatch consumed the pre-correction
          map, and trajectory entries are logged relative to dispatch-epoch
          reference poses — so they are resolved normally and tracking is
          then re-anchored to the corrected map (_absorb_pending; the
          reference re-derives the last frame's pose from its reference
          keyframe after a map update the same way, src/Tracking.cc:296-310).
        * "lost" (tracking failed / auto-reset): frames dispatched after
          the failure chained off a bad pose; their raw inputs are
          reprocessed on the exact path (_reprocess_stale), after folding
          in any keyframe a dropped dispatch already inserted on-device."""
        rec = self._turbo_dispatch(sensor, a, b, timestamp)
        pipelined = (
            self.cfg.tracking.pipeline_depth >= 1
            and not self.localization_only
            and self.tracker.n_keyframes >= 1
        )
        if not pipelined:
            while self._pending:  # draining out of pipelined mode
                prev = self._pending.pop(0)
                ev = self._turbo_resolve(prev)
                if ev == "loop":
                    self._absorb_pending(extra=rec)
                    return self.results[-1].Tcw
                if ev == "lost":
                    self._anchor = None
                    return self._reprocess_stale(rec)
            ev = self._turbo_resolve(rec)
            if ev == "loop":
                self._absorb_pending()
            return self.results[-1].Tcw
        self._pending.append(rec)
        while len(self._pending) > self.cfg.tracking.pipeline_depth:
            prev = self._pending.pop(0)
            ev = self._turbo_resolve(prev)
            if ev == "loop":
                self._absorb_pending()
                return self.results[-1].Tcw
            if ev == "lost":
                self._anchor = None
                return self._reprocess_stale()
        # lazy device handle: converting to numpy synchronizes, so callers
        # that ignore the per-frame pose never pay the round trip
        return rec.res.track.Tcw

    def _reprocess(self, rec):
        sensor, a, b, timestamp = rec.inputs
        if self.tracker.state == TrackState.OK:
            return self._track_turbo(sensor, a, b, timestamp)
        return self._track(self._build_frame(sensor, a, b, timestamp))

    def _reprocess_stale(self, extra=None):
        """Reprocess every dropped in-flight frame in dispatch order (their
        device results chained off a failed pose). A dropped dispatch may
        already have inserted a keyframe on-device (the map commit happens
        at dispatch, system._turbo_dispatch); fold the host bookkeeping for
        those inserts in FIRST so the map accounting stays consistent —
        unless the map was reset since (epoch mismatch: the insert died
        with the old pytree)."""
        stale = self._pending
        self._pending = []
        if extra is not None:
            stale = stale + [extra]
        for s in stale:
            if s.epoch != self._map_epoch:
                continue
            if not (self.enable_mapping and not self.localization_only):
                continue
            is_kf, kf_id, keep, new_pids, cull_ids, cull_red = jax.device_get(
                (s.res.is_kf, s.res.kf_id, s.res.window_keep, s.res.new_pids,
                 s.res.cull_ids, s.res.cull_red)
            )
            if not bool(is_kf):
                continue
            kf_id = int(kf_id)
            self.map = self.local_mapper.after_keyframe(
                self.map, kf_id, new_pids, keep,
                cull_ids=cull_ids, cull_red=cull_red,
                window_ids=s.window_ids,
            )
            self._drain_culls()
            if self.loop_closer is not None:
                self.loop_closer.add_keyframe_to_db(self.map, kf_id)
            self._dispatch_deferred_ba(kf_id)
            t = self.tracker
            t.map = self.map
            t.n_keyframes += 1
            t.new_keyframe_ids.append(kf_id)
            self.log.emit("keyframe", kf_id=kf_id,
                          frame_id=int(s.frame.frame_id), orphaned=True,
                          n_new_points=int((np.asarray(new_pids) >= 0).sum()))
        out = None
        for s in stale:
            out = self._reprocess(s)
        return out

    def _absorb_pending(self, extra=None):
        """A loop correction just landed while frames were in flight. Each
        of those dispatches consumed the pre-correction map, so their
        device results are self-consistent tracks in the pre-correction
        frame of reference — and any keyframes they inserted are already
        in the (now corrected) map. Resolve them normally: trajectory
        entries are relative to dispatch-epoch reference poses and pick up
        the correction at export. Then re-anchor tracking by recomputing
        the newest frame's pose from its reference keyframe's corrected
        pose (the reference does the same after a map update,
        src/Tracking.cc:296-310) and drop the motion model."""
        pending = self._pending
        self._pending = []
        if extra is not None:
            pending.append(extra)
        while pending:
            rec = pending.pop(0)
            ev = self._turbo_resolve(rec)
            if ev == "lost":
                # tracking failed mid-absorb: the remaining frames chained
                # off the failed pose — hand them to the reprocess path
                self._pending = pending
                self._anchor = None
                return self._reprocess_stale()
            # ev == "loop": another correction landed; keep absorbing (each
            # remaining frame still logs against its dispatch-epoch ref)
        t = self.tracker
        if t.state == TrackState.OK and t.trajectory:
            _, Tcr, ref, okf = t.trajectory[-1]
            if ref >= 0 and ref == t.ref_kf and okf:
                t.refresh_ref_pose()
                t.last_Tcw = jnp.asarray(Tcr @ t._ref_pose_np)
            else:
                t.refresh_ref_pose()
        # keep t.velocity: relative, map-move-invariant (see
        # _reanchor_after_map_move)
        self._anchor = None
        return None

    def _build_frame(self, sensor: str, a, b, timestamp: float) -> FrameData:
        if sensor == "rgbd":
            return self.builder.rgbd(jnp.asarray(a), jnp.asarray(b), timestamp)
        if sensor == "stereo":
            return self.builder.stereo(jnp.asarray(a), jnp.asarray(b), timestamp)
        return self.builder.monocular(jnp.asarray(a), timestamp)

    def _turbo_dispatch(self, sensor: str, a, b, timestamp: float):
        from orbslam2_tpu.pipeline import fused

        t = self.tracker
        cfg = self.cfg
        mapper = self.local_mapper
        sc = cfg.solver
        t.map = self.map
        if t._params is None:
            t._ensure_params()
        fid = self.builder._fresh_id()
        window = mapper.probation_window()
        if self._anchor is not None:
            velocity, has_vel, ref_kf_in, fsk_in = self._anchor
        else:
            velocity = t.velocity if t.velocity is not None else jnp.eye(4)
            has_vel = jnp.asarray(t.velocity is not None)
            ref_kf_in = jnp.int32(t.ref_kf)
            fsk_in = jnp.int32(t.frames_since_kf)
        if b is None:
            if self._dummy_b is None:
                self._dummy_b = jnp.zeros((), jnp.float32)
            b = self._dummy_b
        state, frame, res = fused.frame_and_keyframe_step(
            self.map, jnp.asarray(a), jnp.asarray(b), jnp.int32(fid),
            t.last_frame.xy, t.last_point_idx,
            t.last_frame.octave, t.last_frame.angle, t.last_frame.desc,
            t.last_Tcw, velocity, has_vel,
            ref_kf_in, fsk_in,
            jnp.int32(t.n_keyframes),
            jnp.asarray(self.enable_mapping and not self.localization_only),
            window, t.K, t._params,
            jnp.float32(1.0 / cfg.tracking.depth_map_factor),
            mapper.level_sigma2, mapper.inv_sigma2, cfg.orb,
            scale_factor_last=float(cfg.orb.scale_factor ** (cfg.orb.num_levels - 1)),
            baseline=float(cfg.camera.baseline),
            covis_threshold=cfg.map.covis_threshold,
            max_local_kfs=cfg.map.max_local_keyframes,
            max_local_points=cfg.map.max_local_points,
            num_levels=cfg.orb.num_levels,
            has_distortion=cfg.camera.has_distortion(),
            n_neighbors=5,
            create_close_points=cfg.sensor != Sensor.MONOCULAR,
            max_local=sc.ba_max_local_kfs, max_fixed=sc.ba_max_fixed_kfs,
            max_points=sc.ba_max_points,
            obs_slots=min(sc.ba_max_obs_per_point, int(self.map.obs_slots)),
            iters1=sc.local_ba_iters_first, iters2=sc.local_ba_iters_second,
            max_gap=(cfg.tracking.kf_max_gap or max(int(cfg.camera.fps) // 2, 5)),
            min_gap=cfg.tracking.kf_min_gap,
            kf_ratio=0.75 if cfg.sensor != Sensor.MONOCULAR else 0.9,
            use_close_cond=cfg.sensor != Sensor.MONOCULAR,
            sensor=sensor,
            defer_ba=cfg.tracking.defer_local_ba,
            recycle_min_age=cfg.map.recycle_min_age_kfs,
        )
        self.map = state
        t.map = state
        frame = frame._replace(frame_id=fid, timestamp=timestamp)
        prev_anchors = (t.last_frame, t.last_point_idx, t.last_Tcw)
        # advance the device-side anchors NOW (no host sync): the next
        # dispatch can proceed before this frame's results are pulled
        t.last_frame = frame
        t.last_point_idx = res.next_point_idx
        t.last_Tcw = res.next_Tcw
        self._anchor = (
            res.next_velocity, res.accept, res.next_ref_kf,
            res.next_frames_since_kf,
        )
        # start the host copy of the small result scalars NOW: by the time
        # _turbo_resolve pulls them (one frame later in pipelined mode) the
        # bytes are already on the host and the get does not pay the
        # round trip again
        try:
            for arr in (res.track.Tcw, res.track.ok, res.accept,
                        res.track.n_inliers, res.is_kf, res.kf_id, res.kf_Tcw,
                        res.window_keep, res.new_pids, res.cull_ids,
                        res.cull_red):
                arr.copy_to_host_async()
        except (AttributeError, RuntimeError):
            pass
        return _TurboRec(res, frame, (sensor, a, b, timestamp), prev_anchors,
                         self._map_epoch, window_ids=mapper._window_np)

    def _turbo_resolve(self, rec) -> Optional[str]:
        """Host pull + bookkeeping for a dispatched frame. Returns the
        event kind when one occurred that affects the in-flight dispatches:
        "lost" (tracking failed / auto-reset — later dispatches chained off
        a bad pose and must be reprocessed) or "loop" (a loop correction
        moved the map — later dispatches stay valid but must be resolved
        against dispatch-epoch reference poses, see _absorb_pending);
        None otherwise."""
        from orbslam2_tpu.geometry import se3

        t = self.tracker
        cfg = self.cfg
        mapper = self.local_mapper
        res, frame = rec.res, rec.frame
        # the reference pose this frame's dispatch was computed against:
        # its trajectory entry must use THIS pose even if a correction
        # refreshes the cached reference pose mid-resolve
        pre_ref_pose = t._ref_pose_np
        # advance the async loop-closing machinery one step: finalize a
        # pending Sim3 verification (may fire a correction) or a pending
        # detection (may queue verifications) — both dispatched at earlier
        # frames so their device work and host copies overlapped tracking
        # (reference: the LoopClosing thread runs fully asynchronously)
        event = False
        if (
            self.enable_loop_closing
            and self.loop_closer is not None
            and self.loop_closer.has_pending
        ):
            event = self._finalize_loop_detection()
        # advance an in-flight time-sliced global BA by one bounded slice
        # (device-async; a fold-in moves every pose and is handled exactly
        # like a loop correction)
        if self._step_async_gba():
            event = True
        # ONE host pull per frame: scalars + the keyframe outputs (the
        # latter are small and returned unconditionally, so fetching them
        # here saves a second host round trip on every keyframe)
        (Tcw_np, ok_coarse, accept, n_inl, is_kf, kf_id, kf_Tcw_np, keep_np,
         new_pids_np, cull_ids_np, cull_red_np) = (
            jax.device_get(
                (res.track.Tcw, res.track.ok, res.accept,
                 res.track.n_inliers, res.is_kf, res.kf_id, res.kf_Tcw,
                 res.window_keep, res.new_pids, res.cull_ids, res.cull_red)
            )
        )
        ok = bool(accept)
        n_inl = int(n_inl)
        is_kf = bool(is_kf)
        if not ok:
            if self.localization_only and bool(ok_coarse):
                # map coverage fell below the accept gate but coarse
                # tracking still works: switch to mbVO instead of LOST
                # (reference src/Tracking.cc:365-380)
                t.mb_vo = True
                t.state = TrackState.OK
                t.velocity = res.next_velocity
                t.last_inliers = n_inl
                t._log_pose(frame, True, Tcw_np)
                self.results.append(TrackResult(Tcw_np, t.state, n_inl, False))
                self.log.emit("frame", frame_id=int(frame.frame_id),
                              t=float(frame.timestamp), state="VO",
                              n_inliers=n_inl, is_kf=False)
                return "loop" if event else None
            t.state = TrackState.LOST
            t.velocity = None
            # restore the pre-frame anchors: relocalization must match
            # against the last GOOD frame, not the one that lost tracking
            t.last_frame, t.last_point_idx, t.last_Tcw = rec.prev_anchors
            self._anchor = None
            t._log_pose(frame, False)
            self.results.append(TrackResult(Tcw_np, t.state, n_inl, False))
            try:
                seed = np.asarray(rec.prev_anchors[2])
                anchor_dt = float(np.linalg.norm(
                    np.asarray(Tcw_np)[:3, 3] - seed[:3, 3]))
            except Exception:
                anchor_dt = -1.0
            try:
                rp, nb, pv = jax.device_get((
                    self.map.kf_Tcw[t.ref_kf],
                    jnp.sum((self.map.kf_point_idx[t.ref_kf] >= 0)
                            & self.map.mp_valid[jnp.clip(
                                self.map.kf_point_idx[t.ref_kf], 0,
                                self.map.capacity_mp - 1)]),
                    jnp.sum(self.map.mp_valid),
                ))
                seed_vs_ref = float(np.linalg.norm(
                    np.asarray(rp)[:3, 3] - seed[:3, 3]))
                extra_dbg = {"seed_vs_ref_dt": seed_vs_ref,
                             "ref_live_bindings": int(nb),
                             "n_valid_points": int(pv)}
            except Exception:
                extra_dbg = {}
            self.log.emit("frame", frame_id=int(frame.frame_id),
                          t=float(frame.timestamp), state="LOST",
                          n_inliers=n_inl, is_kf=False,
                          ok_coarse=bool(ok_coarse),
                          post_correction=bool(event),
                          ref_kf=int(t.ref_kf), anchor_dt=anchor_dt,
                          **extra_dbg)
            # auto-reset only while BUILDING a young map (reference
            # src/Tracking.cc:502-510); never wipe a frozen/loaded map
            if t.n_keyframes <= 5 and not self.localization_only:
                self._in_resolve = True
                try:
                    self.reset()
                finally:
                    self._in_resolve = False
            return "lost"

        t.state = TrackState.OK
        if is_kf and self.enable_mapping and not self.localization_only:
            kf_id = int(kf_id)
            self.map = mapper.after_keyframe(
                self.map, kf_id, new_pids_np, keep_np,
                cull_ids=cull_ids_np, cull_red=cull_red_np,
                window_ids=rec.window_ids,
            )
            self._drain_culls()
            if self.enable_loop_closing:
                # DISPATCH detection only; the result is pulled on a later
                # frame so the round trip overlaps tracking
                event = self._dispatch_loop_detection(kf_id) or event
            self._dispatch_deferred_ba(kf_id)
            t.map = self.map
            # the dispatch-epoch pose: consistent with the pulled Tcw_np
            # even when a correction has since moved this keyframe (the
            # caller re-anchors to corrected poses afterwards)
            t.on_new_keyframe(kf_id, ref_pose_np=kf_Tcw_np)
            # keep the motion model alive across keyframes (the reference
            # updates mVelocity every frame, src/Tracking.cc:447-456)
            t.velocity = res.next_velocity
            t.frames_since_kf = 0
        else:
            t.velocity = res.next_velocity
            t.frames_since_kf += 1
        t.last_inliers = n_inl
        if event and not is_kf:
            # a correction refreshed the cached reference pose mid-resolve,
            # but this frame's Tcw_np is pre-correction: log its relative
            # pose against the dispatch-epoch reference pose
            corrected = t._ref_pose_np
            t._ref_pose_np = pre_ref_pose
            t._log_pose(frame, True, Tcw_np)
            t._ref_pose_np = corrected
        else:
            t._log_pose(frame, True, Tcw_np)
        self.results.append(TrackResult(Tcw_np, t.state, n_inl, is_kf))
        rec = dict(frame_id=int(frame.frame_id), t=float(frame.timestamp),
                   state="OK", n_inliers=n_inl, is_kf=is_kf)
        if is_kf:
            rec["kf_id"] = int(kf_id)
            self.log.emit("keyframe", kf_id=int(kf_id),
                          frame_id=int(frame.frame_id),
                          n_new_points=int((np.asarray(new_pids_np) >= 0).sum()))
        self.log.emit("frame", **rec)
        return "loop" if event else None

    def _drain_culls(self):
        """Re-anchor trajectory entries referencing keyframes the mapper
        just culled (to the culled KF's spanning-tree parent; reference
        export walks the tree instead, src/System.cc:377-384)."""
        for c, parent, Tcp in self.local_mapper.culled_log:
            self.tracker.remap_trajectory_ref(c, parent, Tcp)
        self.local_mapper.culled_log.clear()

    def flush(self):
        """Drain the depth-N FIFO of in-flight pipelined frames (host pull
        + bookkeeping for each, oldest first) and any pending loop
        detection. Called automatically by every introspection/export
        entry point. Events discovered while draining are routed like in
        _track_turbo: a loop correction absorbs the remaining in-flight
        frames, a LOST reprocesses them (either may enqueue fresh
        dispatches, which the loop then drains too)."""
        while self._pending:
            rec = self._pending.pop(0)
            ev = self._turbo_resolve(rec)
            if ev == "loop":
                self._absorb_pending()
            elif ev == "lost":
                self._anchor = None
                self._reprocess_stale()
        # drain the async loop-closing queue: pending detection AND every
        # queued Sim3 verification (each step consumes one pending op)
        while (
            self.loop_closer is not None
            and self.loop_closer.has_pending
        ):
            self._finalize_loop_detection()
        # run any in-flight time-sliced global BA to completion: exports
        # and saves must see the fully optimized map (the reference's
        # Shutdown waits for the GBA thread the same way)
        while self.loop_closer is not None and self.loop_closer._gba is not None:
            self._step_async_gba()
        self._anchor = None

    def _ensure_loop_closer(self, state, kf_id: int):
        """Lazy-init the vocabulary from the map's own descriptors
        (no shipped DBoW2 file; SURVEY.md §2a) + precompile warmup."""
        import jax

        from orbslam2_tpu.pipeline.loop_closing import LoopCloser
        from orbslam2_tpu.vocab import bow

        if self.loop_closer is None:
            codebook, idf = self._load_vocab_file()
            frozen = codebook is not None
            if codebook is None:
                # bootstrap vocabulary: 256 words from the first keyframe's
                # descriptors — the reservoir retrains (and grows the size
                # bucket, up to the two-level codebook) as the session sees
                # more of the scene
                codebook = bow.train_codebook(
                    state.kf_desc[kf_id], state.kf_feat_valid[kf_id],
                    jax.random.PRNGKey(self.cfg.vocab.seed),
                    vocab_size=min(256, self.cfg.vocab.vocab_size),
                    iters=self.cfg.vocab.train_iters,
                )
            self.loop_closer = LoopCloser(self.cfg, self.builder.K, codebook,
                                          log=self.log, frozen_vocab=frozen,
                                          idf=idf)
            self.loop_closer.warmup_compiles(self.cfg.orb.feature_slots, state)
            if self.cfg.vocab.warmup_correction:
                self.loop_closer.warmup_correction(state)
            if self.cfg.vocab.warmup_reloc:
                self.tracker.warmup_reloc(self.loop_closer.db)
            self._loop_key = jax.random.PRNGKey(self.cfg.seed + 7)

    def _load_vocab_file(self):
        """Load the prebuilt vocabulary + its per-word idf weights
        (reference loads ORBvoc.txt the same way, src/System.cc:65-78;
        DBoW2 stores TF_IDF word weights inside the vocabulary file).
        Returns (codebook, idf) — (None, None) when unavailable."""
        import os

        import jax.numpy as jnp

        from orbslam2_tpu.vocab import bow

        path = self.cfg.vocab.vocab_file
        if not path:
            return None, None
        if path == "builtin":
            path = os.path.join(
                os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                "data", "vocab.npz",
            )
        if not os.path.exists(path):
            return None, None
        z = np.load(path)
        idf = jnp.asarray(z["idf"]) if "idf" in z.files else None
        if "coarse" in z.files:
            return bow.Codebook(coarse=jnp.asarray(z["coarse"]),
                                fine=jnp.asarray(z["fine"])), idf
        return jnp.asarray(z["codebook"]), idf

    def _dispatch_loop_detection(self, kf_id: int) -> bool:
        """Register the keyframe with the loop DB and launch detection;
        returns True if finalizing a back-to-back pending detection fired
        a correction."""
        self._ensure_loop_closer(self.map, kf_id)
        lc = self.loop_closer
        event = False
        if lc._pending_detect is not None:
            # finalize ONLY the detection (its handles are about to be
            # replaced); an in-flight verification keeps pipelining and is
            # polled on later frames by process_async
            event = self._finalize_loop_detection(detect_only=True)
        lc.add_keyframe_to_db(self.map, kf_id)
        lc.dispatch_detect(self.map, kf_id)
        return event

    def _finalize_loop_detection(self, detect_only: bool = False) -> bool:
        """Advance the async loop-closing machinery (pending detection or
        Sim3 verification) by one step. Returns True when a loop
        correction moved the map."""
        import jax

        lc = self.loop_closer
        self._loop_key, sub = jax.random.split(self._loop_key)
        if detect_only:
            state, result = lc.finalize_detect(self.map, sub)
        else:
            state, result = lc.process_async(self.map, sub)
        self.map = state
        t = self.tracker
        t.map = state
        if result is not None and result.detected:
            self.log.emit("loop_closed", matched_kf=int(result.matched_kf),
                          num_inliers=int(result.num_inliers),
                          loops_closed=lc.loops_closed,
                          obs_truncations=lc.obs_truncations,
                          edge_truncations=lc.edge_truncations)
            # poses moved globally: re-anchor tracking and drop the motion
            # model
            self._reanchor_after_map_move()
            return True
        return False

    def _reanchor_after_map_move(self):
        """Re-anchor tracking after a global map move (loop correction or
        GBA fold-in): refresh the cached reference-keyframe pose and carry
        the last frame's pose into the corrected frame via its RELATIVE
        pose to the reference keyframe (reference src/Tracking.cc:296-310
        re-derives the frame pose from the updated reference the same
        way). Snapping last_Tcw to the reference keyframe's own pose — the
        round-4 behaviour — teleported the anchor backwards by however far
        tracking had moved past the keyframe, and with the motion model
        dropped too the next coarse search started that far off; measured
        post-correction LOST frames with 300+ local inliers."""
        t = self.tracker
        t.refresh_ref_pose()
        if t.trajectory:
            _, Tcr, ref, okf = t.trajectory[-1]
            if ref >= 0 and ref == t.ref_kf and okf:
                t.last_Tcw = jnp.asarray(Tcr @ t._ref_pose_np)
            elif t.ref_kf >= 0:
                t.last_Tcw = self.map.kf_Tcw[t.ref_kf]
        elif t.ref_kf >= 0:
            t.last_Tcw = self.map.kf_Tcw[t.ref_kf]
        # KEEP the motion model: velocity is a frame-to-frame RELATIVE
        # transform, invariant under a global map move, and composing it
        # with the re-anchored last_Tcw predicts consistently in the
        # corrected frame (the reference's mVelocity survives loop
        # corrections the same way — only LOST/reloc/init clear it).
        # Dropping it forced the next frame onto the reference-KF brute
        # match alone, which dies when the reference keyframe is near the
        # max-gap age (measured: 4 brute matches at a 15-frame / ~33
        # degree viewpoint gap -> deterministic LOST one frame after every
        # GBA fold that landed late in a keyframe interval).
        self._anchor = None

    def _dispatch_deferred_ba(self, kf_id: int):
        """Fire-and-forget local BA for a just-resolved keyframe (the fused
        keyframe program skipped it under cfg.tracking.defer_local_ba). The
        result map chains into later dispatches on device; the host never
        pulls it. Reference analogue: the LocalMapping thread's BA runs
        after tracking has already moved on (src/LocalMapping.cc:92-97)."""
        if not self.cfg.tracking.defer_local_ba:
            return
        if self.localization_only or not self.enable_mapping:
            return
        from orbslam2_tpu.pipeline import fused

        sc = self.cfg.solver
        self.map = fused.deferred_local_ba(
            self.map, jnp.int32(kf_id), self.local_mapper.inv_sigma2,
            self.tracker.K,
            max_local=sc.ba_max_local_kfs, max_fixed=sc.ba_max_fixed_kfs,
            max_points=sc.ba_max_points,
            obs_slots=min(sc.ba_max_obs_per_point, int(self.map.obs_slots)),
            iters1=sc.local_ba_iters_first, iters2=sc.local_ba_iters_second,
        )
        self.tracker.map = self.map

    def _step_async_gba(self) -> bool:
        """Dispatch one slice of an in-flight time-sliced global BA (see
        LoopCloser.start_gba_async). Returns True when the completed result
        was folded into the map — poses moved globally, so tracking
        re-anchors the same way as after a loop correction."""
        lc = self.loop_closer
        if lc is None or lc._gba is None:
            return False
        self.map, folded = lc.step_gba_async(self.map)
        if not folded:
            return False
        self.tracker.map = self.map
        self._reanchor_after_map_move()
        return True

    def track_stereo(self, left, right, timestamp: float = 0.0) -> np.ndarray:
        if self.tracker.state == TrackState.OK:
            return self._track_turbo("stereo", left, right, timestamp)
        frame = self.builder.stereo(jnp.asarray(left), jnp.asarray(right), timestamp)
        return self._track(frame)

    def track_monocular(self, image, timestamp: float = 0.0) -> np.ndarray:
        if self.tracker.state == TrackState.OK:
            return self._track_turbo("mono", image, None, timestamp)
        frame = self.builder.monocular(jnp.asarray(image), timestamp)
        return self._track(frame)

    def _track(self, frame: FrameData) -> np.ndarray:
        self.flush()
        self.tracker.map = self.map
        prior_state = self.tracker.state
        reloc_db = self.loop_closer.db if self.loop_closer is not None else None
        res = self.tracker.process(frame, reloc_db=reloc_db)
        self.map = self.tracker.map
        self._drain_culls()
        n_kf_ev = self.log.counts().get("keyframe", 0)
        self._handle_kf_request()
        self._step_async_gba()
        self.results.append(res)
        if res.is_keyframe and self.log.counts().get("keyframe", 0) == n_kf_ev:
            # keyframe(s) created inside tracker.process (initialization
            # path) rather than via the kf_request pipeline; n_new_points
            # is unknown without an extra device pull
            self.log.emit("keyframe", kf_id=self.tracker.ref_kf,
                          frame_id=int(frame.frame_id), n_new_points=-1)
        if prior_state == TrackState.LOST and res.state == TrackState.OK:
            self.log.emit("relocalized", frame_id=int(frame.frame_id),
                          n_inliers=int(res.num_inliers))
        self.log.emit("frame", frame_id=int(frame.frame_id),
                      t=float(frame.timestamp), state=res.state.name,
                      n_inliers=int(res.num_inliers), is_kf=bool(res.is_keyframe))
        # auto-reset when lost right after initialization (reference
        # src/Tracking.cc:502-510: lost with <= 5 keyframes -> full reset);
        # never wipe a frozen/loaded map in localization mode
        if (
            res.state == TrackState.LOST
            and self.tracker.n_keyframes <= 5
            and not self.localization_only
        ):
            self.reset()
        return res.Tcw

    def _handle_kf_request(self):
        if (
            self.tracker.kf_request is not None
            and self.enable_mapping
            and not self.localization_only
        ):
            kf_frame, kf_Tcw, kf_bind = self.tracker.kf_request
            self.tracker.kf_request = None
            kf_id, kf_Tcw_new, kf_bind_new, kf_Tcw_np, loop_fired = (
                self._run_keyframe_pipeline(kf_frame, kf_Tcw, kf_bind)
            )
            self.tracker.map = self.map
            self.tracker.on_new_keyframe(
                kf_id, ref_pose_np=None if loop_fired else kf_Tcw_np
            )
            # keyframe pose may have moved in BA: refresh tracker anchors and
            # drop the motion model (velocity was estimated against pre-BA
            # poses; extrapolating it against the corrected pose compounds)
            self.tracker.last_Tcw = kf_Tcw_new
            self.tracker.last_point_idx = kf_bind_new
            self.tracker.velocity = None
        else:
            self.tracker.kf_request = None

    def _run_keyframe_pipeline(self, frame, Tcw, point_idx) -> int:
        """Fused keyframe insertion + mapping + probation culling + local BA
        in one device program (the synchronous analogue of the reference's
        LocalMapping thread iteration)."""
        from orbslam2_tpu.pipeline import fused

        t = self.tracker
        cfg = self.cfg
        mapper = self.local_mapper
        sc = cfg.solver
        window = mapper.probation_window()
        run_ba = t.n_keyframes >= 2  # this insert makes the third keyframe
        state, kf_dev, new_pids, keep, kf_Tcw_new, kf_bind_new, cull_ids, cull_red = fused.keyframe_full_step(
            self.map, frame, Tcw, point_idx, window, self.builder.K, t._params,
            mapper.level_sigma2, mapper.inv_sigma2,
            scale_factor_last=float(cfg.orb.scale_factor ** (cfg.orb.num_levels - 1)),
            baseline=float(cfg.camera.baseline),
            covis_threshold=cfg.map.covis_threshold,
            n_neighbors=5,
            num_levels=cfg.orb.num_levels,
            create_close_points=cfg.sensor != Sensor.MONOCULAR,
            max_local=sc.ba_max_local_kfs, max_fixed=sc.ba_max_fixed_kfs,
            max_points=sc.ba_max_points,
            obs_slots=min(sc.ba_max_obs_per_point, int(self.map.obs_slots)),
            iters1=sc.local_ba_iters_first, iters2=sc.local_ba_iters_second,
            run_ba=run_ba,
            recycle_min_age=cfg.map.recycle_min_age_kfs,
        )
        kf_id_np, keep_np, new_pids_np, kf_Tcw_np, cull_ids_np, cull_red_np = (
            jax.device_get((kf_dev, keep, new_pids, kf_Tcw_new, cull_ids, cull_red))
        )
        kf_id = int(kf_id_np)
        state = mapper.after_keyframe(
            state, kf_id, new_pids_np, keep_np,
            cull_ids=cull_ids_np, cull_red=cull_red_np,
        )
        self._drain_culls()
        self.log.emit("keyframe", kf_id=kf_id, frame_id=int(frame.frame_id),
                      n_new_points=int((np.asarray(new_pids_np) >= 0).sum()))
        loop_fired = False
        if self.enable_loop_closing:
            n_before = (
                self.loop_closer.loops_closed if self.loop_closer is not None else 0
            )
            state = self._run_loop_closing(state, kf_id)
            loop_fired = self.loop_closer.loops_closed > n_before
        self.map = state
        return kf_id, kf_Tcw_new, kf_bind_new, kf_Tcw_np, loop_fired

    def _run_loop_closing(self, state, kf_id: int):
        """Synchronous detection/correction for this keyframe (cold path;
        the turbo path uses _dispatch_loop_detection/_finalize instead)."""
        import jax

        self._ensure_loop_closer(state, kf_id)
        while self.loop_closer.has_pending:
            # async detections/verifications from the turbo path are still
            # in flight: keep keyframe order by draining them first
            self.map = state
            self._finalize_loop_detection()
            state = self.map
        self._loop_key, sub = jax.random.split(self._loop_key)
        state, result = self.loop_closer.process_keyframe(state, kf_id, sub)
        if result is not None and result.detected:
            lc = self.loop_closer
            self.log.emit("loop_closed", matched_kf=int(result.matched_kf),
                          num_inliers=int(result.num_inliers),
                          loops_closed=lc.loops_closed,
                          obs_truncations=lc.obs_truncations,
                          edge_truncations=lc.edge_truncations)
            # poses moved globally: refresh tracker anchors
            self.tracker.map = state
            self.tracker.refresh_ref_pose()
        return state

    # -- reset (reference System::Reset src/System.cc:301-305 +
    #    Tracking::Reset src/Tracking.cc:1606-1652) -------------------------

    def reset(self):
        """Clear the map and return to NOT_INITIALIZED. The per-frame
        trajectory log survives (so evaluation/export still cover the whole
        session; the reference wipes it, src/Tracking.cc:1640-1651)."""
        if not self._in_resolve:
            self.flush()
        self.log.emit("reset", n_keyframes=self.tracker.n_keyframes)
        # do NOT clear self._pending here: when auto-reset fires from inside
        # _turbo_resolve, the caller reprocesses the still-queued in-flight
        # frames (dropping them would lose those frames' trajectory entries);
        # on an external reset, flush() above already drained the queue.
        self._anchor = None
        self._map_epoch += 1
        old_traj = self.tracker.trajectory
        self.map = ms.allocate(self.cfg.map, self.cfg.orb)
        self.tracker = Tracker(self.cfg, self.builder, self.map)
        self.tracker.trajectory = old_traj
        self.local_mapper = LocalMapper(self.cfg, self.builder.K, self.tracker.bounds)
        self.loop_closer = None
        self._loop_key = None

    def change_calibration(self, camera_cfg):
        """Swap camera intrinsics at runtime (reference
        Tracking::ChangeCalibration, src/Tracking.cc:1655-1686). The map is
        kept; per-session static parameters are rebuilt."""
        import dataclasses

        self.flush()
        self.cfg = dataclasses.replace(self.cfg, camera=camera_cfg)
        old_tracker = self.tracker
        self.builder = FrameBuilder(self.cfg)
        self.tracker = Tracker(self.cfg, self.builder, self.map)
        # carry session state over
        for attr in ("state", "velocity", "last_Tcw", "last_frame",
                     "last_point_idx", "ref_kf", "frames_since_kf",
                     "n_keyframes", "trajectory", "new_keyframe_ids",
                     "_ref_pose_np", "last_inliers"):
            setattr(self.tracker, attr, getattr(old_tracker, attr))
        self.local_mapper.K = self.builder.K

    # -- mode switches (reference src/System.cc:272-284) -------------------

    def activate_localization_mode(self):
        self.flush()
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.flush()
        self.localization_only = False

    # -- introspection (reference src/System.cc:287-305, 497-512) ----------

    def get_tracking_state(self) -> TrackState:
        self.flush()
        return self.tracker.state

    def num_keyframes(self) -> int:
        self.flush()
        # live count (slots are recycled; num_kf is the monotonic total)
        return int(jnp.sum(self.map.kf_valid))

    def get_tracked_map_points(self) -> np.ndarray:
        """Per feature slot of the current frame: the bound map-point id,
        -1 where unbound (reference System::GetTrackedMapPoints,
        include/System.h:131-135 — pointers there, stable indices into the
        map's point table here)."""
        self.flush()
        if self.tracker.last_point_idx is None:
            return np.full((self.cfg.orb.feature_slots,), -1, np.int32)
        return np.asarray(self.tracker.last_point_idx)

    def get_tracked_keypoints_un(self) -> tuple[np.ndarray, np.ndarray]:
        """(xy [S,2] undistorted keypoints of the current frame, valid [S])
        (reference System::GetTrackedKeyPointsUn, include/System.h:134)."""
        self.flush()
        lf = self.tracker.last_frame
        if lf is None:
            S = self.cfg.orb.feature_slots
            return np.zeros((S, 2), np.float32), np.zeros((S,), bool)
        return np.asarray(lf.xy), np.asarray(lf.valid)

    def num_points(self) -> int:
        self.flush()
        return int(jnp.sum(self.map.mp_valid))

    def frame_poses(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(timestamps [N], poses_cw [N,4,4], tracked [N]) with each frame's
        pose re-anchored to its reference keyframe's FINAL pose."""
        self.flush()
        kf_poses = np.asarray(self.map.kf_Tcw)
        ts, poses, tracked = [], [], []
        for t, Tcr, ref, ok in self.tracker.trajectory:
            if ref >= 0:
                Tcw = Tcr @ kf_poses[ref]
            else:
                Tcw = Tcr
            ts.append(t)
            poses.append(Tcw)
            tracked.append(ok)
        return np.asarray(ts), np.stack(poses), np.asarray(tracked)

    # -- export (reference src/System.cc:331-493) --------------------------

    def save_trajectory_tum(self, path: str):
        ts, poses, tracked = self.frame_poses()
        traj_io.save_tum(path, ts[tracked], poses[tracked])

    def save_trajectory_kitti(self, path: str):
        _, poses, _ = self.frame_poses()
        traj_io.save_kitti(path, poses)

    def save_keyframe_trajectory_tum(self, path: str):
        valid = np.asarray(self.map.kf_valid)
        poses = np.asarray(self.map.kf_Tcw)[valid]
        fids = np.asarray(self.map.kf_frame_id)[valid]
        traj_io.save_tum(path, fids.astype(np.float64), poses)

    # -- map persistence (the reference declares SaveMap/LoadMap as TODO,
    #    include/System.h:127-129 — implemented here as parity-plus) -------

    def save_map(self, path: str):
        """Serialize the full map pytree (+ BoW database if present)."""
        self.flush()
        payload = {f"map_{k}": np.asarray(v) for k, v in self.map._asdict().items()}
        if self.loop_closer is not None:
            from orbslam2_tpu.vocab import bow as bow_mod

            payload["db_vectors"] = np.asarray(self.loop_closer.db.vectors)
            payload["db_present"] = np.asarray(self.loop_closer.db.present)
            cb = self.loop_closer.codebook
            if isinstance(cb, bow_mod.Codebook):
                payload["codebook_coarse"] = np.asarray(cb.coarse)
                payload["codebook_fine"] = np.asarray(cb.fine)
            else:
                payload["codebook"] = np.asarray(cb)
            if self.loop_closer.idf is not None:
                payload["idf"] = np.asarray(self.loop_closer.idf)
        np.savez_compressed(path, **payload)

    def load_map(self, path: str):
        self.flush()
        import jax.numpy as jnp

        from orbslam2_tpu.pipeline.loop_closing import LoopCloser

        z = np.load(path)
        self._map_epoch += 1
        fields = {k[4:]: jnp.asarray(z[k]) for k in z.files if k.startswith("map_")}
        self.map = ms.MapState(**fields)
        self.tracker.map = self.map
        self.tracker.n_keyframes = int(jnp.sum(self.map.kf_valid))
        self.local_mapper.live_kfs = self.tracker.n_keyframes
        if "codebook" in z.files or "codebook_coarse" in z.files:
            from orbslam2_tpu.vocab import bow as bow_mod

            if "codebook_coarse" in z.files:
                cb = bow_mod.Codebook(
                    coarse=jnp.asarray(z["codebook_coarse"]),
                    fine=jnp.asarray(z["codebook_fine"]),
                )
            else:
                cb = jnp.asarray(z["codebook"])
            idf = jnp.asarray(z["idf"]) if "idf" in z.files else None
            self.loop_closer = LoopCloser(self.cfg, self.builder.K, cb,
                                          log=self.log, frozen_vocab=True,
                                          idf=idf)
            self.loop_closer.db.vectors = jnp.asarray(z["db_vectors"])
            self.loop_closer.db.present = jnp.asarray(z["db_present"])
            import jax

            self._loop_key = jax.random.PRNGKey(self.cfg.seed + 7)

    def shutdown(self):
        self.flush()
