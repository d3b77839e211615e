"""Quantify loop-candidate precision/recall against ground truth (round-4
verdict item 9: consistency-accepted FALSE candidates mid-orbit were
observed but never measured).

Runs the bench orbit+revisit, then scores every `loop_detect` event's
candidates against the ground-truth camera positions: a candidate is TRUE
when the proposing keyframe and the candidate keyframe were captured
within `true_radius` metres of each other (and outside the recent-
exclusion window, which the detector already enforces). Reports
candidate-level and accepted-level precision, plus revisit recall.

CPU: JAX_PLATFORMS=cpu python tools/vocab_precision.py
"""
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

TRUE_RADIUS = 1.0  # m between camera centres for a "true" revisit pair


def main():
    from orbslam2_tpu.utils import compile_cache

    compile_cache.enable()

    from orbslam2_tpu.config import (CameraConfig, MapConfig, OrbConfig,
                                     SlamConfig, Sensor, TrackingConfig)
    from orbslam2_tpu.io import synthetic
    from orbslam2_tpu.pipeline.system import System

    cfg = SlamConfig(
        sensor=Sensor.RGBD,
        camera=CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, bf=24.0,
                            fps=30.0, width=320, height=240),
        orb=OrbConfig(num_features=400, feature_slots=512, candidates_per_level=1024),
        map=MapConfig(max_keyframes=96, max_points=16384, max_local_points=4096),
        tracking=TrackingConfig(th_depth=130.0),
    )
    seq = synthetic.textured_sequence(n_frames=170, kind="orbit", cam=cfg.camera)
    seq = dataclasses.replace(seq, poses=np.concatenate([seq.poses, seq.poses[:35]]))
    slam = System(cfg)
    for i in range(len(seq)):
        img, depth = seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)
    slam.flush()

    # keyframe slot -> latest source frame id (slots recycle: latest wins)
    kf_frame: dict[int, int] = {}
    events = slam.log.events
    for e in events:
        if e.get("event") == "keyframe":
            kf_frame[int(e["kf_id"])] = int(e["frame_id"])

    def centre(fid):
        T = seq.poses[fid]  # ground-truth Tcw
        R, t = T[:3, :3], T[:3, 3]
        return -R.T @ t

    n_cand = n_cand_true = n_acc = n_acc_true = 0
    revisit_frames_with_true_cand = set()
    detect_frames = set()
    for e in events:
        if e.get("event") != "loop_detect":
            continue
        kf = int(e["kf_id"])
        if kf not in kf_frame:
            continue
        fid = kf_frame[kf]
        detect_frames.add(fid)
        c0 = centre(fid)
        accepted_n = int(e["n_accepted"])
        for rank, c in enumerate(e["cands"]):
            c = int(c)
            if c not in kf_frame:
                continue
            d = float(np.linalg.norm(centre(kf_frame[c]) - c0))
            true = d < TRUE_RADIUS
            n_cand += 1
            n_cand_true += true
            if true and fid >= 170:
                revisit_frames_with_true_cand.add(fid)
            # accepted candidates are listed first (ordered by score)
            if rank < accepted_n:
                n_acc += 1
                n_acc_true += true
    revisit_detects = [f for f in detect_frames if f >= 170]
    out = {
        "metric": "loop_candidate_precision",
        "value": round(n_cand_true / n_cand, 3) if n_cand else None,
        "unit": "fraction",
        "vs_baseline": None,
        "extra": {
            "n_candidates": n_cand,
            "n_true": n_cand_true,
            "accepted_precision": round(n_acc_true / n_acc, 3) if n_acc else None,
            "n_accepted": n_acc,
            "revisit_detections": len(revisit_detects),
            "revisit_detections_with_true_candidate": len(revisit_frames_with_true_cand),
            "loops_closed": slam.loop_closer.loops_closed if slam.loop_closer else 0,
            "true_radius_m": TRUE_RADIUS,
        },
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
