"""Diagnostic driver for the orbit loop-closure e2e (tests/test_loop_reloc.py
::test_orbit_loop_closes config): prints loops_closed, lost frames, ATE and
the loop-related event trail. CPU: JAX_PLATFORMS=cpu python tools/orbit_diag.py
"""
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main():
    from orbslam2_tpu.utils import compile_cache

    compile_cache.enable()

    from orbslam2_tpu.config import (CameraConfig, MapConfig, OrbConfig,
                                     SlamConfig, Sensor, SolverConfig,
                                     TrackingConfig)
    from orbslam2_tpu.io import synthetic
    from orbslam2_tpu.pipeline.system import System
    from orbslam2_tpu.utils.evaluation import ate_rmse

    cfg = SlamConfig(
        sensor=Sensor.RGBD,
        camera=CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, bf=24.0,
                            fps=30.0, width=320, height=240),
        orb=OrbConfig(num_features=400, feature_slots=512, candidates_per_level=1024),
        map=MapConfig(max_keyframes=96, max_points=16384, max_local_points=4096),
        tracking=TrackingConfig(
            th_depth=130.0,
            pipeline_depth=(2 if "--pipeline2" in sys.argv else
                            0 if "--no-pipeline" in sys.argv else 0),
        ),
        solver=(SolverConfig(ba_max_points=16384)
                if "--full-ba" in sys.argv else SolverConfig()),
    )
    seq = synthetic.textured_sequence(n_frames=170, kind="orbit", cam=cfg.camera)
    seq = dataclasses.replace(seq, poses=np.concatenate([seq.poses, seq.poses[:35]]))
    slam = System(cfg, enable_loop_closing="--no-loop" not in sys.argv)
    for i in range(len(seq)):
        img, depth = seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)
    slam.flush()
    ts, poses, tracked = slam.frame_poses()
    loops = slam.loop_closer.loops_closed if slam.loop_closer else 0
    rmse = float(ate_rmse(poses, seq.poses, align=True))
    lost = int((~tracked).sum())
    print(json.dumps({"loops_closed": loops, "lost": lost, "ate": round(rmse, 4)}))
    for e in slam.log.events:
        if (str(e.get("event", "")).startswith(
                ("loop", "gba", "reloc", "warn", "reanchor"))
                or e.get("state") in ("LOST",)
                or (e.get("event") == "frame" and int(e.get("frame_id", 0)) >= 160)):
            rec = {k: (v.tolist() if hasattr(v, "tolist") else v) for k, v in e.items()}
            print(json.dumps(rec))


if __name__ == "__main__":
    main()
