"""Command-line runner — the driver app the reference fork lacks (upstream
ORB-SLAM2's Examples/ equivalents).

Usage:
    python -m orbslam2_tpu.run --dataset tum --root /data/fr1_xyz \\
        --settings tum1.yaml --out traj.txt
    python -m orbslam2_tpu.run --dataset synthetic --frames 40 --sensor rgbd
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="ORB-SLAM2-class visual SLAM in JAX")
    ap.add_argument("--dataset", choices=["tum", "kitti", "euroc", "synthetic"],
                    required=True)
    ap.add_argument("--root", help="dataset root directory")
    ap.add_argument("--settings", help="ORB-SLAM2-style YAML settings file")
    ap.add_argument("--sensor", choices=["mono", "stereo", "rgbd"], default=None)
    ap.add_argument("--out", default="trajectory.txt", help="TUM-format output")
    ap.add_argument("--kf-out", default=None, help="keyframe trajectory output")
    ap.add_argument("--kitti-out", default=None, help="KITTI-format output")
    ap.add_argument("--save-map", default=None)
    ap.add_argument("--viz", default=None, help="directory for PNG snapshots")
    ap.add_argument("--frames", type=int, default=0, help="limit frame count")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--log", default=None,
                    help="stream per-frame events as JSONL to this file")
    args = ap.parse_args(argv)

    import numpy as np

    from orbslam2_tpu.config import SlamConfig, Sensor, load_yaml_settings
    from orbslam2_tpu.pipeline.system import System

    sensor_map = {"mono": Sensor.MONOCULAR, "stereo": Sensor.STEREO, "rgbd": Sensor.RGBD}
    default_sensor = {"tum": "rgbd", "kitti": "stereo", "euroc": "stereo",
                      "synthetic": "rgbd"}[args.dataset]
    sensor = sensor_map[args.sensor or default_sensor]

    if args.settings:
        cfg = load_yaml_settings(args.settings, sensor)
    else:
        cfg = SlamConfig(sensor=sensor)

    # build the frame source
    if args.dataset == "synthetic":
        from orbslam2_tpu.config import CameraConfig, TrackingConfig
        import dataclasses

        cfg = dataclasses.replace(
            cfg,
            camera=CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=240.0),
            tracking=TrackingConfig(th_depth=100.0),
        )
        from orbslam2_tpu.io import synthetic

        n = args.frames or 40
        seq = synthetic.default_sequence(n_frames=n, kind="forward", cam=cfg.camera)

        def frames():
            for i in range(n):
                img, depth = seq.frame(i)
                yield ("rgbd", img, depth, i / 30.0)
    elif args.dataset == "tum":
        import dataclasses

        from orbslam2_tpu.io.datasets import TumRgbdDataset

        # DepthMapFactor is applied exactly once (reference src/Tracking.cc:
        # 128-133): the dataset converts raw uint16 counts to meters, so the
        # pipeline must see factor 1.0 — not divide a second time.
        ds = TumRgbdDataset(args.root, depth_factor=cfg.tracking.depth_map_factor or 5000.0)
        cfg = dataclasses.replace(
            cfg, tracking=dataclasses.replace(cfg.tracking, depth_map_factor=1.0)
        )
        n = min(len(ds), args.frames) if args.frames else len(ds)

        def frames():
            for i in range(n):
                img, depth, t = ds[i]
                yield ("rgbd", img, depth, t)
    elif args.dataset == "kitti":
        from orbslam2_tpu.io.datasets import KittiOdometryDataset

        ds = KittiOdometryDataset(args.root)
        n = min(len(ds), args.frames) if args.frames else len(ds)

        def frames():
            for i in range(n):
                left, right, t = ds[i]
                yield ("stereo", left, right, t)
    else:
        from orbslam2_tpu.io.datasets import EurocDataset

        ds = EurocDataset(args.root)
        n = min(len(ds), args.frames) if args.frames else len(ds)

        def frames():
            for i in range(n):
                left, right, t = ds[i]
                yield ("stereo", left, right, t)

    slam = System(cfg, enable_loop_closing=not args.no_loop, log_path=args.log)
    viewer = None
    if args.viz:
        from orbslam2_tpu.viz.drawers import Viewer

        viewer = Viewer(cfg, args.viz)

    t0 = time.perf_counter()
    count = 0
    for kind, a, b, ts in frames():
        if kind == "rgbd":
            slam.track_rgbd(a, b, timestamp=ts)
        elif kind == "stereo":
            slam.track_stereo(a, b, timestamp=ts)
        else:
            slam.track_monocular(a, timestamp=ts)
        if viewer is not None:
            tracked = (
                np.asarray(slam.tracker.last_point_idx) >= 0
                if slam.tracker.last_point_idx is not None
                else np.zeros(1, bool)
            )
            xy = (
                np.asarray(slam.tracker.last_frame.xy)
                if slam.tracker.last_frame is not None
                else np.zeros((1, 2))
            )
            viewer.update(slam, a, xy, tracked)
        count += 1
        if count % 25 == 0:
            print(f"frame {count}/{n} state={slam.get_tracking_state().name} "
                  f"kfs={slam.num_keyframes()} pts={slam.num_points()}",
                  file=sys.stderr)
    dt = time.perf_counter() - t0

    slam.save_trajectory_tum(args.out)
    if args.kf_out:
        slam.save_keyframe_trajectory_tum(args.kf_out)
    if args.kitti_out:
        slam.save_trajectory_kitti(args.kitti_out)
    if args.save_map:
        slam.save_map(args.save_map)
    print(json.dumps({
        "frames": count,
        "fps": round(count / dt, 2),
        "state": slam.get_tracking_state().name,
        "keyframes": slam.num_keyframes(),
        "points": slam.num_points(),
        "loops_closed": slam.loop_closer.loops_closed if slam.loop_closer else 0,
        "events": slam.log.counts(),
        "trajectory": args.out,
    }))
    slam.log.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
