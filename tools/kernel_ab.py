"""On-card A/B of the hand-written kernels against what XLA makes of the
plain versions, at the shapes the SLAM frame program uses.

Phases (all by default; name some to run only those):

* ``pose``    — per-call time of the Triton-route pose-GN kernel
  (solvers/pallas_pose_opt.py) at several warp counts against
  ``pose_opt.pose_optimize``, for the frame program's schedules and for
  the chain of the three the frame runs (2x6, 3x6, 4x6), with parity.
* ``frame``   — steady per-frame time of the RGB-D bench frame program
  (bench.rgbd_config) with the pose-GN kernel and with the plain path, in
  turns (kernel, plain, plain, kernel), each pose pulled to the host.
* ``orbit``   — the 320x240 orbit + revisit of ``chip_smoke.py`` (d) with
  the plain path and with the kernel: loops closed, lost frames and ATE.

Needs a GPU. Prints the card's name and power limit, then one JSON line per
measurement. Usage: ``python tools/kernel_ab.py [pose] [frame] [orbit]``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from functools import partial

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def _emit(**rec):
    print(json.dumps(rec), flush=True)


def _time_call(jax, fn, *args, reps=50, samples=5):
    """(latency_us, throughput_us): median of `reps` blocked calls, and the
    median over `samples` of `reps` back-to-back calls divided by reps."""
    jax.block_until_ready(fn(*args))
    lat = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        lat.append(time.perf_counter() - t0)
    thr = []
    for _ in range(samples):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        thr.append((time.perf_counter() - t0) / reps)
    return float(np.median(lat)) * 1e6, float(np.median(thr)) * 1e6


# ---------------------------------------------------------------------------
# pose GN
# ---------------------------------------------------------------------------


def phase_pose(jax):
    import jax.numpy as jnp

    from orbslam2_tpu.config import CameraConfig
    from orbslam2_tpu.geometry import se3
    from orbslam2_tpu.geometry.camera import Intrinsics
    from orbslam2_tpu.io.synthetic import pose_problem
    from orbslam2_tpu.solvers import pallas_pose_opt, pose_opt
    from orbslam2_tpu.solvers.pallas_pose_opt import pose_optimize_pallas

    K = Intrinsics.from_config(
        CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0))
    T0 = se3.identity()
    default_warps = pallas_pose_opt.default_num_warps
    for n in (1024, 2048):
        _, obs = pose_problem(np.random.default_rng(0), n=n, n_real=700 * n // 1024)
        for rounds, iters in ((2, 6), (3, 6), (4, 6), (4, 10)):
            plain = jax.jit(partial(pose_opt.pose_optimize, K=K, rounds=rounds,
                                    iters=iters))
            ref = plain(T0, obs)
            lat, thr = _time_call(jax, plain, T0, obs)
            _emit(phase="pose", n=n, schedule=f"{rounds}x{iters}",
                  path="xla_plain", latency_us=lat, throughput_us=thr)
            for warps in (4, 8, 16):
                # the wrapper takes its warp count from default_num_warps
                jax.clear_caches()
                pallas_pose_opt.default_num_warps = lambda n_pad, w=warps: w
                ker = jax.jit(partial(pose_optimize_pallas, K=K, rounds=rounds,
                                      iters=iters))
                got = ker(T0, obs)
                lat, thr = _time_call(jax, ker, T0, obs)
                _emit(phase="pose", n=n, schedule=f"{rounds}x{iters}",
                      path=f"triton_w{warps}", latency_us=lat,
                      throughput_us=thr,
                      max_abs_dT=float(jnp.max(jnp.abs(got.Tcw - ref.Tcw))),
                      inliers_equal=bool(jnp.array_equal(got.inliers,
                                                          ref.inliers)))

    pallas_pose_opt.default_num_warps = default_warps

    # the three schedules one frame runs, chained (2x6 -> 3x6 -> 4x6)
    _, obs = pose_problem(np.random.default_rng(0))

    def chain(solve, T, o):
        for rounds, iters in ((2, 6), (3, 6), (4, 6)):
            T = solve(T, o, K, rounds=rounds, iters=iters).Tcw
        return T

    for name, solve in (("xla_plain", pose_opt.pose_optimize),
                        ("triton", pose_optimize_pallas)):
        jax.clear_caches()
        f = jax.jit(partial(chain, solve))
        lat, thr = _time_call(jax, f, T0, obs)
        _emit(phase="pose", n=1024, schedule="frame_chain_2x6+3x6+4x6",
              path=name, latency_us=lat, throughput_us=thr)


# ---------------------------------------------------------------------------
# frame program
# ---------------------------------------------------------------------------


def _use_pose_path(jax, name):
    """Point the frame program's pose solver at the kernel ("triton") or
    the plain jnp version ("xla_plain"), and drop compiled programs."""
    from orbslam2_tpu.pipeline import fused
    from orbslam2_tpu.solvers import pose_opt
    from orbslam2_tpu.solvers.pallas_pose_opt import pose_optimize_fast

    fused.pose_optimize_fast = {"triton": pose_optimize_fast,
                                "xla_plain": pose_opt.pose_optimize}[name]
    jax.clear_caches()


def phase_frame(jax):
    import dataclasses

    import bench
    from orbslam2_tpu.config import VocabConfig
    from orbslam2_tpu.io import synthetic
    from orbslam2_tpu.pipeline.system import System

    cfg = dataclasses.replace(bench.rgbd_config(), vocab=VocabConfig())
    n, warm = 48, 8
    seq = synthetic.textured_sequence(n_frames=n, kind="forward", cam=cfg.camera)
    imgs = jax.device_put(np.stack([seq.frame(i)[0] for i in range(n)]))
    deps = jax.device_put(np.stack([seq.frame(i)[1] for i in range(n)]))

    for name in ("triton", "xla_plain", "xla_plain", "triton"):
        _use_pose_path(jax, name)
        t0 = time.perf_counter()
        slam = System(cfg, enable_loop_closing=False)
        wall = []
        for i in range(n):
            t1 = time.perf_counter()
            np.asarray(slam.track_rgbd(imgs[i], deps[i], timestamp=i / 30.0))
            wall.append(time.perf_counter() - t1)
        slam.flush()
        total = time.perf_counter() - t0
        _, _, tracked = slam.frame_poses()
        steady = np.asarray(wall[warm:]) * 1e3
        _emit(phase="frame", path=name, frames=n - warm,
              median_ms=float(np.median(steady)),
              p90_ms=float(np.percentile(steady, 90)),
              first_frame_s=wall[0], total_s=total,
              lost=int((~tracked).sum()), keyframes=slam.num_keyframes())
    _use_pose_path(jax, "triton")


def phase_orbit(jax):
    import chip_smoke

    for name in ("xla_plain", "triton"):
        _use_pose_path(jax, name)
        _emit(phase="orbit", path=name, **chip_smoke.run_orbit())
    _use_pose_path(jax, "triton")


def main():
    import jax

    from orbslam2_tpu.utils import compile_cache, device

    if jax.default_backend() != "gpu":
        raise SystemExit("kernel_ab needs a GPU")
    compile_cache.enable()
    jax.config.update("jax_default_matmul_precision", "highest")
    print(device.gpu_name_and_power_limit(), flush=True)
    _emit(device=device.device_info())
    phases = sys.argv[1:] or ["pose", "frame"]
    for ph in phases:
        {"pose": phase_pose, "frame": phase_frame, "orbit": phase_orbit}[ph](jax)


if __name__ == "__main__":
    main()
