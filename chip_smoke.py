"""GPU smoke check: drives the SLAM main path once on one card.

    python chip_smoke.py               # phases (a)-(f) on one GPU
    python chip_smoke.py --four-cards  # only the sharded solvers, 4 GPUs

Phases (each raises on failure; nothing is caught):

(a) device   — JAX must run on a GPU; prints the device kind and count and
               the card's name and power limit from nvidia-smi.
(b) kernels  — the pose-GN path the frame program uses against the plain
               `pose_opt.pose_optimize` at N = 1024 and 2048 for the four
               schedules (pose within 5e-5, identical inliers), and the
               Hamming distance the matcher uses against a numpy bit count
               at 4096x1024 and 1024x1024 (exact).
(c) rgbd     — the RGB-D bench configuration (bench.rgbd_config: 640x480,
               1000 features in 1024 slots, 96 keyframes, 16384 points),
               48 forward frames through System.track_rgbd: 0 lost and
               ATE <= 0.005 m. Prints the median time per frame until its
               pose is on the host, and the frame program's memory use.
(d) orbit    — full orbit + revisit at 320x240 with loop-correction and
               relocalization warm-up: the run ends and every pose is
               finite. Prints loops closed, lost frames and ATE.
(e) sensors  — 24 stereo frames (none lost) and 24 monocular frames
               (initializes; at most 4 untracked) with the bench configs,
               loop closing off.
(f) cli      — `orbslam2_tpu.run.main` on 14 synthetic frames returns 0
               with state OK.

`--four-cards` runs only the sharded global BA (C=512 cameras, 12288
points per card, 8 observations per point), the sharded pose graph and the
sharded BoW query on a 4-GPU mesh, each against the same problem on one
device, with full-f32 matmuls as `System` pins them: BA cost, raw and
relative poses and points within 1e-3, pose graph within 1e-3, BoW
candidates identical.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Exits non-zero, printing no result, when JAX finds no GPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

POSE_SCHEDULES = ((4, 10), (2, 6), (3, 6), (4, 6))


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


# ---------------------------------------------------------------------------
# (a) device
# ---------------------------------------------------------------------------


def phase_device(n_cards: int) -> dict:
    import jax

    from orbslam2_tpu.utils import device

    backend = jax.default_backend()
    check(backend == "gpu", f"JAX backend is {backend!r}, not 'gpu'")
    info = device.device_info()
    check(info["count"] >= n_cards,
          f"{info['count']} GPU(s) visible, {n_cards} needed")
    log(f"(a) device: kind={info['kind']} count={info['count']}")
    log(f"(a) nvidia-smi: {device.gpu_name_and_power_limit()}")
    return info


# ---------------------------------------------------------------------------
# (b) kernels at real widths
# ---------------------------------------------------------------------------


def phase_kernels() -> None:
    import jax
    import jax.numpy as jnp

    from orbslam2_tpu.config import CameraConfig
    from orbslam2_tpu.geometry import se3
    from orbslam2_tpu.geometry.camera import Intrinsics
    from orbslam2_tpu.io.synthetic import pose_problem
    from orbslam2_tpu.ops import hamming
    from orbslam2_tpu.solvers import pose_opt
    from orbslam2_tpu.solvers.pallas_pose_opt import pose_optimize_fast

    K = Intrinsics.from_config(
        CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0))
    # a small motion from the identity, and a camera far from the world
    # origin (3.6 m, ~70 degrees) started near its true pose
    far = [2.0, -0.5, 3.0, 0.3, 1.2, -0.2]
    nudge = se3.exp_se3(jnp.asarray([0.05, -0.03, 0.04, 0.01, -0.02, 0.015],
                                    jnp.float32))
    with jax.default_matmul_precision("highest"):
        for n in (1024, 2048):
            for start, xi in (("identity", None), ("far", far)):
                T_true, obs = pose_problem(np.random.default_rng(0), n=n,
                                           n_real=700 * n // 1024, xi_true=xi)
                T0 = se3.identity() if xi is None else nudge @ T_true
                for rounds, iters in POSE_SCHEDULES:
                    ref = pose_opt.pose_optimize(T0, obs, K, rounds=rounds,
                                                 iters=iters)
                    got = pose_optimize_fast(T0, obs, K, rounds=rounds,
                                             iters=iters)
                    dT = float(jnp.max(jnp.abs(got.Tcw - ref.Tcw)))
                    same = bool(jnp.array_equal(got.inliers, ref.inliers))
                    log(f"(b) pose GN N={n} {start} {rounds}x{iters}: "
                        f"max|dT|={dT:.3g} inliers "
                        f"{int(got.num_inliers)}/{int(ref.num_inliers)} "
                        f"identical={same}")
                    check(dT <= 5e-5 and same,
                          f"pose GN N={n} {start} {rounds}x{iters} disagrees")

    rng = np.random.default_rng(1)
    for n, m in ((4096, 1024), (1024, 1024)):
        a = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
        b = rng.integers(0, 2**32, (m, 8), dtype=np.uint32)
        want = np.unpackbits(
            np.bitwise_xor(a[:, None, :], b[None, :, :]).view(np.uint8),
            axis=-1).sum(-1)
        got = np.asarray(hamming.distance_matrix(a, b))
        same = np.array_equal(got, want)
        log(f"(b) hamming {n}x{m}: exact={same}")
        check(same, f"hamming {n}x{m} differs from numpy")


# ---------------------------------------------------------------------------
# (c)-(e) System main path
# ---------------------------------------------------------------------------


def _ate(slam, seq, with_scale=False):
    from orbslam2_tpu.utils.evaluation import ate_rmse

    _, poses, tracked = slam.frame_poses()
    ate = (ate_rmse(poses[tracked], seq.poses[tracked], align=True,
                    with_scale=with_scale)
           if tracked.any() else float("nan"))
    return poses, tracked, float(ate)


def _spy_frame_program():
    """Record the frame program's argument shapes on its first call so its
    compiled memory use can be printed afterwards."""
    import jax

    from orbslam2_tpu.pipeline import fused

    orig = fused.frame_and_keyframe_step
    seen = {}

    def spec(x):
        if isinstance(x, jax.Array):
            return jax.ShapeDtypeStruct(x.shape, x.dtype,
                                        weak_type=x.weak_type)
        return x

    def spy(*args, **kwargs):
        if not seen:
            seen["args"] = jax.tree.map(spec, (args, kwargs))
        return orig(*args, **kwargs)

    fused.frame_and_keyframe_step = spy

    def report():
        fused.frame_and_keyframe_step = orig
        args, kwargs = seen["args"]
        return orig.lower(*args, **kwargs).compile().memory_analysis()

    return report


def phase_rgbd() -> None:
    import jax

    import bench
    from orbslam2_tpu.io import synthetic
    from orbslam2_tpu.pipeline.system import System

    cfg = bench.rgbd_config()
    n, warm = 48, 8
    seq = synthetic.textured_sequence(n_frames=n, kind="forward", cam=cfg.camera)
    imgs = jax.device_put(np.stack([seq.frame(i)[0] for i in range(n)]))
    deps = jax.device_put(np.stack([seq.frame(i)[1] for i in range(n)]))
    report = _spy_frame_program()
    t0 = time.perf_counter()
    slam = System(cfg)
    log(f"(c) rgbd: System start-up {time.perf_counter() - t0:.1f} s")
    wall = []
    for i in range(n):
        t1 = time.perf_counter()
        np.asarray(slam.track_rgbd(imgs[i], deps[i], timestamp=i / 30.0))
        wall.append(time.perf_counter() - t1)
    _, tracked, ate = _ate(slam, seq)
    lost = int((~tracked).sum())
    log(f"(c) rgbd: {n} frames lost={lost} ATE={ate:.5f} m "
        f"keyframes={slam.num_keyframes()} points={slam.num_points()} "
        f"first frame {wall[0]:.1f} s, median frame-to-pose "
        f"{np.median(wall[warm:]) * 1e3:.2f} ms over {n - warm} frames")
    log(f"(c) rgbd: frame program memory: {report()}")
    check(lost == 0, f"rgbd lost {lost} frames")
    check(ate <= 0.005, f"rgbd ATE {ate} > 0.005")


def orbit_config():
    """The 320x240 orbit + revisit configuration with loop-correction and
    relocalization programs compiled at start-up."""
    from orbslam2_tpu.config import (
        CameraConfig, MapConfig, OrbConfig, SlamConfig, Sensor,
        TrackingConfig, VocabConfig,
    )

    return SlamConfig(
        sensor=Sensor.RGBD,
        camera=CameraConfig(fx=240.0, fy=240.0, cx=159.5, cy=119.5, bf=24.0,
                            fps=30.0, width=320, height=240),
        orb=OrbConfig(num_features=400, feature_slots=512,
                      candidates_per_level=1024),
        map=MapConfig(max_keyframes=96, max_points=16384,
                      max_local_points=4096),
        tracking=TrackingConfig(th_depth=130.0),
        vocab=VocabConfig(warmup_correction=True, warmup_reloc=True),
    )


def run_orbit() -> dict:
    """Orbit (170 frames) + 35 revisit frames; returns loops/lost/ATE."""
    from orbslam2_tpu.io import synthetic
    from orbslam2_tpu.pipeline.system import System

    cfg = orbit_config()
    n_orbit, n_rev = 170, 35
    seq = synthetic.textured_sequence(n_frames=n_orbit, kind="orbit",
                                      cam=cfg.camera)
    seq = dataclasses.replace(
        seq, poses=np.concatenate([seq.poses, seq.poses[:n_rev]]))
    slam = System(cfg)
    for i in range(n_orbit + n_rev):
        img, depth = seq.frame(i)
        slam.track_rgbd(img, depth, timestamp=i / 30.0)
    poses, tracked, ate = _ate(slam, seq)
    return {
        "frames": n_orbit + n_rev,
        "loops": slam.loop_closer.loops_closed if slam.loop_closer else 0,
        "lost": int((~tracked).sum()),
        "ate_m": ate,
        "finite": bool(np.isfinite(poses).all()),
    }


def phase_orbit() -> None:
    r = run_orbit()
    log(f"(d) orbit: {r}")
    check(r["finite"], "orbit produced non-finite poses")


def phase_sensors() -> None:
    import bench
    from orbslam2_tpu.io import synthetic
    from orbslam2_tpu.pipeline.system import System
    from orbslam2_tpu.pipeline.tracking import TrackState

    base = bench.rgbd_config()
    n = 24
    # loop closing off: (c) and (d) already compile and run the loop and
    # relocalization programs, and the smoke must stay inside its time limit
    cfg = bench.stereo_config(base)
    seq = synthetic.textured_sequence(n_frames=n, kind="forward", cam=cfg.camera)
    slam = System(cfg, enable_loop_closing=False)
    for i in range(n):
        left, right, _ = seq.stereo(i)
        slam.track_stereo(left, right, timestamp=i / 30.0)
    _, tracked, ate = _ate(slam, seq)
    lost = int((~tracked).sum())
    log(f"(e) stereo: {n} frames lost={lost} ATE={ate:.5f} m")
    check(lost == 0, f"stereo lost {lost} frames")

    cfg = bench.mono_config(base)
    seq = synthetic.textured_sequence(n_frames=n, kind="lateral", cam=cfg.camera)
    slam = System(cfg, enable_loop_closing=False)
    for i in range(n):
        img, _ = seq.frame(i)
        slam.track_monocular(img, timestamp=i / 30.0)
    state = slam.get_tracking_state()
    _, tracked, ate = _ate(slam, seq, with_scale=True)
    untracked = int((~tracked).sum())
    log(f"(e) mono: {n} frames state={state.name} untracked={untracked} "
        f"ATE(sim3)={ate:.5f} m keyframes={slam.num_keyframes()}")
    check(state == TrackState.OK, f"mono ended in state {state.name}")
    check(untracked <= 4, f"mono left {untracked} frames untracked")


def phase_cli() -> None:
    from orbslam2_tpu import run

    with tempfile.TemporaryDirectory() as tmp:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = run.main(["--dataset", "synthetic", "--frames", "14",
                           "--out", os.path.join(tmp, "traj.txt"),
                           "--save-map", os.path.join(tmp, "map.npz")])
        rec = json.loads(out.getvalue().strip().splitlines()[-1])
        log(f"(f) cli: rc={rc} {rec}")
        check(rc == 0 and rec["state"] == "OK", "CLI run failed")
        check(os.path.getsize(os.path.join(tmp, "traj.txt")) > 0,
              "CLI wrote no trajectory")


# ---------------------------------------------------------------------------
# --four-cards: sharded solvers on a 4-GPU mesh against one device
# ---------------------------------------------------------------------------


def ba_problem(C=512, P=12288 * 4, O=8, seed=0):
    """A KITTI-like strip: C cameras 0.3 m apart along x, looking +z with
    small rotations; each point is observed by the O cameras nearest to it
    along the strip, so every camera is constrained (a camera with no
    observation would leave the reduced system singular)."""
    import jax.numpy as jnp

    from orbslam2_tpu.geometry import se3
    from orbslam2_tpu.solvers import ba

    rng = np.random.default_rng(seed)
    cx = 0.3 * np.arange(C)
    twists = np.c_[-cx, np.zeros((C, 2)), rng.normal(0, 0.01, (C, 3))]
    cams = np.stack([np.asarray(se3.exp_se3(jnp.asarray(tw, jnp.float32)))
                     for tw in twists])
    pts = np.c_[rng.uniform(-1, cx[-1] + 1, P), rng.uniform(-2, 2, P),
                rng.uniform(5, 12, P)].astype(np.float32)
    obs_cam = np.argsort(np.abs(pts[:, :1] - cx[None, :]), axis=1)[:, :O]
    obs_cam = obs_cam.astype(np.int32)
    Ts = cams[obs_cam]
    pc = np.einsum("poij,pj->poi", Ts[..., :3, :3], pts) + Ts[..., :3, 3]
    uv = np.stack([480.0 * pc[..., 0] / pc[..., 2] + 319.5,
                   480.0 * pc[..., 1] / pc[..., 2] + 239.5], -1)
    uv = uv + rng.normal(0, 0.5, uv.shape)   # pixel noise: a non-zero optimum
    return ba.BAProblem(
        cam_Tcw=jnp.asarray(cams.astype(np.float32)),
        cam_free=jnp.asarray(np.arange(C) >= 2),
        points=jnp.asarray(pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)),
        point_valid=jnp.ones(P, bool),
        obs_cam=jnp.asarray(obs_cam),
        obs_uv=jnp.asarray(uv.astype(np.float32)),
        obs_ur=jnp.full((P, O), -1.0, jnp.float32),
        obs_inv_sigma2=jnp.ones((P, O)),
        obs_valid=jnp.asarray(pc[..., 2] > 0.5),
    )


def pose_graph_problem(Kn=256, seed=0):
    """Drifted keyframe chain on a circle, closed by one loop edge."""
    import jax
    import jax.numpy as jnp

    from orbslam2_tpu.geometry import se3
    from orbslam2_tpu.solvers import pose_graph as pg

    rng = np.random.default_rng(seed)
    gt = np.stack([np.asarray(se3.exp_se3(jnp.asarray(
        [np.cos(a), np.sin(a), 0, 0, 0, a], jnp.float32)))
        for a in 2 * np.pi * np.arange(Kn) / Kn])
    est = gt.copy()
    for i in range(1, Kn):
        xi = rng.normal(0, 0.002, 6).astype(np.float32) * np.sqrt(i)
        est[i] = np.asarray(se3.exp_se3(jnp.asarray(xi))) @ gt[i]
    ei = np.r_[np.arange(Kn - 1), Kn - 1].astype(np.int32)
    ej = np.r_[np.arange(1, Kn), 0].astype(np.int32)
    rel = np.einsum("eij,ejk->eik", gt[ej], np.linalg.inv(gt[ei]))
    w = np.ones(Kn, np.float32)
    w[-1] = 5.0
    return gt, pg.PoseGraphProblem(
        vertices=jax.vmap(pg.se3_to_pack)(jnp.asarray(est.astype(np.float32))),
        vertex_valid=jnp.ones(Kn, bool),
        vertex_fixed=jnp.zeros(Kn, bool).at[0].set(True),
        edge_i=jnp.asarray(ei), edge_j=jnp.asarray(ej),
        edge_meas=jax.vmap(pg.se3_to_pack)(jnp.asarray(rel.astype(np.float32))),
        edge_valid=jnp.ones(Kn, bool),
        edge_weight=jnp.asarray(w),
    )


def bow_problem(Kn=4096, V=4096, seed=0):
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    vecs = rng.uniform(0, 1, (Kn, V)).astype(np.float32)
    vecs *= rng.random((Kn, V)) < 0.05
    vecs /= vecs.sum(axis=1, keepdims=True)
    present = rng.random(Kn) > 0.02
    exclude = np.zeros(Kn, bool)
    exclude[:8] = True
    covis = (rng.uniform(0, 1, (Kn, Kn)) > 0.995).astype(np.float32) * 50
    q = vecs[Kn // 3] + rng.uniform(0, 1e-4, V).astype(np.float32)
    q /= q.sum()
    return (jnp.asarray(vecs), jnp.asarray(present), jnp.asarray(q),
            jnp.asarray(exclude), 0.01, jnp.asarray(covis))


def _timed(fn, *args, **kwargs):
    """fn's result and the seconds of its second (compiled) call."""
    import jax

    jax.block_until_ready(fn(*args, **kwargs))
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    return out, time.perf_counter() - t0


def permute_points(prob, perm):
    """The same BA problem with its points (and their observations) in
    another order."""
    return prob._replace(**{f: getattr(prob, f)[perm] for f in (
        "points", "point_valid", "obs_cam", "obs_uv", "obs_ur",
        "obs_inv_sigma2", "obs_valid")})


def solve_ba(prob, K, n_devices, perm=None):
    """Sharded BA (5 LM iterations) over `n_devices`, points optionally
    reordered by `perm`. Returns ((cams, points, cost) on the host in the
    original point order, seconds of the second, timed, call)."""
    import jax

    from orbslam2_tpu.parallel import sharded_ba

    p = prob if perm is None else permute_points(prob, perm)
    out, dt = _timed(sharded_ba.sharded_bundle_adjust, p, K,
                     sharded_ba.make_points_mesh(n_devices), iters=5)
    cams, pts, cost = jax.device_get(out)
    if perm is not None:
        pts = pts[np.argsort(perm)]
    return (cams, pts, float(cost)), dt


def ba_gaps(prob, a, b) -> dict:
    """How far two BA solutions of `prob` lie apart: relative cost, raw
    camera rotation and position, each camera relative to its neighbour,
    and each point in the frame of its first observer."""
    (ca, pa, ka), (cb, pb, kb) = a, b

    def local(cams, pts):
        rel = cams[1:] @ np.linalg.inv(cams[:-1])
        T = cams[np.asarray(prob.obs_cam[:, 0])]
        return rel, np.einsum("pij,pj->pi", T[:, :3, :3], pts) + T[:, :3, 3]

    (ra, qa), (rb, qb) = local(ca, pa), local(cb, pb)
    return {
        "cost": abs(ka - kb) / kb,
        "rot": float(np.max(np.abs(ca[:, :3, :3] - cb[:, :3, :3]))),
        "pos_m": float(np.max(np.abs(ca[:, :3, 3] - cb[:, :3, 3]))),
        "neighbour": float(np.max(np.abs(ra - rb))),
        "pts_cam_m": float(np.max(np.abs(qa - qb))),
    }


def _fmt(g: dict) -> str:
    return " ".join(f"{k}={v:.3g}" for k, v in g.items())


def phase_four_cards() -> None:
    import jax

    from orbslam2_tpu.config import CameraConfig
    from orbslam2_tpu.geometry.camera import Intrinsics
    from orbslam2_tpu.parallel import sharded_bow, sharded_pose_graph
    from orbslam2_tpu.solvers import pose_graph as pg
    from orbslam2_tpu.vocab import database

    # full f32 matmuls in the normal equations, as System pins for its
    # session; the GPU's default (TF32) leaves ~1e-3 relative error
    jax.config.update("jax_default_matmul_precision", "highest")
    K = Intrinsics.from_config(CameraConfig(fx=480.0, fy=480.0, bf=240.0))
    prob = ba_problem()
    P = prob.points.shape[0]
    one, dt1 = solve_ba(prob, K, 1)
    four, dt4 = solve_ba(prob, K, 4)
    log(f"[4] sharded BA C={prob.cam_Tcw.shape[0]} P={P} O=8, 5 LM "
        f"iterations: 1 device {dt1 * 1e3:.1f} ms, cost {one[2]:.7g}; "
        f"4 devices {dt4 * 1e3:.1f} ms, cost {four[2]:.7g}")
    # For scale: the same one-device solve with the points in another
    # order, which changes only the order of the f32 sums, as the psum does.
    perm = np.random.default_rng(1).permutation(P)
    wit = ba_gaps(prob, solve_ba(prob, K, 1, perm)[0], one)
    log(f"[4] sharded BA 1 device, points reordered, vs 1 device: {_fmt(wit)}")
    gap = ba_gaps(prob, four, one)
    log(f"[4] sharded BA 4 devices vs 1 device: {_fmt(gap)}")
    check(max(gap.values()) <= 1e-3, "sharded BA 4 vs 1 disagree")

    _, gprob = pose_graph_problem()
    ref = np.asarray(jax.vmap(pg.pack_to_se3)(
        pg.optimize_pose_graph(gprob, iters=20)))
    mesh = sharded_pose_graph.make_edges_mesh(4)
    for inner in ("gathered", "stepped"):
        out, dt = _timed(sharded_pose_graph.sharded_optimize_pose_graph,
                         sharded_pose_graph.pad_edges(gprob, 4), mesh,
                         iters=20, inner=inner)
        d = float(np.max(np.abs(np.asarray(jax.vmap(pg.pack_to_se3)(out)) - ref)))
        log(f"[4] sharded pose graph K=256 inner={inner}: "
            f"max|dT| vs 1 device {d:.3g}, {dt * 1e3:.1f} ms")
        check(d <= 1e-3, f"sharded pose graph ({inner}) disagrees")

    args = bow_problem()
    cand_d, mask_d, scores_d = database._query(*args)
    (cand_s, mask_s, scores_s), dt = _timed(
        sharded_bow.sharded_query, *args, sharded_bow.make_kfs_mesh(4))
    dscore = float(np.max(np.abs(np.asarray(scores_s) - np.asarray(scores_d))))
    same = (np.array_equal(np.asarray(cand_s), np.asarray(cand_d))
            and np.array_equal(np.asarray(mask_s), np.asarray(mask_d)))
    log(f"[4] sharded BoW K={args[0].shape[0]} V={args[0].shape[1]}: "
        f"max|dscore|={dscore:.3g} "
        f"candidates identical={same}, {dt * 1e3:.2f} ms")
    check(dscore <= 1e-6 and same, "sharded BoW query disagrees")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four-cards" in argv
    from orbslam2_tpu.utils import compile_cache

    compile_cache.enable()
    t0 = time.perf_counter()
    info = phase_device(4 if four else 1)
    if four:
        phase_four_cards()
    else:
        for phase in (phase_kernels, phase_rgbd, phase_orbit, phase_sensors,
                      phase_cli):
            t1 = time.perf_counter()
            phase()
            log(f"{phase.__name__} done in {time.perf_counter() - t1:.1f} s")
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": info}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
