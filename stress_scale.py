"""KITTI-length trajectory scale stress (VERDICT r1 #4).

Builds a 1024-keyframe / ~100k-point map state directly (vectorized — no
need to track 5000 frames to test the data structures), then exercises the
structures the round-1 review called out as capacity-capped:

  * one fused tracking step against the full-size map (K=1024 gathers),
  * on-device essential-graph edge assembly + Sim3 pose-graph optimization,
  * global bundle adjustment (chunked Schur assembly keeps the one-hot
    intermediates bounded),
  * full observation-table + covisibility reconciliation.

Prints one JSON line with wall-clock per stage and peak RSS. Run with
JAX_PLATFORMS=cpu for a hermetic check or on a GPU for real timings; fails
when JAX finds no GPU unless JAX_PLATFORMS=cpu asks for the CPU.
"""

import json
import resource
import sys
import time


def main():
    import jax

    from orbslam2_tpu.utils import compile_cache, device

    device.require_gpu()
    compile_cache.enable()
    jax.config.update("jax_default_matmul_precision", "highest")

    import jax.numpy as jnp
    import numpy as np

    from orbslam2_tpu.config import CameraConfig, MapConfig, OrbConfig, SlamConfig
    from orbslam2_tpu.geometry.camera import Intrinsics
    from orbslam2_tpu.pipeline import loop_closing as lc
    from orbslam2_tpu.pipeline import local_mapping as lm
    from orbslam2_tpu.slam_map import map_state as ms
    from orbslam2_tpu.solvers import ba, pose_graph

    Kn, Pn, S, O = 1024, 98304, 256, 8
    cam = CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0)
    Kin = Intrinsics.from_config(cam)
    rng = np.random.default_rng(0)

    t_all = time.perf_counter()
    state = ms.allocate(
        MapConfig(max_keyframes=Kn, max_points=Pn + 1024),
        OrbConfig(feature_slots=S),
        obs_slots=O,
    )

    # --- synthesize a long forward trajectory with local covisibility ----
    t0 = time.perf_counter()
    zs = 0.25 * np.arange(Kn)
    Tcw = np.tile(np.eye(4, dtype=np.float32), (Kn, 1, 1))
    Tcw[:, 2, 3] = -zs  # camera at z = zs looking +z
    pts = np.c_[
        rng.uniform(-4, 4, Pn), rng.uniform(-3, 3, Pn),
        rng.uniform(0.0, zs[-1] + 12.0, Pn),
    ].astype(np.float32)
    # each point observed by O consecutive keyframes behind it
    base_kf = np.clip(((pts[:, 2] - 6.0) / 0.25).astype(np.int32), 0, Kn - O)
    obs_kf = base_kf[:, None] + np.arange(O)[None, :]
    feat = rng.integers(0, S, size=(Pn, O)).astype(np.int32)

    kf_point_idx = np.full((Kn, S), -1, np.int32)
    kf_point_idx[obs_kf.reshape(-1), feat.reshape(-1)] = np.repeat(
        np.arange(Pn, dtype=np.int32), O
    )
    # keypoint tables consistent with projections
    kf_xy = np.zeros((Kn, S, 2), np.float32)
    kf_ur = np.full((Kn, S), -1.0, np.float32)
    kf_depth = np.full((Kn, S), -1.0, np.float32)
    for o in range(O):
        k_ids = obs_kf[:, o]
        pc = pts + 0.0
        z = pc[:, 2] + Tcw[k_ids, 2, 3]
        u = 480.0 * pc[:, 0] / np.maximum(z, 0.1) + 319.5
        v = 480.0 * pc[:, 1] / np.maximum(z, 0.1) + 239.5
        kf_xy[k_ids, feat[:, o], 0] = u
        kf_xy[k_ids, feat[:, o], 1] = v
        kf_ur[k_ids, feat[:, o]] = u - 48.0 / np.maximum(z, 0.1)
        kf_depth[k_ids, feat[:, o]] = z

    state = state._replace(
        kf_Tcw=jnp.asarray(Tcw),
        kf_valid=jnp.ones(Kn, bool),
        kf_frame_id=jnp.arange(Kn, dtype=jnp.int32),
        kf_xy=jnp.asarray(kf_xy),
        kf_ur=jnp.asarray(kf_ur),
        kf_depth=jnp.asarray(kf_depth),
        kf_feat_valid=jnp.ones((Kn, S), bool),
        kf_point_idx=jnp.asarray(kf_point_idx),
        kf_parent=jnp.concatenate([jnp.asarray([-1], jnp.int32),
                                   jnp.arange(Kn - 1, dtype=jnp.int32)]),
        mp_pos=state.mp_pos.at[:Pn].set(jnp.asarray(pts)),
        mp_valid=state.mp_valid.at[:Pn].set(True),
        mp_ref_kf=state.mp_ref_kf.at[:Pn].set(jnp.asarray(base_kf)),
        mp_first_kf=state.mp_first_kf.at[:Pn].set(jnp.asarray(base_kf)),
        num_kf=jnp.int32(Kn),
        num_mp=jnp.int32(Pn),
    )
    t_build = time.perf_counter() - t0

    # --- observation/covisibility reconciliation at full scale -----------
    t0 = time.perf_counter()
    state, truncated = ms.rebuild_observations(state)
    state = lc.rebuild_covisibility(state)
    jax.block_until_ready(state.covis)
    t_reconcile = time.perf_counter() - t0

    # --- essential-graph assembly + pose graph ---------------------------
    t0 = time.perf_counter()
    ei, ej, meas, evalid, n_total = lc.build_essential_edges(
        state, essential_threshold=100, max_edges=4 * Kn
    )
    jax.block_until_ready(meas)
    t_edges = time.perf_counter() - t0

    t0 = time.perf_counter()
    vert = jax.vmap(pose_graph.se3_to_pack)(state.kf_Tcw)
    prob = pose_graph.PoseGraphProblem(
        vertices=vert,
        vertex_valid=state.kf_valid,
        vertex_fixed=jnp.zeros(Kn, bool).at[0].set(True),
        edge_i=ei, edge_j=ej, edge_meas=meas, edge_valid=evalid,
        edge_weight=jnp.where(evalid, 1.0, 0.0),
    )
    # the scalable path (matrix-free block-Jacobi PCG): at K=1024 the
    # round-2 dense solve took 11.5 s for 3 iterations
    out = pose_graph.optimize_pose_graph_pcg(prob, iters=3, cg_iters=64)
    jax.block_until_ready(out)
    t_pose_graph = time.perf_counter() - t0

    # --- global BA (chunked Schur assembly) ------------------------------
    t0 = time.perf_counter()
    gprob, cam_ids, cam_present, pids, pt_ok = lm.build_global_ba_problem(
        state, jnp.ones(8, jnp.float32), max_points=Pn + 1024, obs_slots=O
    )
    res = ba.bundle_adjust(gprob, Kin, iters=2, use_kernel=True)
    jax.block_until_ready(res.cam_Tcw)
    t_gba = time.perf_counter() - t0

    print(json.dumps({
        "metric": "scale_stress_1024kf",
        "value": round(time.perf_counter() - t_all, 1),
        "unit": "s total",
        "vs_baseline": 1.0,
        "extra": {
            "K": Kn, "P": Pn, "obs_slots": O,
            "edges_total": int(n_total),
            "obs_truncated": int(truncated),
            "build_s": round(t_build, 1),
            "reconcile_s": round(t_reconcile, 1),
            "edges_s": round(t_edges, 1),
            "pose_graph_3it_s": round(t_pose_graph, 1),
            "global_ba_2it_s": round(t_gba, 1),
            "gba_cost": float(res.cost),
            "peak_rss_gb": round(
                resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2
            ),
            "device": device.device_info(),
        },
    }))


if __name__ == "__main__":
    sys.exit(main())
