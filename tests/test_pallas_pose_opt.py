"""The fused pose-GN kernel (Triton route) against the jnp reference
(solvers/pose_opt.pose_optimize), exercised with interpret=True on CPU, and
the dispatcher that picks between them.

The kernel mirrors the reference schedule semantics
(src/Optimizer.cc:239-450): Huber kernel in the first two rounds, chi2
reclassification after each round — so pose AND inlier sets must agree
up to f32 roundoff with the jnp implementation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from orbslam2_tpu.config import CameraConfig
from orbslam2_tpu.geometry import camera, se3
from orbslam2_tpu.io.synthetic import pose_problem
from orbslam2_tpu.solvers import pallas_pose_opt, pose_opt
from orbslam2_tpu.solvers.pallas_pose_opt import pose_optimize_pallas

CAM = CameraConfig(fx=480.0, fy=480.0, cx=319.5, cy=239.5, bf=48.0)
K = camera.Intrinsics.from_config(CAM)


@pytest.mark.parametrize("rounds,iters", [(4, 10), (2, 6), (3, 6), (4, 6)])
def test_matches_jnp_reference(rng, rounds, iters):
    T_true, obs = pose_problem(rng, cam=CAM)
    T0 = se3.identity()
    ref = pose_opt.pose_optimize(T0, obs, K, rounds=rounds, iters=iters)
    pal = pose_optimize_pallas(T0, obs, K, rounds=rounds, iters=iters,
                               interpret=True)
    np.testing.assert_allclose(
        np.asarray(pal.Tcw), np.asarray(ref.Tcw), atol=5e-5
    )
    assert np.array_equal(np.asarray(pal.inliers), np.asarray(ref.inliers))
    assert int(pal.num_inliers) == int(ref.num_inliers)


# a camera far from the world origin and turned by ~70 degrees: the
# Jacobian must use camera-frame coordinates (identity-start problems
# cannot tell them from world coordinates)
FAR = [2.0, -0.5, 3.0, 0.3, 1.2, -0.2]


@pytest.mark.parametrize("rounds,iters", [(4, 10), (2, 6)])
def test_matches_reference_far_from_origin(rng, rounds, iters):
    T_true, obs = pose_problem(rng, cam=CAM, xi_true=FAR)
    T0 = se3.exp_se3(jnp.asarray([0.05, -0.03, 0.04, 0.01, -0.02, 0.015],
                                 jnp.float32)) @ T_true
    ref = pose_opt.pose_optimize(T0, obs, K, rounds=rounds, iters=iters)
    pal = pose_optimize_pallas(T0, obs, K, rounds=rounds, iters=iters,
                               interpret=True)
    np.testing.assert_allclose(
        np.asarray(pal.Tcw), np.asarray(ref.Tcw), atol=5e-5
    )
    assert np.array_equal(np.asarray(pal.inliers), np.asarray(ref.inliers))
    d = np.asarray(se3.log_se3(pal.Tcw @ se3.inverse(T_true)))
    assert np.linalg.norm(d) < 1e-2


def test_non_padded_size(rng):
    """N not a power of two is padded inside the wrapper (700 -> 1024)."""
    T_true, obs = pose_problem(rng, n=700, n_real=600, n_out=40, cam=CAM)
    ref = pose_opt.pose_optimize(se3.identity(), obs, K, rounds=2, iters=6)
    pal = pose_optimize_pallas(se3.identity(), obs, K, rounds=2, iters=6,
                               interpret=True)
    np.testing.assert_allclose(
        np.asarray(pal.Tcw), np.asarray(ref.Tcw), atol=5e-5
    )
    assert np.array_equal(np.asarray(pal.inliers), np.asarray(ref.inliers))
    assert pal.inliers.shape == (700,) and pal.chi2.shape == (700,)
    assert pallas_pose_opt.padded_size(700) == 1024


def test_converges_to_truth(rng):
    T_true, obs = pose_problem(rng, noise=0.0, n_out=0, cam=CAM)
    pal = pose_optimize_pallas(se3.identity(), obs, K, interpret=True)
    d = np.asarray(se3.log_se3(pal.Tcw @ se3.inverse(T_true)))
    assert np.linalg.norm(d) < 1e-3


def test_dispatch_cpu_takes_reference(rng, monkeypatch):
    T_true, obs = pose_problem(rng, n=256, n_real=200, n_out=10, cam=CAM)
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    got = pallas_pose_opt.pose_optimize_fast(se3.identity(), obs, K,
                                             rounds=2, iters=6)
    ref = pose_opt.pose_optimize(se3.identity(), obs, K, rounds=2, iters=6)
    np.testing.assert_array_equal(np.asarray(got.Tcw), np.asarray(ref.Tcw))
    np.testing.assert_array_equal(np.asarray(got.inliers),
                                  np.asarray(ref.inliers))


def test_dispatch_unknown_backend_raises(rng, monkeypatch):
    _, obs = pose_problem(rng, n=128, n_real=100, n_out=5, cam=CAM)
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(NotImplementedError, match="rocm"):
        pallas_pose_opt.pose_optimize_fast(se3.identity(), obs, K)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1024, 2048])
def test_kernel_on_gpu_matches_reference(gpu, n):
    """Compiled kernel (no interpret mode) on the card."""
    _, obs = pose_problem(np.random.default_rng(0), n=n, n_real=700 * n // 1024,
                          cam=CAM)
    with jax.default_matmul_precision("highest"):
        ref = pose_opt.pose_optimize(se3.identity(), obs, K)
        got = pallas_pose_opt.pose_optimize_fast(se3.identity(), obs, K)
    np.testing.assert_allclose(np.asarray(got.Tcw), np.asarray(ref.Tcw),
                               atol=5e-5)
    assert np.array_equal(np.asarray(got.inliers), np.asarray(ref.inliers))
