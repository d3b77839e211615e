"""The helpers of chip_smoke.py on the CPU: it refuses to run without a
GPU, and its four-card BA comparison (reorder witness, local geometry)
holds on the virtual CPU mesh at a small strip."""

import jax
import numpy as np
import pytest

import chip_smoke
from orbslam2_tpu.config import CameraConfig
from orbslam2_tpu.geometry.camera import Intrinsics

K = Intrinsics.from_config(CameraConfig(fx=480.0, fy=480.0, bf=240.0))


@pytest.fixture(scope="module")
def strip():
    prob = chip_smoke.ba_problem(C=32, P=2048)
    one, _ = chip_smoke.solve_ba(prob, K, 1)
    return prob, one


def test_device_phase_refuses_cpu():
    with pytest.raises(RuntimeError, match="not 'gpu'"):
        chip_smoke.phase_device(1)


def test_permute_points_round_trip(strip):
    prob, _ = strip
    perm = np.random.default_rng(1).permutation(prob.points.shape[0])
    back = chip_smoke.permute_points(chip_smoke.permute_points(prob, perm),
                                     np.argsort(perm))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(prob)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reordered_solve_is_a_witness(strip):
    """Reordering the points changes only f32 summation order: the solve
    returns points in the original order, at the same optimum."""
    prob, one = strip
    perm = np.random.default_rng(2).permutation(prob.points.shape[0])
    again, _ = chip_smoke.solve_ba(prob, K, 1, perm)
    g = chip_smoke.ba_gaps(prob, again, one)
    assert g["cost"] <= 1e-5
    assert g["neighbour"] <= 1e-4 and g["pts_cam_m"] <= 1e-3
    assert chip_smoke.ba_gaps(prob, one, one) == dict.fromkeys(g, 0.0)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_sharded_strip_agrees_with_one_device(strip, n_devices):
    """The four-card check's bounds, on the virtual CPU mesh."""
    if len(jax.devices()) < n_devices:
        pytest.skip("not enough devices")
    prob, one = strip
    many, _ = chip_smoke.solve_ba(prob, K, n_devices)
    g = chip_smoke.ba_gaps(prob, many, one)
    assert g["cost"] <= 1e-3
    assert g["neighbour"] <= 1e-3 and g["pts_cam_m"] <= 1e-3
    assert g["rot"] <= 1e-3 and g["pos_m"] <= 1e-3
