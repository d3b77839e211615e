"""Pose-only optimization: robust Gauss-Newton/LM on a single SE(3) vertex.

Replaces g2o's `Optimizer::PoseOptimization` (reference
src/Optimizer.cc:239-450): monocular 2-D and stereo 3-D (u, v, uR)
reprojection edges with per-octave information, Huber kernels
(delta = sqrt(5.991) mono / sqrt(7.815) stereo), and the reference's
4-rounds-of-10-iterations schedule with chi2 inlier reclassification after
each round and the kernel dropped for the last two rounds
(src/Optimizer.cc:262-268, 366-444).

Design: all observation slots are fixed-size masked arrays; each
iteration builds the 6x6 normal system with one batched Jacobian product
and solves on the device. The whole schedule jits to a single XLA program.
On the GPU the frame program calls the fused one-kernel version of this
schedule (solvers/pallas_pose_opt.py); this is the reference it is tested
against and the path on the CPU.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam2_tpu.geometry import se3
from orbslam2_tpu.geometry.camera import Intrinsics

CHI2_MONO = 5.991
CHI2_STEREO = 7.815


class PoseObservations(NamedTuple):
    """Fixed-size observation set binding frame features to 3-D points."""

    pw: jnp.ndarray        # [N, 3] world points
    uv: jnp.ndarray        # [N, 2] measured pixel coords (undistorted)
    ur: jnp.ndarray        # [N] measured right-x; < 0 => monocular edge
    inv_sigma2: jnp.ndarray  # [N] information scale (1 / sigma^2(octave))
    mask: jnp.ndarray      # [N] bool: slot holds a real observation


class PoseOptResult(NamedTuple):
    Tcw: jnp.ndarray          # [4, 4] optimized pose
    inliers: jnp.ndarray      # [N] bool
    num_inliers: jnp.ndarray  # int32
    chi2: jnp.ndarray         # [N] final per-edge chi2


def _residuals_jacobians(Tcw, obs: PoseObservations, K: Intrinsics):
    """Batched residuals + analytic Jacobians wrt a left-multiplied twist.

    Returns (r [N, 3], J [N, 3, 6], valid_depth [N]). Row 2 of r/J is the
    uR residual, zeroed for mono edges.
    """
    pc = se3.apply(Tcw, obs.pw)  # [N, 3]
    x, y, z = pc[:, 0], pc[:, 1], pc[:, 2]
    valid_z = z > 1e-3
    zs = jnp.where(valid_z, z, 1.0)
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z

    u = K.fx * x * inv_z + K.cx
    v = K.fy * y * inv_z + K.cy
    ur_pred = u - K.bf * inv_z

    is_stereo = obs.ur >= 0
    r = jnp.stack(
        [obs.uv[:, 0] - u, obs.uv[:, 1] - v, jnp.where(is_stereo, obs.ur - ur_pred, 0.0)],
        axis=-1,
    )

    # d(pc)/d(xi) for pc' = exp(xi) * Tcw * pw: [I | -hat(pc)]
    # duvr/dpc rows:
    du = jnp.stack([K.fx * inv_z, jnp.zeros_like(z), -K.fx * x * inv_z2], -1)
    dv = jnp.stack([jnp.zeros_like(z), K.fy * inv_z, -K.fy * y * inv_z2], -1)
    dur = du + jnp.stack(
        [jnp.zeros_like(z), jnp.zeros_like(z), K.bf * inv_z2], -1
    )
    duvr = jnp.stack([du, dv, jnp.where(is_stereo[:, None], dur, 0.0)], axis=1)  # [N,3,3]

    eye = jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), (pc.shape[0], 3, 3))
    dpc = jnp.concatenate([eye, -se3.hat(pc)], axis=-1)  # [N, 3, 6]
    J = -(duvr @ dpc)  # residual = obs - pred => J = -dpred/dxi
    return r, J, valid_z


def _chi2(r, inv_sigma2, is_stereo):
    e2 = jnp.sum(r[:, :2] ** 2, axis=-1) + jnp.where(is_stereo, r[:, 2] ** 2, 0.0)
    return e2 * inv_sigma2


def solve6_spd(H, b):
    """Solve H x = b for a damped-SPD 6x6 via fully unrolled Cholesky.

    jnp.linalg.solve lowers to pivoted LU with sequential control flow;
    pose optimization runs tens of GN iterations per frame, each with one
    6x6 solve, so the unrolled scalar form (21 rsqrt/div + static
    triangular substitutions) is used. H must be SPD (callers damp the
    diagonal)."""
    n = 6
    # Cholesky H = L L^T, unrolled
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(jnp.maximum(s, 1e-12))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = H[i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    # forward substitution L y = b
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    # back substitution L^T x = y
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return jnp.stack(x)


@partial(jax.jit, static_argnames=("rounds", "iters"))
def pose_optimize(
    Tcw0: jnp.ndarray,
    obs: PoseObservations,
    K: Intrinsics,
    rounds: int = 4,
    iters: int = 10,
) -> PoseOptResult:
    """Run the reference's 4x10 robust schedule; returns pose + inliers."""
    is_stereo = obs.ur >= 0
    chi2_th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = jnp.sqrt(chi2_th)

    # NOTE: the round mask and kernel flag travel in the carry — lax.fori_loop
    # caches the traced body by function identity, so closing over per-round
    # values would silently reuse round 1's capture in rounds 2-4.
    def gn_iter(_, carry):
        xi_T, use_kernel, carry_mask = carry
        r, J, valid_z = _residuals_jacobians(xi_T, obs, K)
        active = carry_mask & valid_z
        # sanitize inactive slots: padded slots may hold NaN/garbage and
        # 0 * NaN = NaN would poison the normal equations
        r = jnp.where(active[:, None], r, 0.0)
        J = jnp.where(active[:, None, None], J, 0.0)
        chi2 = _chi2(r, obs.inv_sigma2, is_stereo)
        # Huber reweighting on the normalized residual norm
        en = jnp.sqrt(jnp.maximum(chi2, 1e-12))
        w_huber = jnp.where(use_kernel & (en > delta), delta / en, 1.0)
        w = obs.inv_sigma2 * w_huber * active
        JW = J * w[:, None, None]
        H = jnp.einsum("nij,nik->jk", JW, J)
        b = jnp.einsum("nij,ni->j", JW, r)
        H = H + 1e-5 * jnp.eye(6) * (jnp.trace(H) / 6.0 + 1e-6)
        dx = solve6_spd(H, -b)
        # guard: reject non-finite or absurd steps
        ok = jnp.all(jnp.isfinite(dx)) & (jnp.sum(b * b) > 1e-20)
        dx = jnp.where(ok, dx, 0.0)
        T_new = se3.exp_se3(dx) @ xi_T
        return (T_new, use_kernel, carry_mask)

    T = Tcw0
    inlier_mask = obs.mask
    for rnd in range(rounds):
        use_kernel = jnp.asarray(rnd < 2)
        T, _, _ = jax.lax.fori_loop(0, iters, gn_iter, (T, use_kernel, inlier_mask))
        r, _, valid_z = _residuals_jacobians(T, obs, K)
        r = jnp.where(obs.mask[:, None], r, 0.0)
        chi2 = _chi2(r, obs.inv_sigma2, is_stereo)
        inlier_mask = obs.mask & valid_z & (chi2 <= chi2_th)

    r, _, valid_z = _residuals_jacobians(T, obs, K)
    chi2 = _chi2(r, obs.inv_sigma2, is_stereo)
    return PoseOptResult(
        Tcw=T,
        inliers=inlier_mask,
        num_inliers=jnp.sum(inlier_mask),
        chi2=chi2,
    )
