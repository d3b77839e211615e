"""Pallas GPU kernel (Triton route): the whole robust pose-GN schedule in
one program.

`solvers/pose_opt.pose_optimize` expresses each Gauss-Newton iteration as
~30 small ops over [N]-sized arrays inside `lax.fori_loop`; the FLOPs are
trivial ([N] edges x a 6-dof state), so under XLA every iteration is a
chain of tiny dependent kernel launches plus loop control, and a frame runs
70 iterations one after another (pipeline/fused.py). This kernel is one
block (`grid=()`) that holds the eight observation channels, N padded to a
power of two, in registers; computes residuals and analytic Jacobians
elementwise; forms the 21 H entries and 6 b entries as block reductions;
and does the 6x6 Cholesky solve and the se(3) Rodrigues update as scalar
math — every round and iteration of the schedule inside one launch. The
math mirrors pose_opt.pose_optimize line for line (reference
src/Optimizer.cc:239-450 semantics: Huber kernel on the first two rounds,
chi2 inlier reclassification after every round).

`pose_optimize_fast` dispatches on `jax.default_backend()`: the kernel on
"gpu", the jnp reference on "cpu" (where `interpret=True` exercises the
kernel in tests), and an error on anything else.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from orbslam2_tpu.geometry.camera import Intrinsics
from orbslam2_tpu.solvers import pose_opt
from orbslam2_tpu.solvers.pose_opt import (
    CHI2_MONO,
    CHI2_STEREO,
    PoseObservations,
    PoseOptResult,
)

_NSCAL = 32       # scalar vector: fx fy cx cy bf, pad, 12 pose entries at 8..19
_NOUT = 16        # 12 pose entries, padded to a power of two


def _chol6_solve(H, b):
    """Scalar 6x6 Cholesky solve (mirrors pose_opt.solve6_spd)."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[j][j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        d = jnp.sqrt(jnp.maximum(s, 1e-12))
        L[j][j] = d
        inv_d = 1.0 / d
        for i in range(j + 1, n):
            s = H[i][j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv_d
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return x


def _exp_se3_scalar(dx):
    """Rodrigues SE(3) exp on 6 scalars -> (R 3x3 list, t 3 list).

    Same Taylor switches as geometry/se3.exp_se3."""
    rx, ry, rz, wx, wy, wz = dx
    t2 = wx * wx + wy * wy + wz * wz
    th = jnp.sqrt(jnp.maximum(t2, 1e-8))
    small = t2 < 1e-4
    a = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(th) / th)
    b = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(th)) / t2)
    c = jnp.where(small, 1.0 / 6.0 - t2 / 120.0, (1.0 - a) / t2)
    W = [[0.0, -wz, wy], [wz, 0.0, -wx], [-wy, wx, 0.0]]
    W2 = [
        [-(wy * wy + wz * wz), wx * wy, wx * wz],
        [wx * wy, -(wx * wx + wz * wz), wy * wz],
        [wx * wz, wy * wz, -(wx * wx + wy * wy)],
    ]
    R = [[(1.0 if i == j else 0.0) + a * W[i][j] + b * W2[i][j]
          for j in range(3)] for i in range(3)]
    V = [[(1.0 if i == j else 0.0) + b * W[i][j] + c * W2[i][j]
          for j in range(3)] for i in range(3)]
    rho = [rx, ry, rz]
    t = [sum(V[i][k] * rho[k] for k in range(3)) for i in range(3)]
    return R, t


def _make_kernel(rounds: int, iters: int):
    def kernel(kp_ref, data_ref, tout_ref, stat_ref):
        fx = kp_ref[0]
        fy = kp_ref[1]
        cx = kp_ref[2]
        cy = kp_ref[3]
        bf = kp_ref[4]
        T = [kp_ref[8 + i] for i in range(12)]  # r00..r22, tx..tz row-major

        px = data_ref[0, :]
        py = data_ref[1, :]
        pz = data_ref[2, :]
        um = data_ref[3, :]
        vm = data_ref[4, :]
        urm = data_ref[5, :]
        isig = data_ref[6, :]
        mask0 = data_ref[7, :] > 0.5
        is2 = urm >= 0.0
        s2 = is2.astype(jnp.float32)
        chi2_th = jnp.where(is2, CHI2_STEREO, CHI2_MONO)
        delta = jnp.sqrt(chi2_th)

        def residuals(T):
            r00, r01, r02, r10, r11, r12, r20, r21, r22, tx, ty, tz = T
            pcx = r00 * px + r01 * py + r02 * pz + tx
            pcy = r10 * px + r11 * py + r12 * pz + ty
            pcz = r20 * px + r21 * py + r22 * pz + tz
            valid = pcz > 1e-3
            iz = 1.0 / jnp.where(valid, pcz, 1.0)
            u = fx * pcx * iz + cx
            v = fy * pcy * iz + cy
            r0 = um - u
            r1 = vm - v
            r2 = jnp.where(is2, urm - (u - bf * iz), 0.0)
            return pcx, pcy, pcz, iz, valid, r0, r1, r2

        def masked_chi2(T, m):
            _, _, _, _, valid, r0, r1, r2 = residuals(T)
            m = m & valid
            r0 = jnp.where(m, r0, 0.0)
            r1 = jnp.where(m, r1, 0.0)
            r2 = jnp.where(m, r2, 0.0)
            return m, (r0 * r0 + r1 * r1 + r2 * r2) * isig

        def gn_iter(T, mask, kernel_on):
            pcx, pcy, pcz, iz, valid, r0, r1, r2 = residuals(T)
            active = mask & valid
            # padded slots may hold NaN: select, don't multiply
            r0 = jnp.where(active, r0, 0.0)
            r1 = jnp.where(active, r1, 0.0)
            r2 = jnp.where(active, r2, 0.0)
            chi2 = (r0 * r0 + r1 * r1 + r2 * r2) * isig
            w = isig * active.astype(jnp.float32)
            if kernel_on:
                en = jnp.sqrt(jnp.maximum(chi2, 1e-12))
                w = w * jnp.where(en > delta, delta / en, 1.0)

            # J rows (see pose_opt._residuals_jacobians): -d(u, v, uR)/dpc
            # times dpc/dxi = [I | -hat(pc)], in CAMERA coordinates pc:
            #   du  = (a, 0, c),  a = fx iz,      c = -fx pcx iz2
            #   dv  = (0, b, c2), b = fy iz,      c2 = -fy pcy iz2
            #   dur = (a, 0, c3), c3 = c + bf iz2   (stereo rows only)
            iz2 = iz * iz
            a = fx * iz
            c = -fx * pcx * iz2
            b_ = fy * iz
            c2 = -fy * pcy * iz2
            c3 = c + bf * iz2
            zero = jnp.zeros_like(a)
            J0 = [-a, zero, -c, -c * pcy, -(a * pcz - c * pcx), a * pcy]
            J1 = [zero, -b_, -c2, b_ * pcz - c2 * pcy, c2 * pcx, -b_ * pcx]
            J2 = [-a * s2, zero, -c3 * s2, -c3 * pcy * s2,
                  -(a * pcz - c3 * pcx) * s2, a * pcy * s2]

            wJ0 = [w * j for j in J0]
            wJ1 = [w * j for j in J1]
            wJ2 = [w * j for j in J2]
            H = [[None] * 6 for _ in range(6)]
            for j in range(6):
                for k in range(j, 6):
                    H[j][k] = jnp.sum(
                        wJ0[j] * J0[k] + wJ1[j] * J1[k] + wJ2[j] * J2[k]
                    )
                    H[k][j] = H[j][k]
            bvec = [jnp.sum(wJ0[j] * r0 + wJ1[j] * r1 + wJ2[j] * r2)
                    for j in range(6)]
            tr = H[0][0] + H[1][1] + H[2][2] + H[3][3] + H[4][4] + H[5][5]
            damp = 1e-5 * (tr / 6.0 + 1e-6)
            for j in range(6):
                H[j][j] = H[j][j] + damp
            dx = _chol6_solve(H, [-x for x in bvec])
            # guard: reject non-finite or absurd steps
            ok = sum(x * x for x in bvec) > 1e-20
            for x in dx:
                ok = ok & jnp.isfinite(x)
            dx = [jnp.where(ok, x, 0.0) for x in dx]
            Rd, td = _exp_se3_scalar(dx)
            r00, r01, r02, r10, r11, r12, r20, r21, r22, tx, ty, tz = T
            Ro = [[r00, r01, r02], [r10, r11, r12], [r20, r21, r22]]
            to = [tx, ty, tz]
            Rn = [[sum(Rd[i][k] * Ro[k][j] for k in range(3))
                   for j in range(3)] for i in range(3)]
            tn = [sum(Rd[i][k] * to[k] for k in range(3)) + td[i]
                  for i in range(3)]
            return (*Rn[0], *Rn[1], *Rn[2], *tn)

        mask = mask0
        for rnd in range(rounds):
            T = jax.lax.fori_loop(
                0, iters,
                lambda _, T, mask=mask, k=rnd < 2: gn_iter(T, mask, k),
                tuple(T),
            )
            # chi2 reclassification on the round's final pose
            m0, chi2 = masked_chi2(T, mask0)
            mask = m0 & (chi2 <= chi2_th)

        _, chi2 = masked_chi2(T, mask0)

        lane = jax.lax.broadcasted_iota(jnp.int32, (_NOUT,), 0)
        tvec = jnp.zeros((_NOUT,), jnp.float32)
        for i in range(12):
            tvec = jnp.where(lane == i, T[i], tvec)
        tout_ref[...] = tvec
        stat_ref[0, :] = mask.astype(jnp.float32)
        stat_ref[1, :] = chi2

    return kernel


def padded_size(n: int) -> int:
    """Observation count padded to the power of two the kernel holds."""
    return max(128, 1 << (n - 1).bit_length())


def default_num_warps(n_pad: int) -> int:
    """Warps per block: 8 from 1024 observations up (the fastest of 4, 8
    and 16 at N = 1024 and 2048 on an H100), 4 below."""
    return min(8, max(4, n_pad // 128))


@partial(jax.jit, static_argnames=("rounds", "iters", "interpret"))
def pose_optimize_pallas(
    Tcw0: jnp.ndarray,
    obs: PoseObservations,
    K: Intrinsics,
    rounds: int = 4,
    iters: int = 10,
    interpret: bool = False,
) -> PoseOptResult:
    """Drop-in replacement for pose_opt.pose_optimize (one Triton block)."""
    N = obs.pw.shape[0]
    Np = padded_size(N)

    def chan(x, pad_value):
        x = x.astype(jnp.float32)
        return jnp.pad(x, (0, Np - N), constant_values=pad_value)

    data = jnp.stack([
        chan(obs.pw[:, 0], 0.0),
        chan(obs.pw[:, 1], 0.0),
        chan(obs.pw[:, 2], 0.0),
        chan(obs.uv[:, 0], 0.0),
        chan(obs.uv[:, 1], 0.0),
        chan(obs.ur, -1.0),
        chan(obs.inv_sigma2, 1.0),
        chan(obs.mask, 0.0),
    ])
    Tflat = jnp.concatenate([Tcw0[:3, :3].reshape(-1), Tcw0[:3, 3]])
    kp = jnp.zeros((_NSCAL,), jnp.float32)
    kp = kp.at[:5].set(jnp.stack([K.fx, K.fy, K.cx, K.cy, K.bf]).astype(jnp.float32))
    kp = kp.at[8:20].set(Tflat.astype(jnp.float32))

    tout, stat = pl.pallas_call(
        _make_kernel(rounds, iters),
        out_shape=[
            jax.ShapeDtypeStruct((_NOUT,), jnp.float32),
            jax.ShapeDtypeStruct((2, Np), jnp.float32),
        ],
        grid=(),
        backend="triton",
        compiler_params=plt.CompilerParams(
            num_warps=default_num_warps(Np), num_stages=1),
        interpret=interpret,
        name="pose_gn",
    )(kp, data)

    T = jnp.eye(4, dtype=jnp.float32)
    T = T.at[:3, :3].set(tout[:9].reshape(3, 3))
    T = T.at[:3, 3].set(tout[9:12])
    inliers = stat[0, :N] > 0.5
    return PoseOptResult(
        Tcw=T,
        inliers=inliers,
        num_inliers=jnp.sum(inliers),
        chi2=stat[1, :N],
    )


def pose_optimize_fast(Tcw0, obs, K, rounds: int = 4, iters: int = 10):
    """Dispatch on the backend: the kernel on "gpu", the jnp reference on
    "cpu"; any other backend is an error (no silent fallback)."""
    backend = jax.default_backend()
    if backend == "gpu":
        return pose_optimize_pallas(Tcw0, obs, K, rounds=rounds, iters=iters)
    if backend == "cpu":
        return pose_opt.pose_optimize(Tcw0, obs, K, rounds=rounds, iters=iters)
    raise NotImplementedError(f"no pose-GN path for backend {backend!r}")
