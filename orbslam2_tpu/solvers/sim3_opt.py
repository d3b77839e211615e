"""Joint Sim(3) optimization for loop closing.

Replaces `Optimizer::OptimizeSim3` (reference src/Optimizer.cc:1042-1249):
one Sim3 vertex relating loop-candidate camera 2 to current camera 1, with
paired inverse-projection edge sets — e1 = uv1 - proj(S12 · X2) observed in
camera 1, e2 = uv2 - proj(S12^-1 · X1) observed in camera 2 — robust Huber
(delta = sqrt(10), reference :1104), 5 GN iterations, a chi2 > 10 outlier
cut (reference :1168-1186), then 10 more iterations on the surviving set
and a final inlier recount.

Design: fixed-size masked pair arrays; the 7-dof tangent-space Jacobian
comes from jax.jacfwd through the exact Sim3 exp map, so the whole schedule
jits to one XLA program.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam2_tpu.geometry import sim3
from orbslam2_tpu.geometry.camera import Intrinsics

CHI2_SIM3 = 10.0  # reference src/Optimizer.cc:1104 (deltaHuber = sqrt(10))


class Sim3OptResult(NamedTuple):
    s: jnp.ndarray
    R: jnp.ndarray
    t: jnp.ndarray
    inliers: jnp.ndarray      # [N] bool
    num_inliers: jnp.ndarray  # int32


def _project(p, K: Intrinsics):
    z = jnp.maximum(p[..., 2], 1e-3)
    return jnp.stack(
        [K.fx * p[..., 0] / z + K.cx, K.fy * p[..., 1] / z + K.cy], -1
    )


def _residuals(delta, S_pack, pc1, pc2, uv1, uv2, K, fix_scale):
    """Stacked residuals [2N, 2] for the left-incremented vertex
    S' = exp(delta) o S. delta = (rho, phi, sigma); sigma frozen when
    fix_scale (reference VertexSim3Expmap _fix_scale, src/Optimizer.cc:1060)."""
    d = jnp.where(fix_scale, delta.at[6].set(0.0), delta)
    S = sim3.compose(sim3.exp(d), sim3.unpack(S_pack))
    Sinv = sim3.inverse(S)
    e1 = uv1 - _project(sim3.apply(S, pc2), K)      # cam2 points into image 1
    e2 = uv2 - _project(sim3.apply(Sinv, pc1), K)   # cam1 points into image 2
    return jnp.concatenate([e1, e2], axis=0)


@partial(jax.jit, static_argnames=("iters1", "iters2"))
def optimize_sim3(
    s0: jnp.ndarray,
    R0: jnp.ndarray,
    t0: jnp.ndarray,
    pc1: jnp.ndarray,        # [N, 3] matched points in camera-1 frame
    pc2: jnp.ndarray,        # [N, 3] matched points in camera-2 frame
    uv1: jnp.ndarray,        # [N, 2] observation of pair i in image 1
    uv2: jnp.ndarray,        # [N, 2] observation of pair i in image 2
    inv_sigma2_1: jnp.ndarray,  # [N]
    inv_sigma2_2: jnp.ndarray,  # [N]
    mask: jnp.ndarray,       # [N] bool valid pairs
    K: Intrinsics,
    fix_scale,
    iters1: int = 5,
    iters2: int = 10,
) -> Sim3OptResult:
    """Gauss-Newton refinement of S12 (cam2 -> cam1) over matched pairs."""
    S_pack0 = sim3.pack((s0, R0, t0))
    w_info = jnp.concatenate([inv_sigma2_1, inv_sigma2_2])
    fix_scale = jnp.asarray(fix_scale)

    jac = jax.jacfwd(_residuals, argnums=0)

    def gn_iter(carry, pair_mask):
        S_pack = carry
        zero = jnp.zeros(7, S_pack.dtype)
        r = _residuals(zero, S_pack, pc1, pc2, uv1, uv2, K, fix_scale)
        J = jac(zero, S_pack, pc1, pc2, uv1, uv2, K, fix_scale)  # [2N, 2, 7]
        m2 = jnp.concatenate([pair_mask, pair_mask])
        r = jnp.where(m2[:, None], r, 0.0)
        J = jnp.where(m2[:, None, None], J, 0.0)
        chi2 = jnp.sum(r * r, -1) * w_info
        en = jnp.sqrt(jnp.maximum(chi2, 1e-12))
        delta_h = jnp.sqrt(CHI2_SIM3)
        w_huber = jnp.where(en > delta_h, delta_h / en, 1.0)
        w = w_info * w_huber * m2
        JW = J * w[:, None, None]
        H = jnp.einsum("nij,nik->jk", JW, J)
        b = jnp.einsum("nij,ni->j", JW, r)
        H = H + 1e-6 * jnp.eye(7) * (jnp.trace(H) / 7.0 + 1e-6)
        # J = -d(pred)/d(delta) is folded in because residual = obs - pred
        dx = jnp.linalg.solve(H, b)
        ok = jnp.all(jnp.isfinite(dx))
        dx = jnp.where(ok, dx, 0.0)
        dx = jnp.where(fix_scale, dx.at[6].set(0.0), dx)
        # residual = obs - pred(S), d r/d delta = -d pred => solve(H, b)
        # moves AGAINST the residual gradient; apply the exp increment
        return sim3.pack(sim3.compose(sim3.exp(-dx), sim3.unpack(S_pack)))

    def chi2_pairs(S_pack, pair_mask):
        zero = jnp.zeros(7, S_pack.dtype)
        r = _residuals(zero, S_pack, pc1, pc2, uv1, uv2, K, fix_scale)
        chi2 = jnp.sum(r * r, -1)
        N = pc1.shape[0]
        c1 = chi2[:N] * inv_sigma2_1
        c2 = chi2[N:] * inv_sigma2_2
        return pair_mask & (c1 <= CHI2_SIM3) & (c2 <= CHI2_SIM3)

    S_pack = S_pack0
    for _ in range(iters1):
        S_pack = gn_iter(S_pack, mask)
    inl = chi2_pairs(S_pack, mask)
    for _ in range(iters2):
        S_pack = gn_iter(S_pack, inl)
    inl = chi2_pairs(S_pack, inl)

    s, R, t = sim3.unpack(S_pack)
    return Sim3OptResult(s=s, R=R, t=t, inliers=inl, num_inliers=jnp.sum(inl))
