"""Bundle adjustment: robust LM with sparse Schur complement, one jitted core.

Replaces g2o's BlockSolver_6_3 + marginalized point vertices as used by
`Optimizer::LocalBundleAdjustment` (reference src/Optimizer.cc:453-770) and
`Optimizer::GlobalBundleAdjustment` (reference src/Optimizer.cc:40-236).

Static-shape layout: observations live in a per-point padded table
([P, O] slots, O = max observations per point) so that

* point Hessians H_pp [P, 3, 3] and the Schur elimination are pure batched
  3x3 algebra,
* the camera-camera fill-in (the Schur complement S) is built by scatter-
  adding all O x O per-point block outer products into a DENSE [C, 6, C, 6]
  reduced system — C is small (local BA: tens; global BA shards over
  devices), so the dense solve is one dense factorization instead of
  fighting sparsity,
* Levenberg-Marquardt accept/reject is branchless (jnp.where on the whole
  state), keeping the entire schedule inside one XLA program.

Conventions: residual r = measured - predicted; normal equations
(J^T W J) d = -J^T W r; camera update is left-multiplicative exp(dx) * Tcw.
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


class BAProblem(NamedTuple):
    """Fixed-shape BA problem. C cameras, P points, O obs slots per point."""

    cam_Tcw: jnp.ndarray        # [C, 4, 4]
    cam_free: jnp.ndarray       # [C] bool — False = fixed vertex
    points: jnp.ndarray         # [P, 3]
    point_valid: jnp.ndarray    # [P] bool
    obs_cam: jnp.ndarray        # [P, O] int32 camera index (any value if invalid)
    obs_uv: jnp.ndarray         # [P, O, 2]
    obs_ur: jnp.ndarray         # [P, O]  (<0 => mono edge)
    obs_inv_sigma2: jnp.ndarray # [P, O]
    obs_valid: jnp.ndarray      # [P, O] bool


class BAResult(NamedTuple):
    cam_Tcw: jnp.ndarray
    points: jnp.ndarray
    obs_chi2: jnp.ndarray     # [P, O] final per-edge chi2
    obs_inlier: jnp.ndarray   # [P, O] bool chi2 gate at reference thresholds
    cost: jnp.ndarray         # final robust cost


def _edge_terms(cam_Tcw, points, prob: BAProblem, K: Intrinsics, use_kernel):
    """Residuals, Jacobians and robust weights for every obs slot.

    Returns r [P,O,3], Jc [P,O,3,6], Jp [P,O,3,3], w [P,O], chi2 [P,O],
    active [P,O].
    """
    T = cam_Tcw[prob.obs_cam]                      # [P, O, 4, 4]
    pc = se3.apply(T, points[:, None, :])          # [P, O, 3]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    valid_z = z > 1e-3
    zs = jnp.where(valid_z, z, 1.0)
    inv_z = 1.0 / zs
    inv_z2 = inv_z * inv_z

    u = K.fx * x * inv_z + K.cx
    v = K.fy * y * inv_z + K.cy
    ur_pred = u - K.bf * inv_z
    is_stereo = prob.obs_ur >= 0

    r = jnp.stack(
        [
            prob.obs_uv[..., 0] - u,
            prob.obs_uv[..., 1] - v,
            jnp.where(is_stereo, prob.obs_ur - ur_pred, 0.0),
        ],
        axis=-1,
    )
    active = prob.obs_valid & valid_z & prob.point_valid[:, None]
    r = jnp.where(active[..., None], r, 0.0)

    zeros = jnp.zeros_like(z)
    du = jnp.stack([K.fx * inv_z, zeros, -K.fx * x * inv_z2], -1)
    dv = jnp.stack([zeros, K.fy * inv_z, -K.fy * y * inv_z2], -1)
    dur = du + jnp.stack([zeros, zeros, K.bf * inv_z2], -1)
    duvr = jnp.stack([du, dv, jnp.where(is_stereo[..., None], dur, 0.0)], axis=-2)  # [P,O,3,3]

    eye = jnp.broadcast_to(jnp.eye(3, dtype=pc.dtype), pc.shape[:-1] + (3, 3))
    dpc_dxi = jnp.concatenate([eye, -se3.hat(pc)], axis=-1)  # [P,O,3,6]
    Jc = -(duvr @ dpc_dxi)
    R = T[..., :3, :3]
    Jp = -(duvr @ R)

    Jc = jnp.where(active[..., None, None], Jc, 0.0)
    Jc = jnp.where(prob.cam_free[prob.obs_cam][..., None, None], Jc, 0.0)
    Jp = jnp.where(active[..., None, None], Jp, 0.0)

    chi2_th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    delta = jnp.sqrt(chi2_th)
    e2 = jnp.sum(r[..., :2] ** 2, -1) + jnp.where(is_stereo, r[..., 2] ** 2, 0.0)
    chi2 = e2 * prob.obs_inv_sigma2
    en = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    w_huber = jnp.where(use_kernel & (en > delta), delta / en, 1.0)
    w = prob.obs_inv_sigma2 * w_huber * active
    return r, Jc, Jp, w, chi2, active


def _robust_cost(chi2, active, use_kernel, is_stereo):
    """Sum of Huber-rho over active edges."""
    chi2_th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    delta2 = chi2_th
    rho = jnp.where(
        use_kernel & (chi2 > delta2),
        2.0 * jnp.sqrt(delta2 * jnp.maximum(chi2, 1e-12)) - delta2,
        chi2,
    )
    return jnp.sum(jnp.where(active, rho, 0.0))


def inv3x3_det(h):
    """Batched closed-form (adjugate) 3x3 inverse. Returns (det, inv).

    jnp.linalg.inv/det lower to batched LU solver loops; the cofactor form
    is pure elementwise math that fuses. The caller guards det ~ 0."""
    a, b, c = h[..., 0, 0], h[..., 0, 1], h[..., 0, 2]
    d, e, f = h[..., 1, 0], h[..., 1, 1], h[..., 1, 2]
    g, hh, i = h[..., 2, 0], h[..., 2, 1], h[..., 2, 2]
    A = e * i - f * hh
    B = c * hh - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * hh - e * g
    H = b * g - a * hh
    I = a * e - b * d
    det = a * A + b * D + c * G
    adj = jnp.stack([
        jnp.stack([A, B, C], -1),
        jnp.stack([D, E, F], -1),
        jnp.stack([G, H, I], -1),
    ], -2)
    safe = jnp.where(det == 0, 1.0, det)
    return det, adj / safe[..., None, None]


# chunk the Schur assembly once the one-hot intermediates would exceed this
# many elements (tests shrink it to force the chunked path on small problems)
_CHUNK_ELEMS = 1 << 26


def _build_and_solve(r, Jc, Jp, w, prob: BAProblem, lam):
    """One damped GN step via Schur complement. Returns (dx_cam [C,6], dp [P,3]).

    Every accumulation into the reduced camera system is expressed as a
    one-hot MATMUL over the observation axis ([C, N] @ [N, ...]
    contractions) instead of scatter-adds with millions of random indices.
    Whether a segment-sum or scatter-add is cheaper on the GPU is an open
    measurement (ROADMAP 1.6).
    """
    C = prob.cam_Tcw.shape[0]
    P, O = prob.obs_cam.shape
    hi = jax.lax.Precision.HIGHEST

    Wr = w[..., None] * r
    # point blocks
    Hpp = jnp.einsum("poij,po,poik->pjk", Jp, w, Jp)  # [P,3,3]
    gp = jnp.einsum("poij,poi->pj", Jp, Wr)           # [P,3]
    Hpp_d = Hpp + lam * jnp.eye(3) * jnp.maximum(
        jnp.trace(Hpp, axis1=-2, axis2=-1)[:, None, None] / 3.0, 1e-6
    )
    # guard singular blocks (points with no obs)
    det, Hinv = inv3x3_det(Hpp_d)
    det_ok = det > 1e-12
    Hpp_inv = jnp.where(det_ok[:, None, None], Hinv, 0.0)

    # camera blocks
    Hcc_blk = jnp.einsum("poij,po,poik->pojk", Jc, w, Jc)  # [P,O,6,6]
    gc_blk = jnp.einsum("poij,poi->poj", Jc, Wr)           # [P,O,6]
    Wcp = jnp.einsum("poij,po,poik->pojk", Jc, w, Jp)      # [P,O,6,3] = Hcp block

    cam_idx = prob.obs_cam  # [P,O]
    Y = jnp.einsum("poik,pkl->poil", Wcp, Hpp_inv)         # [P,O,6,3]
    g_red = jnp.einsum("poil,pl->poi", Y, gp)              # [P,O,6]

    # The one-hot contractions materialize [P,O,C] and [P,C,6,3]; at
    # KITTI-length trajectories (C≈1024, P≈1e5) that is gigabytes. Chunk
    # the point axis with a lax.scan once the product crosses ~64M
    # elements — the accumulated [C,C,6,6] system is the only large
    # buffer kept live (same math, bounded peak memory).
    if P * O * C > _CHUNK_ELEMS:
        B = max(256, _CHUNK_ELEMS // max(O * C, 1))
        n_chunks = -(-P // B)
        pad = n_chunks * B - P

        def padp(x):
            return jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1)).reshape(
                (n_chunks, B) + x.shape[1:]
            )

        # padded rows have all-zero Hcc/Y/W/g blocks (jnp.pad), so their
        # one-hot contributions vanish
        ci_c = padp(cam_idx)
        Hcc_c = padp(Hcc_blk)
        gc_c = padp(gc_blk)
        Y_c = padp(Y)
        W_c = padp(Wcp)
        gr_c = padp(g_red)

        def chunk_step(carry, xs):
            S_acc, g_acc = carry
            ci, Hcc_b, gc_b, Y_b, W_b, gr_b = xs
            E_b = jax.nn.one_hot(ci, C, dtype=r.dtype)          # [B,O,C]
            Nf = E_b.shape[0] * O
            Ef_b = E_b.reshape(Nf, C)
            S_diag = jnp.einsum(
                "nc,nx->cx", Ef_b, Hcc_b.reshape(Nf, 36), precision=hi
            ).reshape(C, 6, 6)
            GY = jnp.einsum("poc,poil->pcil", E_b, Y_b, precision=hi)
            GW = jnp.einsum("poc,poil->pcil", E_b, W_b, precision=hi)
            cross = jnp.einsum("pcil,pdjl->cdij", GY, GW, precision=hi)
            g_c = jnp.einsum("nc,nx->cx", Ef_b, gc_b.reshape(Nf, 6), precision=hi)
            g_r = jnp.einsum("nc,nx->cx", Ef_b, gr_b.reshape(Nf, 6), precision=hi)
            S_acc = S_acc.at[jnp.arange(C), jnp.arange(C)].add(S_diag)
            S_acc = S_acc - cross
            g_acc = g_acc + g_c - g_r
            return (S_acc, g_acc), None

        (S, g_S), _ = jax.lax.scan(
            chunk_step,
            (jnp.zeros((C, C, 6, 6), r.dtype), jnp.zeros((C, 6), r.dtype)),
            (ci_c, Hcc_c, gc_c, Y_c, W_c, gr_c),
        )
    else:
        E = jax.nn.one_hot(cam_idx, C, dtype=r.dtype)          # [P,O,C]
        N = P * O
        Ef = E.reshape(N, C)
        S_diag = jnp.einsum(
            "nc,nx->cx", Ef, Hcc_blk.reshape(N, 36), precision=hi
        ).reshape(C, 6, 6)
        S = jnp.zeros((C, C, 6, 6)).at[jnp.arange(C), jnp.arange(C)].add(S_diag)
        GY = jnp.einsum("poc,poil->pcil", E, Y, precision=hi)  # [P,C,6,3]
        GW = jnp.einsum("poc,poil->pcil", E, Wcp, precision=hi)
        cross = jnp.einsum("pcil,pdjl->cdij", GY, GW, precision=hi)
        S = S - cross
        g_c = jnp.einsum("nc,nx->cx", Ef, gc_blk.reshape(N, 6), precision=hi)
        g_S = g_c - jnp.einsum("nc,nx->cx", Ef, g_red.reshape(N, 6), precision=hi)

    # damping + fixed-camera masking on the dense system
    free = prob.cam_free
    eye6 = jnp.eye(6)
    # zero rows/cols of fixed cams, identity on their diagonal
    S = S * (free[:, None, None, None] & free[None, :, None, None])
    S = S.at[jnp.arange(C), jnp.arange(C)].add(
        jnp.where(free[:, None, None], lam * eye6 * jnp.maximum(
            jnp.trace(S[jnp.arange(C), jnp.arange(C)], axis1=-2, axis2=-1)[:, None, None] / 6.0,
            1e-6,
        ), eye6)
    )
    g_S = g_S * free[:, None]

    Sd = S.transpose(0, 2, 1, 3).reshape(C * 6, C * 6)
    dx = jnp.linalg.solve(Sd, -g_S.reshape(C * 6))
    dx_cam = dx.reshape(C, 6)
    dx_cam = jnp.where(free[:, None] & jnp.all(jnp.isfinite(dx_cam), -1, keepdims=True), dx_cam, 0.0)

    # back-substitute points: dp = Hpp_inv (-gp - Hpc dx_c), Hpc = Wcp^T
    dxc_obs = dx_cam[cam_idx]  # [P,O,6]
    Hpc_dx = jnp.einsum("pojk,poj->pk", Wcp, dxc_obs)
    dp = jnp.einsum("pjk,pk->pj", Hpp_inv, -gp - Hpc_dx)
    dp = jnp.where(jnp.all(jnp.isfinite(dp), -1, keepdims=True), dp, 0.0)
    return dx_cam, dp


def _lm_steps(prob: BAProblem, K: Intrinsics, cam, pts, lam, iters: int, uk):
    """Run `iters` Levenberg-Marquardt steps from (cam, pts, lam).

    ONE full edge evaluation per LM iteration: the candidate step's
    residuals/Jacobians are computed to score acceptance and then carried
    into the next iteration (on accept they ARE the new linearization; on
    reject the previous terms are reused). The textbook loop evaluates
    edges twice per iteration.
    """
    is_stereo = prob.obs_ur >= 0

    def step(carry, _):
        cam, pts, lam, cost, terms = carry
        r, Jc, Jp, w, _, _ = terms
        dx_cam, dp = _build_and_solve(r, Jc, Jp, w, prob, lam)
        cam_new = se3.exp_se3(dx_cam) @ cam
        pts_new = pts + dp
        terms_new = _edge_terms(cam_new, pts_new, prob, K, uk)
        new_cost = _robust_cost(terms_new[4], terms_new[5], uk, is_stereo)
        accept = new_cost < cost
        cam = jnp.where(accept, cam_new, cam)
        pts = jnp.where(accept, pts_new, pts)
        lam = jnp.where(accept, lam * 0.5, lam * 4.0)
        lam = jnp.clip(lam, 1e-9, 1e3)
        cost = jnp.where(accept, new_cost, cost)
        terms = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), terms_new, terms
        )
        return (cam, pts, lam, cost, terms), None

    terms0 = _edge_terms(cam, pts, prob, K, uk)
    cost0 = _robust_cost(terms0[4], terms0[5], uk, is_stereo)
    (cam, pts, lam, cost, _), _ = jax.lax.scan(
        step, (cam, pts, lam, cost0, terms0), None, length=iters,
    )
    return cam, pts, lam, cost


@partial(jax.jit, static_argnames=("iters",))
def bundle_adjust_slice(
    prob: BAProblem, K: Intrinsics, cam, pts, lam, iters: int, use_kernel
):
    """One bounded slice of LM iterations with an explicit carry.

    Time-sliced global BA (the device-side stand-in for the reference's
    detached GBA thread, src/LoopClosing.cc:615,683-790): the loop closer
    dispatches one slice per tracked frame so a full-map BA never stalls
    tracking by more than one slice's device time. The carry (cam, pts,
    lam) lives on device between slices; `use_kernel` is traced so the
    robust->plain switch reuses the same compiled program.
    """
    return _lm_steps(prob, K, cam, pts, lam, iters, jnp.asarray(use_kernel))


@partial(jax.jit, static_argnames=("iters", "use_kernel"))
def bundle_adjust(
    prob: BAProblem,
    K: Intrinsics,
    iters: int = 10,
    use_kernel: bool = True,
    lam0: float = 1e-4,
) -> BAResult:
    """Levenberg-Marquardt BA with branchless accept/reject."""
    is_stereo = prob.obs_ur >= 0
    uk = jnp.asarray(use_kernel)
    cam, pts, _, cost = _lm_steps(
        prob, K, prob.cam_Tcw, prob.points, jnp.asarray(lam0), iters, uk
    )

    *_, chi2, active = _edge_terms(cam, pts, prob, K, jnp.asarray(False))
    chi2_th = jnp.where(is_stereo, CHI2_STEREO, CHI2_MONO)
    inlier = active & (chi2 <= chi2_th)
    return BAResult(cam_Tcw=cam, points=pts, obs_chi2=chi2, obs_inlier=inlier, cost=cost)


def two_phase_bundle_adjust(
    prob: BAProblem, K: Intrinsics, iters1: int = 5, iters2: int = 10
) -> BAResult:
    """The reference's local-BA schedule: 5 robust iterations, drop chi2
    outliers, 10 more iterations (reference src/Optimizer.cc:660-700)."""
    res1 = bundle_adjust(prob, K, iters=iters1, use_kernel=True)
    prob2 = prob._replace(
        cam_Tcw=res1.cam_Tcw,
        points=res1.points,
        obs_valid=prob.obs_valid & res1.obs_inlier,
    )
    return bundle_adjust(prob2, K, iters=iters2, use_kernel=False)
