"""Distributed bundle adjustment over a device mesh.

The reference has no distributed capability at all (SURVEY.md §2b); this is
the scale-out of the BA core for maps too large for one device
(BASELINE.md: distributed global BA, KITTI-00 sharded):

* map POINTS (and their observation rows) are sharded across the mesh's
  ``points`` axis — each device eliminates its own point blocks (batched
  3x3 Schur) and builds a partial dense reduced camera system;
* the [C, 6, C, 6] reduced system and rhs are `psum`-reduced over the
  mesh (NVLink between the cards of one host) — the only collective in
  the loop (camera count C is small; the heavy
  point-side work never crosses the interconnect);
* the camera solve runs replicated on every device (cheaper than a
  broadcast for small C), point back-substitution stays local.

The same jitted step runs on 1 device (degenerate mesh) or N; only the
Mesh construction differs (SURVEY.md §4 mesh-parametrized testing).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from orbslam2_tpu.geometry import se3
from orbslam2_tpu.geometry.camera import Intrinsics
from orbslam2_tpu.solvers import ba as ba_core


def _local_schur(prob: ba_core.BAProblem, K: Intrinsics, lam, use_kernel):
    """Per-shard: residuals -> point elimination -> partial (S, g_S, cost).

    Identical math to solvers/ba.py but returns the pieces to be psum-ed.
    """
    r, Jc, Jp, w, chi2, active = ba_core._edge_terms(
        prob.cam_Tcw, prob.points, prob, K, use_kernel
    )
    is_stereo = prob.obs_ur >= 0
    cost = ba_core._robust_cost(chi2, active, use_kernel, is_stereo)

    C = prob.cam_Tcw.shape[0]
    Pn, O = prob.obs_cam.shape
    Wr = w[..., None] * r
    Hpp = jnp.einsum("poij,po,poik->pjk", Jp, w, Jp)
    gp = jnp.einsum("poij,poi->pj", Jp, Wr)
    Hpp_d = Hpp + lam * jnp.eye(3) * jnp.maximum(
        jnp.trace(Hpp, axis1=-2, axis2=-1)[:, None, None] / 3.0, 1e-6
    )
    det, Hinv = ba_core.inv3x3_det(Hpp_d)
    det_ok = det > 1e-12
    Hpp_inv = jnp.where(det_ok[:, None, None], Hinv, 0.0)
    # one-hot matmul assembly (see solvers/ba.py)
    hi = jax.lax.Precision.HIGHEST
    Hcc_blk = jnp.einsum("poij,po,poik->pojk", Jc, w, Jc)
    gc_blk = jnp.einsum("poij,poi->poj", Jc, Wr)
    Wcp = jnp.einsum("poij,po,poik->pojk", Jc, w, Jp)
    cam_idx = prob.obs_cam
    E = jax.nn.one_hot(cam_idx, C, dtype=r.dtype)
    Nf = Pn * O
    Ef = E.reshape(Nf, C)
    S_diag = jnp.einsum("nc,nx->cx", Ef, Hcc_blk.reshape(Nf, 36), precision=hi).reshape(C, 6, 6)
    S = jnp.zeros((C, C, 6, 6)).at[jnp.arange(C), jnp.arange(C)].add(S_diag)
    Y = jnp.einsum("poik,pkl->poil", Wcp, Hpp_inv)
    GY = jnp.einsum("poc,poil->pcil", E, Y, precision=hi)
    GW = jnp.einsum("poc,poil->pcil", E, Wcp, precision=hi)
    S = S - jnp.einsum("pcil,pdjl->cdij", GY, GW, precision=hi)
    g_c = jnp.einsum("nc,nx->cx", Ef, gc_blk.reshape(Nf, 6), precision=hi)
    g_red = jnp.einsum("poil,pl->poi", Y, gp)
    g_S = g_c - jnp.einsum("nc,nx->cx", Ef, g_red.reshape(Nf, 6), precision=hi)
    return S, g_S, cost, (Hpp_inv, gp, Wcp)


def _solve_cams(S, g_S, prob: ba_core.BAProblem, lam):
    C = prob.cam_Tcw.shape[0]
    free = prob.cam_free
    eye6 = jnp.eye(6)
    S = S * (free[:, None, None, None] & free[None, :, None, None])
    S = S.at[jnp.arange(C), jnp.arange(C)].add(
        jnp.where(
            free[:, None, None],
            lam
            * eye6
            * jnp.maximum(
                jnp.trace(S[jnp.arange(C), jnp.arange(C)], axis1=-2, axis2=-1)[
                    :, None, None
                ]
                / 6.0,
                1e-6,
            ),
            eye6,
        )
    )
    g_S = g_S * free[:, None]
    Sd = S.transpose(0, 2, 1, 3).reshape(C * 6, C * 6)
    dx = jnp.linalg.solve(Sd, -g_S.reshape(C * 6))
    dx_cam = dx.reshape(C, 6)
    return jnp.where(
        free[:, None] & jnp.all(jnp.isfinite(dx_cam), -1, keepdims=True), dx_cam, 0.0
    )


def _solve_cams_pcg(S, g_S, prob: ba_core.BAProblem, lam, axis: str,
                    cg_iters: int, n_dev: int):
    """Distributed camera solve: the reduced system is REDUCE-SCATTERED
    over camera rows (each device owns C/D rows — 1/D the collective
    payload of a full psum) and solved by block-Jacobi-preconditioned CG.
    Per CG step the only collective is an all_gather of a [C, 6] vector;
    nothing O(C^2) is ever replicated and the (6C)^3 dense factorization
    disappears entirely (it serializes per-device at D devices).
    """
    C = prob.cam_Tcw.shape[0]
    eye6 = jnp.eye(6)
    # pad the camera-ROW axis to a multiple of the mesh size (padded rows
    # are "fixed": identity diagonal, zero rhs)
    Cp = ((C + n_dev - 1) // n_dev) * n_dev
    free = jnp.pad(prob.cam_free, (0, Cp - C))
    S = jnp.pad(S, ((0, Cp - C), (0, 0), (0, 0), (0, 0)))
    g_S = jnp.pad(g_S, ((0, Cp - C), (0, 0)))
    # scatter the summed system's camera-row axis across the mesh
    Sl = jax.lax.psum_scatter(S, axis, scatter_dimension=0, tiled=True)
    gl = jax.lax.psum_scatter(g_S, axis, scatter_dimension=0, tiled=True)
    Cl = Sl.shape[0]
    off = jax.lax.axis_index(axis) * Cl
    rows = off + jnp.arange(Cl)
    free_r = free[rows]
    Sl = Sl * (free_r[:, None, None, None] & free[None, :C, None, None])
    # damped diagonal (fixed rows pinned to identity)
    rows_c = jnp.clip(rows, 0, C - 1)
    diag = Sl[jnp.arange(Cl), rows_c]                     # [Cl, 6, 6]
    damp = lam * jnp.maximum(
        jnp.trace(diag, axis1=-2, axis2=-1)[:, None, None] / 6.0, 1e-6
    )
    diag = jnp.where(free_r[:, None, None], diag + damp * eye6, eye6)
    Sl = Sl.at[jnp.arange(Cl), rows_c].set(diag)
    b = jnp.where(free_r[:, None], -gl, 0.0)              # local rows of rhs
    b = jax.lax.all_gather(b, axis, tiled=True)[:C]       # [C, 6]

    # block-Jacobi preconditioner: per-camera 6x6 inverse (replicated,
    # trivially small)
    dall = jax.lax.all_gather(diag, axis, tiled=True)[:C]  # [C, 6, 6]
    ch = jax.scipy.linalg.cho_factor(
        dall + 1e-8 * eye6, lower=True
    )

    def precond(r):
        return jax.scipy.linalg.cho_solve(ch, r[..., None])[..., 0]

    def matvec(p):
        q = jnp.einsum("acij,cj->ai", Sl, p)              # [Cl, 6]
        return jax.lax.all_gather(q, axis, tiled=True)[:C]  # [C, 6]

    x0 = jnp.zeros((C, 6), S.dtype)
    r0 = b
    z0 = precond(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)

    def cg_step(carry, _):
        x, r, p, rz = carry
        Ap = matvec(p)
        pAp = jnp.sum(p * Ap)
        alpha = jnp.where(pAp > 1e-20, rz / pAp, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = jnp.where(rz > 1e-20, rz_new / rz, 0.0)
        p = z + beta * p
        return (x, r, p, rz_new), None

    (dx, _, _, _), _ = jax.lax.scan(
        cg_step, (x0, r0, p0, rz0), None, length=cg_iters
    )
    return jnp.where(
        free[:C, None] & jnp.all(jnp.isfinite(dx), -1, keepdims=True), dx, 0.0
    )


@partial(
    jax.jit,
    static_argnames=("mesh", "iters", "use_kernel", "camera_solver", "cg_iters"),
)
def sharded_bundle_adjust(
    prob: ba_core.BAProblem,
    K: Intrinsics,
    mesh: Mesh,
    iters: int = 10,
    use_kernel: bool = True,
    lam0: float = 1e-4,
    camera_solver: str = "direct",
    cg_iters: int = 48,
):
    """LM bundle adjustment with the point axis sharded over `mesh`'s
    'points' axis.

    camera_solver="direct": the [C,C,6,6] reduced system is psum-replicated
    and factorized densely on every device (exact; fine for small C).
    camera_solver="pcg": the system is reduce-SCATTERED over camera rows
    (1/D the collective payload) and solved by distributed block-Jacobi
    PCG — nothing O(C^2) replicated, no (6C)^3 factorization; the right
    choice once C or the device count grows.
    Returns (cam_Tcw, points, cost).
    """
    uk = jnp.asarray(use_kernel)
    pspec = P("points")
    spec_prob = ba_core.BAProblem(
        cam_Tcw=P(), cam_free=P(),
        points=pspec, point_valid=pspec,
        obs_cam=pspec, obs_uv=pspec, obs_ur=pspec,
        obs_inv_sigma2=pspec, obs_valid=pspec,
    )

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(spec_prob,),
        out_specs=(P(), pspec, P()),
        check_vma=False,
    )
    def run(p_shard: ba_core.BAProblem):
        def step(carry, _):
            cam, pts, lam, cost = carry
            local = p_shard._replace(cam_Tcw=cam, points=pts)
            S, g_S, _, (Hpp_inv, gp, Wcp) = _local_schur(local, K, lam, uk)
            if camera_solver == "pcg":
                dx_cam = _solve_cams_pcg(
                    S, g_S, local, lam, "points", cg_iters,
                    mesh.shape["points"],
                )
            else:
                S = jax.lax.psum(S, "points")
                g_S = jax.lax.psum(g_S, "points")
                dx_cam = _solve_cams(S, g_S, local, lam)
            cam_new = se3.exp_se3(dx_cam) @ cam
            dxc_obs = dx_cam[local.obs_cam]
            Hpc_dx = jnp.einsum("pojk,poj->pk", Wcp, dxc_obs)
            dp = jnp.einsum("pjk,pk->pj", Hpp_inv, -gp - Hpc_dx)
            dp = jnp.where(jnp.all(jnp.isfinite(dp), -1, keepdims=True), dp, 0.0)
            pts_new = pts + dp
            # global robust cost for accept/reject
            trial = p_shard._replace(cam_Tcw=cam_new, points=pts_new)
            *_, chi2, active = ba_core._edge_terms(cam_new, pts_new, trial, K, uk)
            new_cost = jax.lax.psum(
                ba_core._robust_cost(chi2, active, uk, trial.obs_ur >= 0), "points"
            )
            accept = new_cost < cost
            cam = jnp.where(accept, cam_new, cam)
            pts = jnp.where(accept, pts_new, pts)
            lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-9, 1e3)
            cost = jnp.where(accept, new_cost, cost)
            return (cam, pts, lam, cost), None

        *_, chi2_0, active_0 = ba_core._edge_terms(
            p_shard.cam_Tcw, p_shard.points, p_shard, K, uk
        )
        cost0 = jax.lax.psum(
            ba_core._robust_cost(chi2_0, active_0, uk, p_shard.obs_ur >= 0), "points"
        )
        (cam, pts, _, cost), _ = jax.lax.scan(
            step,
            (p_shard.cam_Tcw, p_shard.points, jnp.asarray(lam0), cost0),
            None,
            length=iters,
        )
        return cam, pts, cost

    return run(prob)


def make_points_mesh(n_devices: int | None = None) -> Mesh:
    import numpy as np

    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), ("points",))
