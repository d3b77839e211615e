"""Sim(3) pose-graph ("essential graph") optimization.

Replaces `Optimizer::OptimizeEssentialGraph` (reference
src/Optimizer.cc:773-1039): 7-DoF Sim3 vertices per keyframe, edges from
loop closures, the spanning tree, and strong covisibilities (weight >= 100,
minFeat at :800), Gauss-Newton with tangent-space updates, then Sim3 -> SE3
recovery ([R, t/s], :1000-1010) and landmark re-mapping (:1012-1039).

Design: the edge residual e = log(S_meas_ji o S_i o S_j^-1) and its
Jacobians (forward-mode, vmapped over edges) are batched. Two inner
solvers share that machinery:

* optimize_pose_graph — dense [7K, 7K] assembly + direct solve; for
  loop-neighbourhood sizes (K <= ~128);
* optimize_pose_graph_pcg — matrix-free block-Jacobi preconditioned CG,
  O(E * cg_iters) per GN iteration with one-hot-matmul scatters; the
  scalable path for KITTI-length graphs and the edge-sharded distributed
  solver (parallel/sharded_pose_graph.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam2_tpu.geometry import se3, sim3


class PoseGraphProblem(NamedTuple):
    vertices: jnp.ndarray    # [K, 8] packed sim3 S_iw (world -> cam i)
    vertex_valid: jnp.ndarray  # [K] bool
    vertex_fixed: jnp.ndarray  # [K] bool (loop KF fixed; reference :822)
    edge_i: jnp.ndarray      # [E] int32
    edge_j: jnp.ndarray      # [E] int32
    edge_meas: jnp.ndarray   # [E, 8] packed S_ji measurement (cam i -> cam j)
    edge_valid: jnp.ndarray  # [E] bool
    edge_weight: jnp.ndarray  # [E] float (1.0 normal, boost for loop edges)


def _edge_residual(delta_i, delta_j, Si_pack, Sj_pack, meas_pack):
    """e = log(S_meas_ji o (exp(di) o S_i) o (exp(dj) o S_j)^-1) [7]."""
    Si = sim3.compose(sim3.exp(delta_i), sim3.unpack(Si_pack))
    Sj = sim3.compose(sim3.exp(delta_j), sim3.unpack(Sj_pack))
    Sji = sim3.unpack(meas_pack)
    err = sim3.compose(sim3.compose(Sji, Si), sim3.inverse(Sj))
    return sim3.log(err)


@partial(jax.jit, static_argnames=("iters",))
def optimize_pose_graph(prob: PoseGraphProblem, iters: int = 20) -> jnp.ndarray:
    """Returns optimized packed sim3 vertices [K, 8]."""
    K = prob.vertices.shape[0]

    def gn_iter(verts, _):
        H, g = edge_system(
            verts, prob.edge_i, prob.edge_j, prob.edge_meas,
            prob.edge_valid, prob.edge_weight, prob.vertex_fixed, K,
        )
        free = prob.vertex_valid & ~prob.vertex_fixed
        dx = damp_and_solve(H, g, free)
        return apply_update(verts, dx), None

    verts, _ = jax.lax.scan(gn_iter, prob.vertices, None, length=iters)
    return verts


def edge_jacobians(verts, edge_i, edge_j, edge_meas, edge_valid, edge_weight,
                   vertex_fixed):
    """Per-edge weighted residuals and Jacobian blocks:
    (rw [E,7], Ji [E,7,7], Jj [E,7,7]), gated so padding/fixed
    contributions are exactly zero. Shared by the dense assembly
    (edge_system) and the matrix-free PCG path (pcg_solve)."""
    zero7 = jnp.zeros(7)

    def jac_fn(Si_p, Sj_p, m_p):
        Ji = jax.jacfwd(_edge_residual, argnums=0)(zero7, zero7, Si_p, Sj_p, m_p)
        Jj = jax.jacfwd(_edge_residual, argnums=1)(zero7, zero7, Si_p, Sj_p, m_p)
        r = _edge_residual(zero7, zero7, Si_p, Sj_p, m_p)
        return r, Ji, Jj

    Si_p = verts[edge_i]
    Sj_p = verts[edge_j]
    r, Ji, Jj = jax.vmap(jac_fn)(Si_p, Sj_p, edge_meas)  # [E,7], [E,7,7] x2
    w = jnp.where(edge_valid, edge_weight, 0.0)
    free_i = ~vertex_fixed[edge_i]
    free_j = ~vertex_fixed[edge_j]
    # gate with where, not multiply: a disabled PADDING edge (i == j,
    # identity measurement) has a NaN Jacobian at log(identity), and
    # NaN * 0 stays NaN
    wf_i = (w * free_i)[:, None, None]
    wf_j = (w * free_j)[:, None, None]
    Ji = jnp.where(wf_i > 0, Ji * wf_i, 0.0)
    Jj = jnp.where(wf_j > 0, Jj * wf_j, 0.0)
    rw = jnp.where(w[:, None] > 0, r * w[:, None], 0.0)
    return rw, Ji, Jj


def edge_system(verts, edge_i, edge_j, edge_meas, edge_valid, edge_weight,
                vertex_fixed, K: int):
    """Assemble the DENSE Gauss-Newton normal equations (H [K,K,7,7],
    g [K,7]) from a batch of Sim3 edges. Used by the small-K direct solver;
    large graphs use the matrix-free PCG path instead."""
    rw, Ji, Jj = edge_jacobians(
        verts, edge_i, edge_j, edge_meas, edge_valid, edge_weight, vertex_fixed
    )

    H = jnp.zeros((K, K, 7, 7))
    ii = edge_i
    jj = edge_j
    H = H.at[ii, ii].add(jnp.einsum("eai,eaj->eij", Ji, Ji))
    H = H.at[jj, jj].add(jnp.einsum("eai,eaj->eij", Jj, Jj))
    Hij = jnp.einsum("eai,eaj->eij", Ji, Jj)
    H = H.at[ii, jj].add(Hij)
    H = H.at[jj, ii].add(jnp.swapaxes(Hij, -1, -2))
    g = jnp.zeros((K, 7))
    g = g.at[ii].add(jnp.einsum("eai,ea->ei", Ji, rw))
    g = g.at[jj].add(jnp.einsum("eai,ea->ei", Jj, rw))
    return H, g


def damp_and_solve(H, g, free):
    """Mask fixed/invalid vertices, add trace-scaled damping, dense solve.
    Returns the tangent update dx [K, 7]."""
    K = g.shape[0]
    eye7 = jnp.eye(7)
    H = H * (free[:, None, None, None] & free[None, :, None, None])
    diag = jnp.arange(K)
    tr = jnp.trace(H[diag, diag], axis1=-2, axis2=-1)
    H = H.at[diag, diag].add(
        jnp.where(
            free[:, None, None],
            1e-6 * eye7 * jnp.maximum(tr[:, None, None] / 7.0, 1e-6) + 1e-8 * eye7,
            eye7,
        )
    )
    g = g * free[:, None]

    Hd = H.transpose(0, 2, 1, 3).reshape(7 * K, 7 * K)
    dx = jnp.linalg.solve(Hd, -g.reshape(7 * K)).reshape(K, 7)
    return jnp.where(
        free[:, None] & jnp.all(jnp.isfinite(dx), -1, keepdims=True), dx, 0.0
    )


# ---------------------------------------------------------------------------
# Matrix-free preconditioned CG (the scalable path).
#
# The dense path above assembles a [K,K,7,7] system and solves (7K)^3 — fine
# for loop-closure neighbourhoods, hopeless for KITTI-length graphs (round-2
# SCALING artifact: the replicated dense solve ANTI-scaled 1 -> 8 devices).
# PCG never forms H: each CG step is one gather + two [E,7,7]x[E,7] batched
# products + one scatter-add, O(E*49) FLOPs and a [K,7] vector as the only
# cross-device reduction. Preconditioner: block-Jacobi on the damped 7x7
# diagonal blocks (the reference's g2o exploits the same sparsity with a
# sparse Cholesky, /root/reference/src/Optimizer.cc:783-787).
# ---------------------------------------------------------------------------


def incidence_onehot(edge_i, edge_j, K: int):
    """One-hot incidence matrices (A_i [K,E], A_j [K,E]): the edge->vertex
    scatter-adds in the PCG path become matmuls on these (same trick as
    solvers/ba.py's camera-system assembly)."""
    rows = jnp.arange(K, dtype=edge_i.dtype)[:, None]
    Ai = (edge_i[None, :] == rows).astype(jnp.float32)
    Aj = (edge_j[None, :] == rows).astype(jnp.float32)
    return Ai, Aj


def assemble_diag_g(Ji, Jj, Ai, Aj, rw):
    """Block-diagonal of H and the gradient from per-edge Jacobians:
    (D [K,7,7], g [K,7]); Ai/Aj from incidence_onehot."""
    D = jnp.einsum("ke,eij->kij", Ai, jnp.einsum("eai,eaj->eij", Ji, Ji))
    D = D + jnp.einsum("ke,eij->kij", Aj, jnp.einsum("eai,eaj->eij", Jj, Jj))
    g = jnp.einsum("ke,ei->ki", Ai, jnp.einsum("eai,ea->ei", Ji, rw))
    g = g + jnp.einsum("ke,ei->ki", Aj, jnp.einsum("eai,ea->ei", Jj, rw))
    return D, g


def block_jacobi_precond(D, free):
    """Damped block-Jacobi preconditioner: (M_inv [K,7,7], damp [K]).
    `damp` is the scalar added to each free vertex's diagonal (same
    trace-scaled rule as damp_and_solve); fixed/invalid vertices get an
    identity block so their (zeroed) residual maps to zero update."""
    eye7 = jnp.eye(7)
    tr = jnp.trace(D, axis1=-2, axis2=-1)
    damp = jnp.where(free, 1e-6 * jnp.maximum(tr / 7.0, 1e-6) + 1e-8, 1.0)
    M = jnp.where(free[:, None, None], D, 0.0) + damp[:, None, None] * eye7
    L = jnp.linalg.cholesky(M)
    ok = jnp.all(jnp.isfinite(L.reshape(L.shape[0], -1)), axis=-1)
    L = jnp.where(ok[:, None, None], L, eye7)
    inv_eye = jnp.broadcast_to(eye7, M.shape)
    y = jax.lax.linalg.triangular_solve(
        L, inv_eye, left_side=True, lower=True
    )
    M_inv = jax.lax.linalg.triangular_solve(
        L, y, left_side=True, lower=True, transpose_a=True
    )
    M_inv = jnp.where(ok[:, None, None], M_inv, eye7)
    return M_inv, damp


def pcg_solve(Ji, Jj, edge_i, edge_j, Ai, Aj, D, g, free, cg_iters: int,
              reduce_fn=None):
    """Solve H dx = -g by preconditioned CG without forming H. Ai/Aj are
    the one-hot incidence matrices (incidence_onehot) used for the
    edge->vertex scatter (a matmul instead of a scatter-add); the
    vertex->edge side stays an indexed gather (cheap everywhere).
    `reduce_fn` sums partial [K,7] products across an edge-sharded mesh
    (psum inside shard_map); None on a single device. Returns dx [K,7]."""
    M_inv, damp = block_jacobi_precond(D, free)
    fm = free[:, None]

    def matvec(x):
        xw = jnp.where(fm, x, 0.0)
        t = (
            jnp.einsum("eab,eb->ea", Ji, xw[edge_i])
            + jnp.einsum("eab,eb->ea", Jj, xw[edge_j])
        )
        y = jnp.einsum("ke,eb->kb", Ai, jnp.einsum("eab,ea->eb", Ji, t))
        y = y + jnp.einsum("ke,eb->kb", Aj, jnp.einsum("eab,ea->eb", Jj, t))
        if reduce_fn is not None:
            y = reduce_fn(y)
        return jnp.where(fm, y + damp[:, None] * x, 0.0)

    def precond(r):
        return jnp.where(fm, jnp.einsum("kab,kb->ka", M_inv, r), 0.0)

    b = jnp.where(fm, -g, 0.0)
    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    rz0 = jnp.vdot(r0, z0)
    eps = 1e-20

    def cg_step(carry, _):
        x, r, z, p, rz = carry
        Ap = matvec(p)
        pAp = jnp.vdot(p, Ap)
        alive = (rz > eps) & (pAp > eps)
        alpha = jnp.where(alive, rz / jnp.maximum(pAp, eps), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.vdot(r, z)
        beta = jnp.where(alive, rz_new / jnp.maximum(rz, eps), 0.0)
        p = jnp.where(alive, z + beta * p, p)
        return (x, r, z, p, jnp.where(alive, rz_new, 0.0)), None

    (dx, _, _, _, _), _ = jax.lax.scan(
        cg_step, (x0, r0, z0, z0, rz0), None, length=cg_iters
    )
    return jnp.where(
        fm & jnp.all(jnp.isfinite(dx), -1, keepdims=True), dx, 0.0
    )


@partial(jax.jit, static_argnames=("iters", "cg_iters"))
def optimize_pose_graph_pcg(
    prob: PoseGraphProblem, iters: int = 20, cg_iters: int = 64
) -> jnp.ndarray:
    """Scalable essential-graph optimization: Gauss-Newton with a
    matrix-free block-Jacobi PCG inner solve. O(iters * cg_iters * E * 49)
    instead of O(iters * (7K)^3); agrees with optimize_pose_graph at
    convergence. Returns optimized packed sim3 vertices [K, 8]."""
    free = prob.vertex_valid & ~prob.vertex_fixed
    K = prob.vertices.shape[0]
    Ai, Aj = incidence_onehot(prob.edge_i, prob.edge_j, K)

    def gn_iter(verts, _):
        rw, Ji, Jj = edge_jacobians(
            verts, prob.edge_i, prob.edge_j, prob.edge_meas,
            prob.edge_valid, prob.edge_weight, prob.vertex_fixed,
        )
        D, g = assemble_diag_g(Ji, Jj, Ai, Aj, rw)
        dx = pcg_solve(Ji, Jj, prob.edge_i, prob.edge_j, Ai, Aj, D, g,
                       free, cg_iters)
        return apply_update(verts, dx), None

    verts, _ = jax.lax.scan(gn_iter, prob.vertices, None, length=iters)
    return verts


def apply_update(verts, dx):
    return jax.vmap(
        lambda d, v: sim3.pack(sim3.compose(sim3.exp(d), sim3.unpack(v)))
    )(dx, verts)


def se3_to_pack(Tcw: jnp.ndarray) -> jnp.ndarray:
    """[..., 4, 4] -> packed sim3 with s = 1."""
    return sim3.pack(sim3.from_se3(Tcw))


def pack_to_se3(packed: jnp.ndarray) -> jnp.ndarray:
    """Packed sim3 -> SE3 with scale folded into translation
    (reference src/Optimizer.cc:1000-1010)."""
    return sim3.to_se3(sim3.unpack(packed))


def remap_points(
    points: jnp.ndarray,
    ref_kf: jnp.ndarray,
    old_pack: jnp.ndarray,
    new_pack: jnp.ndarray,
) -> jnp.ndarray:
    """Carry landmarks through their reference keyframe's correction:
    p' = S_new^-1(S_old(p)) (reference src/Optimizer.cc:1012-1039)."""
    K = old_pack.shape[0]
    ref = jnp.clip(ref_kf, 0, K - 1)
    S_old = sim3.unpack(old_pack[ref])
    S_new = sim3.unpack(new_pack[ref])
    return sim3.apply(sim3.inverse(S_new), sim3.apply(S_old, points))
