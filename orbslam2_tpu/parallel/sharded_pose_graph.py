"""Distributed Sim(3) pose-graph optimization over a device mesh.

The essential-graph optimization (reference src/Optimizer.cc:773-1039) is
edge-dominated: each Gauss-Newton iteration evaluates a residual and two
7x7 Jacobian blocks per edge. For KITTI-length trajectories (K >= 1024,
E in the thousands) the edge work is the scalable axis:

* EDGES are sharded across the mesh's ``edges`` axis — each device runs
  the forward-mode Jacobian sweep (the expensive term: jacfwd through
  sim3 log/exp per edge) over its slice only;
* the per-edge blocks are `all_gather`-ed ONCE per GN iteration (one
  [E, 105] payload: Ji + Jj + rw) and the block-Jacobi PCG inner solve
  runs REPLICATED with zero collectives. The round-4 design kept the
  blocks local and psum'd a [K, 7] Hessian-vector product per CG step —
  iters * cg_iters = 1280 latency-bound collectives; this design issues
  `iters` collectives total. The replicated CG compute is trivial (~E * 4 * 49
  FLOPs per step); the scalable axis — the Jacobian sweep — still
  distributes. (Round 2's all-replicated dense assembly anti-scaled for a
  different reason: a 49 K^2-float psum + (7K)^3 factorization.)

Same jitted step on 1 device or N (SURVEY.md §4 mesh-parametrized
testing); matches `solvers/pose_graph.optimize_pose_graph_pcg` BIT-FOR-BIT
on any mesh size: the tiled all_gather reassembles the edge blocks in
their original order, so no reduction is ever reordered.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from orbslam2_tpu.solvers import pose_graph as pg


@partial(jax.jit, static_argnames=("mesh", "iters", "cg_iters", "inner"))
def sharded_optimize_pose_graph(
    prob: pg.PoseGraphProblem, mesh: Mesh, iters: int = 20,
    cg_iters: int = 64, inner: str = "gathered",
) -> jnp.ndarray:
    """Edge-sharded pose-graph GN with a matrix-free PCG inner solve.
    `prob.edge_*` arrays must have length a multiple of the mesh size (pad
    with edge_valid=False rows). Returns optimized packed sim3 vertices
    [K, 8] (replicated).

    Two inner-solve strategies — the right one depends on what the mesh's
    links actually are:

    * ``inner="gathered"`` (default, for real devices): ONE tiled
      all_gather of the per-edge Jacobian blocks per GN iteration, then
      the whole PCG runs REPLICATED with zero collectives. `iters`
      collectives total; the replicated CG compute (~2·K·E·7 FLOP/step)
      is cheap on real devices, which all run it concurrently. Bit-identical
      to the single-device solve (the tiled gather preserves edge order).
    * ``inner="stepped"``: per-edge blocks stay LOCAL and every CG step
      psums a [K,7] Hessian-vector product — iters·cg_iters collectives,
      but the CG compute is fully distributed. On a VIRTUAL CPU mesh
      (xla_force_host_platform_device_count, one physical socket) this is
      the faster mode: collectives there are memcpys while replicated
      compute multiplies real work on the shared CPU. On real devices
      "gathered" is the design (the [K,7] psum is latency-bound at 1280
      round trips).
    """
    K = prob.vertices.shape[0]
    espec = P("edges")

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), espec, espec, espec, espec, espec, P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(verts0, vfixed, vvalid, ei, ej, emeas, evalid, eweight,
            ei_full, ej_full):
        free = vvalid & ~vfixed

        if inner == "gathered":
            # FULL incidence: the inner solve runs replicated over all edges
            Ai_f, Aj_f = pg.incidence_onehot(ei_full, ej_full, K)

            def gn_iter(verts, _):
                # distributed: the forward-mode Jacobian sweep on the slice
                rw, Ji, Jj = pg.edge_jacobians(
                    verts, ei, ej, emeas, evalid, eweight, vfixed
                )
                payload = jnp.concatenate(
                    [Ji.reshape(-1, 49), Jj.reshape(-1, 49), rw], axis=1
                )
                payload = jax.lax.all_gather(
                    payload, "edges", axis=0, tiled=True
                )
                Ji_f = payload[:, :49].reshape(-1, 7, 7)
                Jj_f = payload[:, 49:98].reshape(-1, 7, 7)
                rw_f = payload[:, 98:]
                D, g = pg.assemble_diag_g(Ji_f, Jj_f, Ai_f, Aj_f, rw_f)
                dx = pg.pcg_solve(
                    Ji_f, Jj_f, ei_full, ej_full, Ai_f, Aj_f, D, g, free,
                    cg_iters,
                )
                return pg.apply_update(verts, dx), None
        else:
            Ai, Aj = pg.incidence_onehot(ei, ej, K)  # local edge slice

            def gn_iter(verts, _):
                rw, Ji, Jj = pg.edge_jacobians(
                    verts, ei, ej, emeas, evalid, eweight, vfixed
                )
                D, g = pg.assemble_diag_g(Ji, Jj, Ai, Aj, rw)
                D = jax.lax.psum(D, "edges")
                g = jax.lax.psum(g, "edges")
                dx = pg.pcg_solve(
                    Ji, Jj, ei, ej, Ai, Aj, D, g, free, cg_iters,
                    reduce_fn=lambda y: jax.lax.psum(y, "edges"),
                )
                return pg.apply_update(verts, dx), None

        verts, _ = jax.lax.scan(gn_iter, verts0, None, length=iters)
        return verts

    return run(
        prob.vertices, prob.vertex_fixed, prob.vertex_valid,
        prob.edge_i, prob.edge_j, prob.edge_meas,
        prob.edge_valid, prob.edge_weight,
        prob.edge_i, prob.edge_j,
    )


def make_edges_mesh(n_devices: int | None = None) -> Mesh:
    import numpy as np

    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), ("edges",))


def pad_edges(prob: pg.PoseGraphProblem, n_devices: int) -> pg.PoseGraphProblem:
    """Pad the edge arrays to a multiple of the mesh size with invalid rows."""
    E = prob.edge_i.shape[0]
    pad = (-E) % n_devices
    if pad == 0:
        return prob
    zi = jnp.zeros(pad, prob.edge_i.dtype)
    return prob._replace(
        edge_i=jnp.concatenate([prob.edge_i, zi]),
        edge_j=jnp.concatenate([prob.edge_j, zi]),
        edge_meas=jnp.concatenate(
            [prob.edge_meas, jnp.tile(pg.se3_to_pack(jnp.eye(4))[None], (pad, 1))]
        ),
        edge_valid=jnp.concatenate([prob.edge_valid, jnp.zeros(pad, bool)]),
        edge_weight=jnp.concatenate([prob.edge_weight, jnp.zeros(pad)]),
    )
