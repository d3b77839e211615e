"""Distributed place-recognition scoring over a device mesh.

The keyframe database is one dense [K, V] BoW matrix (vocab/database.py);
a loop/relocalization query is a [K, V] x [V] scoring broadcast plus a
covisibility group accumulation. At KITTI scale (K >= 1024, V = 4096) the
scoring row-sweep and the [K, K] group matmul are the heavy terms, and
both are row-shardable:

* DATABASE ROWS (keyframes) are sharded across the mesh's ``kfs`` axis —
  each device scores the query against its keyframe slice and accumulates
  group scores with its covisibility row block;
* the per-shard score vectors are `all_gather`-ed (K floats — tiny) so the
  0.75-of-best candidate selection runs replicated.

Matches `vocab/database._query` exactly on any mesh (scoring is
elementwise per row; no reduction reordering).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from orbslam2_tpu.vocab import bow


@partial(jax.jit, static_argnames=("mesh", "max_candidates"))
def sharded_query(
    vectors, present, vec, exclude_mask, min_score, covis, mesh: Mesh,
    max_candidates: int = 8,
):
    """Row-sharded loop/reloc candidate query (semantics of
    vocab/database._query; reference DetectLoopCandidates,
    src/KeyFrameDatabase.cc:87-215). K must be a multiple of the mesh
    size. Returns (cand_ids [C], cand_mask [C], scores [K]), replicated."""
    kspec = P("kfs")

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(kspec, kspec, P(), kspec, P(), kspec),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )
    def run(vecs_l, present_l, q, excl_l, min_s, covis_l):
        scores_l = bow.l1_score(q, vecs_l)  # [K/n] local rows
        ok_l = present_l & ~excl_l & (scores_l >= min_s)
        scores_ok_l = jnp.where(ok_l, scores_l, 0.0)
        # pack (ok, scores) into ONE [K/n, 2] gather: at this scale the
        # query is collective-latency-bound, not bandwidth-bound
        g1 = jax.lax.all_gather(
            jnp.stack([ok_l.astype(jnp.float32), scores_l], axis=1),
            "kfs", axis=0, tiled=True,
        )
        ok = g1[:, 0] > 0.5
        scores = g1[:, 1]
        K = scores.shape[0]
        L = covis_l.shape[0]
        # top-10 covisibility group per LOCAL row (reference accScore over
        # GetBestCovisibilityKeyFrames(10), src/KeyFrameDatabase.cc:170-196)
        ng = min(10, K)
        top_w, top_idx = jax.lax.top_k(covis_l, ng)  # [K/n, ng]
        neigh_ok = ok[top_idx] & (top_w > 0)
        neigh_scores = jnp.where(neigh_ok, scores[top_idx], 0.0)
        acc_l = scores_ok_l + neigh_scores.sum(-1)
        # group representative = best-scoring member (reference pBestKF)
        best_n = jnp.argmax(neigh_scores, axis=-1)
        best_n_score = jnp.take_along_axis(neigh_scores, best_n[:, None], 1)[:, 0]
        rows_g = jax.lax.axis_index("kfs") * L + jnp.arange(L)
        rep_l = jnp.where(
            best_n_score > scores_ok_l, top_idx[jnp.arange(L), best_n], rows_g
        )
        # second (and last) collective: (acc, rep) packed the same way
        # (rep is a keyframe index, exact in f32 for any realistic K)
        g2 = jax.lax.all_gather(
            jnp.stack([acc_l, rep_l.astype(jnp.float32)], axis=1),
            "kfs", axis=0, tiled=True,
        )
        acc = g2[:, 0]
        rep = g2[:, 1].astype(jnp.int32)
        acc = jnp.where(ok, acc, -1.0)
        best = jnp.max(acc)
        admit_group = ok & (acc >= 0.75 * best) & (best > 0)
        rep_w = jnp.where(admit_group, rep, K)
        rep_acc = (
            jnp.full((K + 1,), -jnp.inf)
            .at[rep_w].max(jnp.where(admit_group, acc, -jnp.inf))[:K]
        )
        admit = rep_acc > -jnp.inf
        order = jnp.argsort(jnp.where(admit, -rep_acc, jnp.inf))
        cand = order[:max_candidates]
        return cand.astype(jnp.int32), admit[cand], scores

    return run(vectors, present, vec, exclude_mask, jnp.float32(min_score), covis)


def make_kfs_mesh(n_devices: int | None = None) -> Mesh:
    import numpy as np

    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.asarray(devs[:n]), ("kfs",))
