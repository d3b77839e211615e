"""Bag-of-binary-words vocabulary as a flat codebook + dense scoring.

Replaces DBoW2 (reference include/ORBVocabulary.h, the ~1M-leaf
branching-10 depth-6 tree loaded from a 100 MB text file at startup,
src/System.cc:65-72). Dense redesign:

* the hierarchical tree exists to make CPU lookups O(B*L); on the device a
  FLAT codebook of V binary centers is both simpler and exact — assignment
  is one [N, V] Hamming matrix (XOR+popcount, or the +-1 matmul variant);
* the vocabulary is trained by binary k-medians (bitwise-majority centers)
  on descriptors sampled from the running session or a dataset — no
  shipped vocabulary file needed (and none is available offline);
* BoW vectors are L1-normalized term-frequency histograms [V]; similarity
  is the DBoW2 L1 score s = 1 - 0.5 * |v1 - v2|_1 (reference
  DBoW2::L1Scoring), computed for a query against every keyframe row in
  one broadcast.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from orbslam2_tpu.ops import hamming


class Codebook(NamedTuple):
    """Two-level vocabulary: coarse cells, then per-cell fine words —
    effective size C*F (the dense-matmul shape of the reference's branching-10
    hierarchical DBoW2 tree, include/ORBVocabulary.h:25-31). Assignment
    stays two bounded Hamming matmuls ([N,C] then per-row [N,F]) instead
    of one [N, C*F] blowup. A flat codebook is the degenerate C=1 case."""

    coarse: jnp.ndarray   # [C, 8] uint32
    fine: jnp.ndarray     # [C, F, 8] uint32

    @property
    def num_words(self) -> int:
        return self.coarse.shape[0] * self.fine.shape[1]


def num_words(codebook) -> int:
    """Effective vocabulary size for either representation."""
    if isinstance(codebook, Codebook):
        return codebook.num_words
    return codebook.shape[0]


def _unpack_bits_i32(desc: jnp.ndarray) -> jnp.ndarray:
    """[N, 8] uint32 -> [N, 256] int32 in {0, 1}."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    return bits.reshape(desc.shape[0], 256).astype(jnp.int32)


def _pack_bits_u32(bits: jnp.ndarray) -> jnp.ndarray:
    """[V, 256] {0,1} -> [V, 8] uint32."""
    b = bits.astype(jnp.uint32).reshape(bits.shape[0], 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(b << shifts[None, None, :], axis=-1, dtype=jnp.uint32)


@partial(jax.jit, static_argnames=("vocab_size", "iters"))
def train_codebook(
    descs: jnp.ndarray,
    valid: jnp.ndarray,
    key: jnp.ndarray,
    vocab_size: int = 1024,
    iters: int = 8,
) -> jnp.ndarray:
    """Binary k-medians: returns codebook [V, 8] uint32.

    Centers update by bitwise majority of assigned descriptors; empty
    clusters are re-seeded from random descriptors.
    """
    N = descs.shape[0]
    nv = jnp.sum(valid)
    # uniform fallback when no member is valid (empty two-level cell):
    # keeps random.choice well-defined; the resulting codebook is never
    # preferred at query time but must not be NaN-driven garbage
    prob = jnp.where(
        nv > 0,
        valid.astype(jnp.float32) / jnp.maximum(nv, 1),
        jnp.full((N,), 1.0 / N, jnp.float32),
    )
    init_idx = jax.random.choice(key, N, shape=(vocab_size,), replace=True, p=prob)
    centers = descs[init_idx]
    bits = _unpack_bits_i32(descs)  # [N, 256]

    def step(carry, k):
        centers, = carry
        d = hamming.distance_matrix(descs, centers)            # [N, V]
        d = jnp.where(valid[:, None], d, 1 << 20)
        assign = jnp.argmin(d, axis=1)                          # [N]
        # majority vote per cluster per bit
        onehot_counts = jnp.zeros((vocab_size,), jnp.int32).at[assign].add(
            valid.astype(jnp.int32)
        )
        bit_sums = jnp.zeros((vocab_size, 256), jnp.int32).at[assign].add(
            jnp.where(valid[:, None], bits, 0)
        )
        maj = (2 * bit_sums >= onehot_counts[:, None]).astype(jnp.int32)
        new_centers = _pack_bits_u32(maj)
        # reseed empties
        reseed = jax.random.choice(
            jax.random.fold_in(key, k), N, shape=(vocab_size,), replace=True, p=prob
        )
        empty = onehot_counts == 0
        new_centers = jnp.where(empty[:, None], descs[reseed], new_centers)
        return (new_centers,), None

    (centers,), _ = jax.lax.scan(step, (centers,), jnp.arange(iters))
    return centers


@partial(jax.jit, static_argnames=("coarse_size", "fine_size", "iters",
                                   "bucket_cap"))
def train_codebook2(
    descs: jnp.ndarray,
    valid: jnp.ndarray,
    key: jnp.ndarray,
    coarse_size: int = 256,
    fine_size: int = 64,
    iters: int = 6,
    bucket_cap: int = 4096,
) -> Codebook:
    """Two-level binary k-medians: coarse cells over the whole sample,
    then an independent fine codebook per cell on that cell's members
    (the recursive k-means of DBoW2's tree construction, two levels).

    Members are bucketed per cell via one sort + segment-rank scatter
    (bounded at bucket_cap per cell) so the per-cell trainings run on
    [bucket_cap, fine_size] distance matrices inside one lax.map — not a
    [N, C*F] blowup and not a 256x masked waste over the full sample."""
    N = descs.shape[0]
    C = coarse_size
    M = bucket_cap
    coarse = train_codebook.__wrapped__(
        descs, valid, key, vocab_size=C, iters=iters
    )
    d = hamming.distance_matrix(descs, coarse)
    cell = jnp.where(valid, jnp.argmin(d, axis=1), C)
    order = jnp.argsort(cell)
    sd = descs[order]
    sc = cell[order]
    idx = jnp.arange(N)
    rank = idx - jnp.searchsorted(sc, sc, side="left")
    ok = (sc < C) & (rank < M)
    sc_w = jnp.where(ok, sc, C)
    rank_w = jnp.where(ok, rank, 0)
    bucket = (
        jnp.zeros((C + 1, M, 8), jnp.uint32)
        .at[sc_w, rank_w].set(sd, mode="drop")[:C]
    )
    bvalid = (
        jnp.zeros((C + 1, M), bool)
        .at[sc_w, rank_w].set(ok, mode="drop")[:C]
    )

    def fine_one(args):
        b, v, j = args
        return train_codebook.__wrapped__(
            b, v, jax.random.fold_in(key, j), vocab_size=fine_size,
            iters=iters,
        )

    fine = jax.lax.map(
        fine_one, (bucket, bvalid, jnp.arange(C, dtype=jnp.int32))
    )
    return Codebook(coarse=coarse, fine=fine)


def _assign2(descs: jnp.ndarray, cb: Codebook) -> jnp.ndarray:
    """Two-level word assignment [N] -> cell * F + fine."""
    F = cb.fine.shape[1]
    c = jnp.argmin(hamming.distance_matrix(descs, cb.coarse), axis=1)
    fsel = cb.fine[c]                                  # [N, F, 8]
    d2 = hamming.distance(descs[:, None, :], fsel)     # [N, F]
    f = jnp.argmin(d2, axis=1)
    return (c * F + f).astype(jnp.int32)


@jax.jit
def bow_vector(descs: jnp.ndarray, valid: jnp.ndarray, codebook,
               idf=None) -> jnp.ndarray:
    """L1-normalized tf (or tf-idf) word histogram [V] (the reference's
    BowVector via vocabulary transform, src/Frame.cc:425-433; DBoW2's
    default weighting is TF_IDF with L1 norm — TemplatedVocabulary.h).
    Accepts a flat [V, 8] codebook or a two-level Codebook; `idf` is the
    per-word inverse-document-frequency weight trained offline with the
    vocabulary (tools/train_vocab.py) — None = tf-only (the session-
    trained fallback, which has no document corpus)."""
    if isinstance(codebook, Codebook):
        V = codebook.num_words
        assign = _assign2(descs, codebook)
    else:
        V = codebook.shape[0]
        d = hamming.distance_matrix(descs, codebook)
        assign = jnp.argmin(d, axis=1)
    hist = jnp.zeros((V,), jnp.float32).at[assign].add(valid.astype(jnp.float32))
    if idf is not None:
        hist = hist * idf
    return hist / jnp.maximum(jnp.sum(hist), 1e-9)


@jax.jit
def word_ids(descs: jnp.ndarray, codebook) -> jnp.ndarray:
    """Per-feature word assignment [N] (the FeatureVector analogue used to
    bucket brute-force matching, reference src/ORBmatcher.cc:552)."""
    if isinstance(codebook, Codebook):
        return _assign2(descs, codebook)
    return jnp.argmin(hamming.distance_matrix(descs, codebook), axis=1).astype(jnp.int32)


def l1_score(v1: jnp.ndarray, v2: jnp.ndarray) -> jnp.ndarray:
    """DBoW2 L1 similarity in [0, 1]; broadcasts over leading dims of v2."""
    return 1.0 - 0.5 * jnp.sum(jnp.abs(v1 - v2), axis=-1)
