"""Batched two-view DLT triangulation.

Replaces the reference's per-point 4x4 SVD (`Initializer::Triangulate`,
reference src/Initializer.cc:804-818; also used in
`LocalMapping::CreateNewMapPoints`, src/LocalMapping.cc:355-370) with one
batched linear solve over all candidate matches at once instead of N tiny
SVDs in a loop.
"""

from __future__ import annotations

import jax.numpy as jnp

from orbslam2_tpu.geometry.camera import Intrinsics


def _projection_matrix(Tcw: jnp.ndarray, K: Intrinsics) -> jnp.ndarray:
    """P = K [R | t] as [..., 3, 4]."""
    return jnp.einsum("ij,...jk->...ik", K.K, Tcw[..., :3, :4])


def triangulate_dlt(
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    P1: jnp.ndarray,
    P2: jnp.ndarray,
) -> jnp.ndarray:
    """DLT triangulation, batched.

    Args:
      uv1, uv2: pixel coords in each view, [..., 2].
      P1, P2: 3x4 projection matrices (broadcast against batch dims).

    Returns:
      World points [..., 3].

    The 4x4 homogeneous system A x = 0 is solved INHOMOGENEOUSLY (w = 1):
    minimize |B p + c|^2 with B = A[:, :3], c = A[:, 3] via the 3x3 normal
    equations and a closed-form adjugate inverse (elementwise math that
    fuses into one kernel, where a batched `eigh` on [N,4,4] is a
    per-matrix solver loop). Only points at infinity (w ~ 0) lose accuracy, and those fail the
    caller's cheirality/chi2/scale gates anyway; near-singular systems
    (parallel rays) return a behind-camera sentinel that fails cheirality.
    """
    rows = [
        uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = jnp.stack(rows, axis=-2)  # [..., 4, 4]
    B = A[..., :, :3]
    c = A[..., :, 3]
    H = jnp.swapaxes(B, -1, -2) @ B                      # [..., 3, 3]
    g = jnp.einsum("...ij,...i->...j", B, c)             # [..., 3]
    # closed-form 3x3 inverse via the adjugate (pure elementwise math)
    a, b_, cc = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    d, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    gg, hh, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    A00 = e * i - f * hh
    A01 = cc * hh - b_ * i
    A02 = b_ * f - cc * e
    A10 = f * gg - d * i
    A11 = a * i - cc * gg
    A12 = cc * d - a * f
    A20 = d * hh - e * gg
    A21 = b_ * gg - a * hh
    A22 = a * e - b_ * d
    det = a * A00 + b_ * A10 + cc * A20
    ok = jnp.abs(det) > 1e-12
    safe = jnp.where(ok, det, 1.0)
    adj = jnp.stack([
        jnp.stack([A00, A01, A02], -1),
        jnp.stack([A10, A11, A12], -1),
        jnp.stack([A20, A21, A22], -1),
    ], -2) / safe[..., None, None]
    p = -jnp.einsum("...ij,...j->...i", adj, g)
    # degenerate pairs -> behind-camera sentinel (fails cheirality gates)
    return jnp.where(ok[..., None], p, jnp.asarray([0.0, 0.0, -1.0]))


def triangulate_two_view(
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    Tcw1: jnp.ndarray,
    Tcw2: jnp.ndarray,
    K: Intrinsics,
) -> jnp.ndarray:
    """Triangulate pixel matches between two posed views -> world points [..., 3]."""
    P1 = _projection_matrix(Tcw1, K)
    P2 = _projection_matrix(Tcw2, K)
    return triangulate_dlt(uv1, uv2, P1, P2)


def parallax_cos(
    pw: jnp.ndarray, center1: jnp.ndarray, center2: jnp.ndarray
) -> jnp.ndarray:
    """cos of the ray parallax angle at each world point [..., 3].

    Used to arbitrate DLT-vs-stereo depth (reference src/LocalMapping.cc:317-353)
    and to validate initialization (reference src/Initializer.cc:880-996).
    """
    r1 = pw - center1
    r2 = pw - center2
    n1 = jnp.linalg.norm(r1, axis=-1)
    n2 = jnp.linalg.norm(r2, axis=-1)
    return jnp.sum(r1 * r2, axis=-1) / jnp.maximum(n1 * n2, 1e-12)
