"""Epipolar-constrained matching + batched two-view triangulation.

Replaces ORBMatcher.search_for_triangulation (ORBMatcher.py:584-711) and
the triangulation loop of LocalMapping.create_new_map_points
(LocalMapping.py:152-308) with one fixed-shape device program per
keyframe pair:

  * candidate matching runs over the full Hamming matrix (an int8 matmul) between
    the two keyframes' landmark-free features, masked by the epipolar
    distance of kp2 to F12^T kp1 (< 3.84 * sigma2) and the
    distance-to-epipole guard;
  * accepted pairs are triangulated by batched 4x4 DLT SVD, with the
    reference's stereo fallback, parallax ordering, positive depth,
    reprojection chi2 (5.991 mono / 7.8 stereo), and scale-consistency
    gates applied as masks.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.ops import hamming as ham
from pyorbslam_jax.utils.precision import f32_matmuls

TH_LOW = 50


class TriangulationResult(NamedTuple):
    idx1: jnp.ndarray      # (M,) feature index in KF1 (-1 invalid)
    idx2: jnp.ndarray      # (M,) feature index in KF2
    pos_w: jnp.ndarray     # (M, 3) world position
    valid: jnp.ndarray     # (M,) bool


def fundamental_from_poses(T1: jnp.ndarray, T2: jnp.ndarray,
                           K: jnp.ndarray) -> jnp.ndarray:
    """F12 such that x2^T F12^T ... reference compute_f12
    (LocalMapping.py:310-326): F12 = K1^-T [t12]x R12 K2^-1."""
    R1, t1 = T1[:3, :3], T1[:3, 3]
    R2, t2 = T2[:3, :3], T2[:3, 3]
    R12 = R1 @ R2.T
    t12 = -R12 @ t2 + t1
    tx = jnp.array([
        [0.0, -t12[2], t12[1]],
        [t12[2], 0.0, -t12[0]],
        [-t12[1], t12[0], 0.0],
    ])
    Kinv = jnp.linalg.inv(K)
    return Kinv.T @ tx @ R12 @ Kinv


def triangulate_batch(
    xy1, oct1, desc1, ur1, depth1, free1,
    # neighbor arrays with leading batch axis B:
    xy2, oct2, desc2, ur2, depth2, free2, T2,
    T1, cam, baseline, scale_factors, level_sigma2,
    scale_factor: float = 1.2,
) -> TriangulationResult:
    """Triangulate the new KF against B neighbors in one dispatch."""
    return jax.vmap(
        lambda x2, o2, d2, u2, z2, f2, t2: triangulate_pair.__wrapped__(
            xy1, oct1, desc1, ur1, depth1, free1,
            x2, o2, d2, u2, z2, f2, T1, t2,
            cam, baseline, scale_factors, level_sigma2, scale_factor)
    )(xy2, oct2, desc2, ur2, depth2, free2, T2)


triangulate_batch_jit = jax.jit(
    triangulate_batch, static_argnames=("scale_factor",))


def triangulate_batch_packed(*args, **kwargs) -> jnp.ndarray:
    """:func:`triangulate_batch` with the result packed into one int32
    buffer (B, 6N): [idx1 N | idx2 N | valid N | pos_w bits 3N] — a single
    device->host read per keyframe insertion."""
    r = triangulate_batch(*args, **kwargs)
    return jnp.concatenate([
        r.idx1, r.idx2, r.valid.astype(jnp.int32),
        jax.lax.bitcast_convert_type(r.pos_w, jnp.int32).reshape(
            r.pos_w.shape[0], -1),
    ], axis=1)


triangulate_batch_packed_jit = jax.jit(
    triangulate_batch_packed, static_argnames=("scale_factor",))


def unpack_tri_batch_np(packed: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Host inverse of :func:`triangulate_batch_packed`:
    (idx1, idx2, valid, pos_w)."""
    n = packed.shape[1] // 6
    return (
        packed[:, :n], packed[:, n: 2 * n],
        packed[:, 2 * n: 3 * n].astype(bool),
        packed[:, 3 * n:].view(np.float32).reshape(packed.shape[0], n, 3),
    )


@functools.partial(jax.jit, static_argnames=("scale_factor",))
@f32_matmuls
def triangulate_pair(
    # KF1 (the new keyframe)
    xy1: jnp.ndarray, oct1: jnp.ndarray, desc1: jnp.ndarray,
    ur1: jnp.ndarray, depth1: jnp.ndarray, free1: jnp.ndarray,
    # KF2 (neighbor)
    xy2: jnp.ndarray, oct2: jnp.ndarray, desc2: jnp.ndarray,
    ur2: jnp.ndarray, depth2: jnp.ndarray, free2: jnp.ndarray,
    T1: jnp.ndarray, T2: jnp.ndarray,
    cam: jnp.ndarray,            # [fx, fy, cx, cy, bf]
    baseline: jnp.ndarray,       # scalar camera baseline (m)
    scale_factors: jnp.ndarray,  # (L,)
    level_sigma2: jnp.ndarray,   # (L,)
    scale_factor: float = 1.2,
) -> TriangulationResult:
    fx, fy, cx, cy, bf = (cam[i] for i in range(5))
    K = jnp.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]])
    F12 = fundamental_from_poses(T1, T2, K)

    # ---- matching with epipolar gating ----
    dist = ham.hamming_matrix(desc1, desc2)          # (N1, N2)
    h1 = jnp.concatenate([xy1, jnp.ones_like(xy1[:, :1])], 1)  # (N1, 3)
    lines2 = h1 @ F12                                 # a, b, c per kp1 row
    num = (
        lines2[:, None, 0] * xy2[None, :, 0]
        + lines2[:, None, 1] * xy2[None, :, 1]
        + lines2[:, None, 2]
    )
    den = lines2[:, 0] ** 2 + lines2[:, 1] ** 2
    dsqr = num * num / jnp.maximum(den, 1e-12)[:, None]
    epi_ok = dsqr < 3.84 * level_sigma2[oct2][None, :]

    # epipole of camera 1 in image 2 (skip features too close to it)
    Ow1 = -T1[:3, :3].T @ T1[:3, 3]
    C2 = T2[:3, :3] @ Ow1 + T2[:3, 3]
    invz = 1.0 / jnp.where(jnp.abs(C2[2]) < 1e-6, 1e-6, C2[2])
    ex, ey = fx * C2[0] * invz + cx, fy * C2[1] * invz + cy
    de2 = (xy2[:, 0] - ex) ** 2 + (xy2[:, 1] - ey) ** 2
    far_from_epipole = de2[None, :] >= 100.0 * (scale_factors[oct2] ** 2)[None, :]

    mask = epi_ok & far_from_epipole & free1[:, None] & free2[None, :]
    BIG = 1_000_000
    dist = jnp.where(mask, dist, BIG)
    best2 = jnp.argmin(dist, axis=1)
    bestd = jnp.take_along_axis(dist, best2[:, None], 1)[:, 0]
    # mutual best (stands in for the reference's per-node best with
    # ratio 0.6 — stricter, favors precision)
    back = jnp.argmin(dist, axis=0)
    mutual = back[best2] == jnp.arange(xy1.shape[0])
    matched = (bestd <= TH_LOW) & mutual

    i2 = best2
    # ---- triangulation ----
    xn1 = jnp.stack([(xy1[:, 0] - cx) / fx, (xy1[:, 1] - cy) / fy,
                     jnp.ones_like(xy1[:, 0])], 1)
    xn2_all = jnp.stack([(xy2[:, 0] - cx) / fx, (xy2[:, 1] - cy) / fy,
                         jnp.ones_like(xy2[:, 0])], 1)
    xn2 = xn2_all[i2]
    ray1 = xn1 @ T1[:3, :3]          # Rwc1 @ xn1 rows
    ray2 = xn2 @ T2[:3, :3]
    cos_par = jnp.einsum("ni,ni->n", ray1, ray2) / jnp.maximum(
        jnp.linalg.norm(ray1, axis=1) * jnp.linalg.norm(ray2, axis=1), 1e-9)

    st1 = ur1 >= 0
    st2 = (ur2 >= 0)[i2]
    cps1 = jnp.where(
        st1, jnp.cos(2 * jnp.arctan2(baseline / 2, jnp.maximum(depth1, 1e-6))),
        cos_par + 1)
    cps2 = jnp.where(
        st2, jnp.cos(2 * jnp.arctan2(baseline / 2, jnp.maximum(depth2[i2], 1e-6))),
        cos_par + 1)
    cos_par_stereo = jnp.minimum(cps1, cps2)

    use_dlt = (cos_par < cos_par_stereo) & (cos_par > 0) & (
        st1 | st2 | (cos_par < 0.9998))

    # batched DLT: A (N, 4, 4)
    P1 = T1[:3, :4]
    P2 = T2[:3, :4]
    A = jnp.stack([
        xn1[:, 0:1] * P1[2] - P1[0],
        xn1[:, 1:2] * P1[2] - P1[1],
        xn2[:, 0:1] * P2[2] - P2[0],
        xn2[:, 1:2] * P2[2] - P2[1],
    ], axis=1)
    _, _, vt = jnp.linalg.svd(A)
    hom = vt[:, -1, :]
    w = jnp.where(jnp.abs(hom[:, 3]) < 1e-9, 1e-9, hom[:, 3])
    x_dlt = hom[:, :3] / w[:, None]

    # stereo fallbacks in world coords
    def unproject(T, xy, depth):
        z = depth
        x = (xy[:, 0] - cx) * z / fx
        y = (xy[:, 1] - cy) * z / fy
        pc = jnp.stack([x, y, z], 1)
        Rwc = T[:3, :3].T
        Ow = -Rwc @ T[:3, 3]
        return pc @ T[:3, :3] + Ow

    x_st1 = unproject(T1, xy1, depth1)
    x_st2 = unproject(T2, xy2, depth2)[i2]

    x3d = jnp.where(
        use_dlt[:, None], x_dlt,
        jnp.where((st1 & (cps1 < cps2))[:, None], x_st1,
                  jnp.where((st2 & (cps2 < cps1))[:, None], x_st2, x_dlt)))
    has_source = use_dlt | (st1 & (cps1 < cps2)) | (st2 & (cps2 < cps1))

    # ---- gates ----
    def reproj_ok(T, xy, oct_, ur, x3d):
        Pc = x3d @ T[:3, :3].T + T[:3, 3]
        z = Pc[:, 2]
        zi = 1.0 / jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
        u = fx * Pc[:, 0] * zi + cx
        v = fy * Pc[:, 1] * zi + cy
        e2 = (u - xy[:, 0]) ** 2 + (v - xy[:, 1]) ** 2
        s2 = level_sigma2[oct_]
        stereo = ur >= 0
        er = (u - bf * zi - ur) ** 2
        ok = jnp.where(stereo, e2 + er <= 7.8 * s2, e2 <= 5.991 * s2)
        return ok & (z > 0)

    ok1 = reproj_ok(T1, xy1, oct1, ur1, x3d)
    ok2 = reproj_ok(T2, xy2[i2], oct2[i2], ur2[i2], x3d)

    Ow2 = -T2[:3, :3].T @ T2[:3, 3]
    d1 = jnp.linalg.norm(x3d - Ow1, axis=1)
    d2 = jnp.linalg.norm(x3d - Ow2, axis=1)
    ratio_dist = d2 / jnp.maximum(d1, 1e-9)
    ratio_oct = scale_factors[oct1] / scale_factors[oct2[i2]]
    rf = 1.5 * scale_factor
    scale_ok = (ratio_dist * rf >= ratio_oct) & (ratio_dist <= ratio_oct * rf)

    valid = matched & has_source & ok1 & ok2 & scale_ok & (d1 > 1e-6) & (d2 > 1e-6)
    n1 = xy1.shape[0]
    return TriangulationResult(
        idx1=jnp.where(valid, jnp.arange(n1, dtype=jnp.int32), -1),
        idx2=jnp.where(valid, i2.astype(jnp.int32), -1),
        pos_w=x3d,
        valid=valid,
    )
