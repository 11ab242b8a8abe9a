"""Closed-form Horn alignment + parallel Sim3 RANSAC.

Replaces Sim3Solver.py: the reference computes Horn's closed-form Sim3
from 3-point minimal sets (quaternion from the 4x4 N-matrix eigenvector,
compute_sim3:160-209) inside a sequential RANSAC (iterate:100-158) with
bidirectional reprojection gating at 9.21 * sigma^2 (check_inliers:
211-227).  Here all hypotheses run as vmapped lanes and the inlier count
is one batched reduction.

For stereo SLAM the scale is fixed at 1 (bFixScale semantics), but the
with_scale path implements Horn's symmetric scale for mono parity.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from pyorbslam_jax.geometry.sim3 import Sim3

from pyorbslam_jax.utils.precision import f32_matmuls


def horn_align(P: jnp.ndarray, Q: jnp.ndarray, with_scale: bool = False
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Closed-form (R, t, s) minimizing ||Q - (s R P + t)||^2.

    P, Q: (n, 3).  Quaternion-free SVD form (equivalent to the reference's
    N-matrix eigenvector method).
    """
    mp = P.mean(axis=0)
    mq = Q.mean(axis=0)
    Pc = P - mp
    Qc = Q - mq
    H = Pc.T @ Qc
    U, D, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    S = jnp.diag(jnp.stack([jnp.ones(()), jnp.ones(()), d]))
    R = Vt.T @ S @ U.T
    if with_scale:
        # Horn's symmetric scale: s = sqrt(sum|Qc|^2 / sum|Pc|^2)
        s = jnp.sqrt(
            jnp.sum(Qc * Qc) / jnp.maximum(jnp.sum(Pc * Pc), 1e-12)
        )
    else:
        s = jnp.ones(())
    t = mq - s * (R @ mp)
    return R, t, s


class Sim3RansacResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    s: jnp.ndarray
    inliers: jnp.ndarray     # (N,) bool
    n_inliers: jnp.ndarray   # () int32
    ok: jnp.ndarray          # () bool


@functools.partial(jax.jit, static_argnames=("n_hyp", "with_scale"))
@f32_matmuls
def sim3_ransac(
    X1: jnp.ndarray,         # (N, 3) camera-1-frame points
    X2: jnp.ndarray,         # (N, 3) matched camera-2-frame points
    uv1: jnp.ndarray,        # (N, 2) observations in image 1
    uv2: jnp.ndarray,        # (N, 2) observations in image 2
    sigma2_1: jnp.ndarray,   # (N,) levelSigma2 of kp1
    sigma2_2: jnp.ndarray,   # (N,)
    active: jnp.ndarray,     # (N,) bool
    cam4: jnp.ndarray,       # [fx, fy, cx, cy]
    key: jnp.ndarray,
    n_hyp: int = 256,
    with_scale: bool = False,
    chi2_th: float = 9.21,   # th1/th2 = 9.21 * sigma^2 (Sim3Solver.py:56-57)
    min_inliers: int = 20,
) -> Sim3RansacResult:
    """S12 such that X1 ~ s R X2 + t, RANSAC over 3-point minimal sets."""
    n = X1.shape[0]
    w = active.astype(jnp.float32)
    idx = jax.random.categorical(
        key, jnp.log(w + 1e-9)[None, :].repeat(n_hyp * 3, 0)
    ).reshape(n_hyp, 3)

    def solve(ids):
        R, t, s = horn_align(X2[ids], X1[ids], with_scale)
        return R, t, s

    Rs, ts, ss = jax.vmap(solve)(idx)

    def count(R, t, s):
        # project mapped points into both cameras
        X2in1 = s * (X2 @ R.T) + t
        Rinv = R.T
        X1in2 = ((X1 - t) @ R) / jnp.maximum(s, 1e-9)

        def proj_err(P, uv):
            z = jnp.where(jnp.abs(P[:, 2]) < 1e-6, 1e-6, P[:, 2])
            u = cam4[0] * P[:, 0] / z + cam4[2]
            v = cam4[1] * P[:, 1] / z + cam4[3]
            return (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2

        e1 = proj_err(X2in1, uv1) / sigma2_1
        e2 = proj_err(X1in2, uv2) / sigma2_2
        return (e1 < chi2_th) & (e2 < chi2_th) & active

    inl = jax.vmap(count)(Rs, ts, ss)     # (H, N)
    counts = inl.sum(axis=1)
    best = jnp.argmax(counts)

    # refine on the best inlier set (resampled Horn over inliers)
    k2 = jax.random.fold_in(key, 7)
    best_inl = inl[best]
    ridx = jax.random.categorical(
        k2, jnp.log(best_inl.astype(jnp.float32) + 1e-9)[None, :].repeat(32, 0)
    )
    R_r, t_r, s_r = horn_align(X2[ridx], X1[ridx], with_scale)
    inl_r = count(R_r, t_r, s_r)
    use_r = inl_r.sum() >= counts[best]
    R = jnp.where(use_r, R_r, Rs[best])
    t = jnp.where(use_r, t_r, ts[best])
    s = jnp.where(use_r, s_r, ss[best])
    inliers = jnp.where(use_r, inl_r, best_inl)
    n_in = inliers.sum()
    return Sim3RansacResult(R=R, t=t, s=s, inliers=inliers,
                            n_inliers=n_in, ok=n_in >= min_inliers)
