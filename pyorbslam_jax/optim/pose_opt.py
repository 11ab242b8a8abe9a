"""Motion-only pose optimization: batched Levenberg-Marquardt on SE(3).

Replaces the reference's g2o problem (Optimizer.pose_optimization,
Optimizer.py:123-208): unary stereo-projection edges with per-octave
information, Huber robust kernel (delta = sqrt(7.815)), 4 rounds x 10 LM
iterations, chi2 gate 7.815 per round with outlier re-admission, robust
kernel dropped for the final round, and — faithfully — each round restarts
from the *initial* pose with the refined inlier set.

The stereo residual/Jacobian matches g2o's
``EdgeStereoSE3ProjectXYZOnlyPose`` (edge_project_stereo_xyz_onlypose.cpp:
35-85): h(Pc) = (fx x/z + cx, fy y/z + cy, u - bf/z), e = obs - h, with
the left-multiplicative se3 update (omega, upsilon) of VertexSE3Expmap.

Everything is fixed-shape: N is the frame keypoint capacity and inactive
slots simply carry zero weight, so one compiled program serves every
frame.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.geometry import se3
from pyorbslam_jax.optim.ba import _bmm

from pyorbslam_jax.utils.precision import f32_matmuls

CHI2_STEREO = 7.815


class PoseOptResult(NamedTuple):
    Tcw: jnp.ndarray        # (4, 4) optimized pose
    inliers: jnp.ndarray    # (N,) bool final inlier mask
    num_inliers: jnp.ndarray  # () int32
    chi2: jnp.ndarray       # (N,) final per-edge chi2 (unweighted)


def stereo_residual_jacobian(
    Tcw: jnp.ndarray, Xw: jnp.ndarray, obs: jnp.ndarray, cam: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Residuals (N, 3) and Jacobians (N, 3, 6) wrt xi = (omega, upsilon).

    cam = [fx, fy, cx, cy, bf].
    """
    fx, fy, cx, cy, bf = cam[0], cam[1], cam[2], cam[3], cam[4]
    Pc = Xw @ Tcw[:3, :3].T + Tcw[:3, 3]
    x, y, z = Pc[:, 0], Pc[:, 1], Pc[:, 2]
    z = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    invz = 1.0 / z
    invz2 = invz * invz

    u = fx * x * invz + cx
    v = fy * y * invz + cy
    ur = u - bf * invz
    e = obs - jnp.stack([u, v, ur], axis=-1)

    # dh/dPc rows for (u, v, ur)
    zeros = jnp.zeros_like(x)
    du = jnp.stack([fx * invz, zeros, -fx * x * invz2], axis=-1)
    dv = jnp.stack([zeros, fy * invz, -fy * y * invz2], axis=-1)
    dur = du + jnp.stack([zeros, zeros, bf * invz2], axis=-1)
    dh_dp = jnp.stack([du, dv, dur], axis=1)  # (N, 3, 3)

    # dPc/dxi with left-multiplicative update: dPc = -[Pc]x w + up
    dp_dxi = jnp.concatenate([-se3.hat(Pc), jnp.broadcast_to(jnp.eye(3), Pc.shape[:-1] + (3, 3))], axis=-1)  # (N, 3, 6)
    J = -_bmm(dh_dp, dp_dxi)   # tiny inner dims: elementwise form (see ba._bmv)
    return e, J


def _chi2(e: jnp.ndarray, inv_sigma2: jnp.ndarray) -> jnp.ndarray:
    return jnp.sum(e * e, axis=-1) * inv_sigma2


def _huber_weight(chi2: jnp.ndarray, delta: float) -> jnp.ndarray:
    """g2o RobustKernelHuber weight: 1 inside delta^2, delta/sqrt(chi2) outside."""
    sqrt_chi = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    return jnp.where(chi2 <= delta * delta, 1.0, delta / sqrt_chi)


@f32_matmuls
def _lm_rounds(
    Tcw0, Xw, obs, inv_sigma2, active, cam, iters, use_huber, delta,
):
    """One reference 'round': ``iters`` LM iterations from Tcw0 over the
    currently-active edge set.  Returns the optimized pose."""

    def body(_, carry):
        T, lam = carry
        e, J = stereo_residual_jacobian(T, Xw, obs, cam)
        chi2 = _chi2(e, inv_sigma2)
        w = _huber_weight(chi2, delta) if use_huber else jnp.ones_like(chi2)
        w = w * inv_sigma2 * active
        H = jnp.einsum("nij,n,nik->jk", J, w, J)
        b = jnp.einsum("nij,n,ni->j", J, w, e)
        # b is gradient of 1/2 e^T W e wrt xi with e = obs - h(T):
        # de/dxi = J, grad = J^T W e -> step solves (H + lam D) dx = -b? g2o
        # convention: linear system H dx = -b with b = J^T W e(T) and
        # update exp(dx) * T decreasing the error; our J already carries
        # the minus sign from e = obs - h, so dx = -solve(H, b).
        D = jnp.diag(jnp.diag(H))
        dx = -jnp.linalg.solve(H + lam * D + 1e-9 * jnp.eye(6), b)
        T_new = se3.retract(T, dx)
        e_new, _ = stereo_residual_jacobian(T_new, Xw, obs, cam)
        chi2_new = _chi2(e_new, inv_sigma2)

        def total(c):
            if use_huber:
                # Huber cost: chi2 if inside, 2 delta sqrt(chi2) - delta^2 outside
                s = jnp.sqrt(jnp.maximum(c, 1e-12))
                rho = jnp.where(c <= delta * delta, c, 2 * delta * s - delta * delta)
            else:
                rho = c
            return jnp.sum(rho * active)

        improved = total(chi2_new) < total(chi2)
        T = jnp.where(improved, T_new, T)
        lam = jnp.where(improved, lam * 0.5, lam * 4.0)
        return T, lam

    T, _ = jax.lax.fori_loop(0, iters, body, (Tcw0, jnp.float32(1e-4)))
    return T


@functools.partial(jax.jit, static_argnames=("rounds", "iters"))
@f32_matmuls
def pose_optimization(
    Tcw0: jnp.ndarray,        # (4, 4) initial pose
    Xw: jnp.ndarray,          # (N, 3) map point world positions
    obs: jnp.ndarray,         # (N, 3) measurements (u, v, u_right)
    inv_sigma2: jnp.ndarray,  # (N,) per-edge information scale
    active0: jnp.ndarray,     # (N,) bool: has map point & stereo obs
    cam: jnp.ndarray,         # (5,) [fx, fy, cx, cy, bf]
    rounds: int = 4,
    iters: int = 10,
) -> PoseOptResult:
    delta = float(np.sqrt(CHI2_STEREO))
    inlier = active0
    T = Tcw0
    for r in range(rounds):
        use_huber = r < 3  # kernel dropped after round index 2 (Optimizer.py:199)
        T = _lm_rounds(
            Tcw0, Xw, obs, inv_sigma2,
            inlier.astype(jnp.float32), cam, iters, use_huber, delta,
        )
        e, _ = stereo_residual_jacobian(T, Xw, obs, cam)
        chi2 = _chi2(e, inv_sigma2)
        inlier = active0 & (chi2 <= CHI2_STEREO)

    e, _ = stereo_residual_jacobian(T, Xw, obs, cam)
    chi2 = _chi2(e, inv_sigma2)
    n_in = jnp.sum(inlier.astype(jnp.int32))
    # guard: with too few correspondences return the initial pose
    # (reference bails out below 3, Optimizer.py:171)
    enough = jnp.sum(active0.astype(jnp.int32)) >= 3
    T = jnp.where(enough, T, Tcw0)
    return PoseOptResult(Tcw=T, inliers=inlier, num_inliers=n_in, chi2=chi2)
