"""Sim(3) Lie-group operations as pure, batched JAX functions.

A similarity transform is stored as the triple ``(R, t, s)`` with
``x' = s * R @ x + t`` — the same group the reference manipulates through
``g2o.Sim3`` (reference: g2o sim3 type, sim3.h:42-86; Converter.py:27-39
folds s into R when exporting to a 4x4 matrix, reproduced by
:func:`to_matrix`).

The tangent ordering is ``(omega, upsilon, sigma)`` (rotation, translation,
log-scale).  Exp/log use the closed-form W-matrix coefficients from
Strasdat's Sim3 formulation (the same math implemented in g2o's sim3.h),
with Taylor fallbacks so everything is differentiable and jit-safe.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from pyorbslam_jax.geometry import se3

_EPS = 1e-7


class Sim3(NamedTuple):
    R: jnp.ndarray  # (..., 3, 3)
    t: jnp.ndarray  # (..., 3)
    s: jnp.ndarray  # (...,)

    @staticmethod
    def identity(batch=(), dtype=jnp.float32) -> "Sim3":
        return Sim3(
            R=jnp.broadcast_to(jnp.eye(3, dtype=dtype), batch + (3, 3)),
            t=jnp.zeros(batch + (3,), dtype=dtype),
            s=jnp.ones(batch, dtype=dtype),
        )

    @staticmethod
    def from_se3(T: jnp.ndarray) -> "Sim3":
        return Sim3(R=T[..., :3, :3], t=T[..., :3, 3],
                    s=jnp.ones(T.shape[:-2], dtype=T.dtype))


def compose(a: Sim3, b: Sim3) -> Sim3:
    """a * b (apply b first)."""
    return Sim3(
        R=a.R @ b.R,
        t=a.s[..., None] * jnp.einsum("...ij,...j->...i", a.R, b.t) + a.t,
        s=a.s * b.s,
    )


def inverse(g: Sim3) -> Sim3:
    Rt = jnp.swapaxes(g.R, -1, -2)
    inv_s = 1.0 / g.s
    return Sim3(
        R=Rt,
        t=-inv_s[..., None] * jnp.einsum("...ij,...j->...i", Rt, g.t),
        s=inv_s,
    )


def act(g: Sim3, pts: jnp.ndarray) -> jnp.ndarray:
    """Apply to points (..., N, 3) or (..., 3)."""
    if pts.ndim == g.R.ndim:
        return g.s[..., None, None] * jnp.einsum("...ij,...nj->...ni", g.R, pts) + g.t[..., None, :]
    return g.s[..., None] * jnp.einsum("...ij,...j->...i", g.R, pts) + g.t


def to_matrix(g: Sim3) -> jnp.ndarray:
    """4x4 with scale folded into the rotation block (Converter.py:27-39)."""
    return se3.rt_to_mat(g.s[..., None, None] * g.R, g.t)


def _w_coeffs(theta2, sigma, dtype):
    """Closed-form coefficients (A, B, C) of W = A*Wx + B*Wx^2 + C*I."""
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    s = jnp.exp(sigma)
    sig2 = sigma * sigma
    small_sig = jnp.abs(sigma) < 1e-5
    small_th = theta2 < 1e-8

    # C = (s - 1)/sigma, -> 1 + sigma/2 as sigma -> 0
    C = jnp.where(small_sig, 1.0 + sigma / 2.0 + sig2 / 6.0,
                  (s - 1.0) / jnp.where(small_sig, 1.0, sigma))

    # sigma ~ 0 branch
    A0 = jnp.where(small_th, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2)
    B0 = jnp.where(small_th, 1.0 / 6.0 - theta2 / 120.0,
                   (theta - jnp.sin(theta)) / (theta2 * theta))

    # sigma != 0, theta ~ 0 branch
    safe_sig = jnp.where(small_sig, 1.0, sigma)
    A1 = ((sigma - 1.0) * s + 1.0) / (safe_sig * safe_sig)
    B1 = ((0.5 * sig2 - sigma + 1.0) * s - 1.0) / (safe_sig ** 3)

    # general branch
    a = s * jnp.sin(theta)
    b = s * jnp.cos(theta)
    c = theta2 + sig2
    safe_c = jnp.where(c < _EPS, 1.0, c)
    A2 = (a * sigma + (1.0 - b) * theta) / (theta * safe_c)
    B2 = (C - ((b - 1.0) * sigma + a * theta) / safe_c) / theta2

    A = jnp.where(small_sig, A0, jnp.where(small_th, A1, A2))
    B = jnp.where(small_sig, B0, jnp.where(small_th, B1, B2))
    return A.astype(dtype), B.astype(dtype), C.astype(dtype)


def exp(xi: jnp.ndarray) -> Sim3:
    """(..., 7) tangent (omega, upsilon, sigma) -> Sim3."""
    omega = xi[..., :3]
    upsilon = xi[..., 3:6]
    sigma = xi[..., 6]
    theta2 = jnp.sum(omega * omega, axis=-1)
    A, B, C = _w_coeffs(theta2, sigma, xi.dtype)
    Wx = se3.hat(omega)
    Wx2 = Wx @ Wx
    I = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), Wx.shape)
    W = A[..., None, None] * Wx + B[..., None, None] * Wx2 + C[..., None, None] * I
    return Sim3(
        R=se3.exp_so3(omega),
        t=jnp.einsum("...ij,...j->...i", W, upsilon),
        s=jnp.exp(sigma),
    )


def log(g: Sim3) -> jnp.ndarray:
    """Sim3 -> (..., 7) tangent (omega, upsilon, sigma)."""
    omega = se3.log_so3(g.R)
    sigma = jnp.log(g.s)
    theta2 = jnp.sum(omega * omega, axis=-1)
    A, B, C = _w_coeffs(theta2, sigma, omega.dtype)
    Wx = se3.hat(omega)
    Wx2 = Wx @ Wx
    I = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), Wx.shape)
    W = A[..., None, None] * Wx + B[..., None, None] * Wx2 + C[..., None, None] * I
    upsilon = jnp.linalg.solve(W, g.t[..., None])[..., 0]
    return jnp.concatenate([omega, upsilon, sigma[..., None]], axis=-1)


def retract(g: Sim3, xi: jnp.ndarray) -> Sim3:
    """Left-multiplicative update g <- exp(xi) * g (g2o VertexSim3Expmap)."""
    return compose(exp(xi), g)
