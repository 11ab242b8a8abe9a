"""Large-scale bundle adjustment: implicit-Schur preconditioned CG.

The dense engine (:mod:`pyorbslam_jax.optim.ba`) materializes the
camera-point coupling as a (6C x 3P) matrix, which is the right call for
local-BA windows (C <= 64) where one dense matmul beats everything.  Global
BA after a loop closure (Optimizer.bundle_adjustment, Optimizer.py:21-121)
runs over *all* keyframes and landmarks — KITTI-00 scale is ~1.4k
keyframes x ~1e5 points, where that dense coupling would be gigabytes.

This engine solves the same reduced camera system

    S dc = rhs,   S = Hcc - W Hpp^-1 W^T

without ever forming S or W densely (the Ceres ITERATIVE_SCHUR recipe as
fixed-shape array code): the matrix-vector product S v is three segment-sum sweeps
over the observation list

    (W^T v)[p]  = sum_{o: pnt_o = p} W_o^T v[cam_o]        (O,3) gather+scatter
    y2[c]       = sum_{o: cam_o = c} W_o (Hpp^-1 (W^T v))[pnt_o]
    S v         = Hcc_d v - y2

— all dense batched (6,3)/(3,3) block algebra that XLA fuses, with no
data-dependent shapes.  Preconditioner: block-Jacobi with the *exact*
6x6 diagonal blocks of S (computable by one more segment sum since each
(camera, point) pair has at most one observation), inverted batched.

The LM outer loop, two-phase Huber/chi2 gating schedule, and acceptance
logic mirror the dense engine so the two are drop-in interchangeable;
`tests/test_ba.py::test_cg_matches_dense` pins them together.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.geometry import se3
from pyorbslam_jax.optim.ba import (
    BAProblem,
    _bmm,
    _bmv,
    _btb,
    _btv,
    BAResult,
    CHI2_STEREO,
    HUBER_DELTA,
    _huber_w,
    _inv3x3,
    _residuals,
    _robust_cost,
)

from pyorbslam_jax.utils.precision import f32_matmuls


def _psum(x, axis):
    """psum over a shard_map mesh axis, or identity single-device."""
    return x if axis is None else jax.lax.psum(x, axis)


def _schur_blocks(prob: BAProblem, cam_Tcw, pnt_pos, active, lam, use_huber,
                  axis=None):
    """Assemble the block pieces of the damped normal equations.

    With ``axis`` set (inside shard_map over a point/observation-sharded
    mesh), camera-space reductions are psum'd over the mesh — cameras are
    replicated, points/observations stay shard-local."""
    n_cam = cam_Tcw.shape[0]
    n_pnt = pnt_pos.shape[0]
    e, Jc, Jp, _ = _residuals(prob, cam_Tcw, pnt_pos)
    chi2 = jnp.sum(e * e, axis=-1) * prob.obs_inv_sigma2
    w = _huber_w(chi2, HUBER_DELTA) if use_huber else jnp.ones_like(chi2)
    w = w * prob.obs_inv_sigma2 * active

    Hcc = _psum(jax.ops.segment_sum(
        w[:, None, None] * _btb(Jc, Jc),
        prob.obs_cam, num_segments=n_cam,
    ), axis)
    bc = _psum(jax.ops.segment_sum(
        w[:, None] * _btv(Jc, e), prob.obs_cam, n_cam
    ), axis)
    Hpp = jax.ops.segment_sum(
        w[:, None, None] * _btb(Jp, Jp),
        prob.obs_pnt, num_segments=n_pnt,
    )
    bp = jax.ops.segment_sum(
        w[:, None] * _btv(Jp, e), prob.obs_pnt, n_pnt
    )

    eye6, eye3 = jnp.eye(6), jnp.eye(3)
    Hcc_d = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
    Hpp_d = Hpp + lam * Hpp * eye3 + 1e-8 * eye3
    Hpp_inv = _inv3x3(Hpp_d)
    W = w[:, None, None] * _btb(Jc, Jp)  # (O, 6, 3)
    return Hcc_d, bc, Hpp_inv, bp, W


def _make_matvec(prob: BAProblem, Hcc_d, Hpp_inv, W, free, axis=None):
    n_cam = Hcc_d.shape[0]
    n_pnt = Hpp_inv.shape[0]

    def matvec(v):  # v: (C, 6) replicated across shards
        vf = v * free[:, None]
        y1 = _bmv(Hcc_d, vf)
        wt_v = jax.ops.segment_sum(
            _btv(W, vf[prob.obs_cam]),
            prob.obs_pnt, num_segments=n_pnt,
        )                                             # (P, 3) = W^T v
        t = _bmv(Hpp_inv, wt_v)   # Hpp^-1 W^T v
        y2 = _psum(jax.ops.segment_sum(
            _bmv(W, t[prob.obs_pnt]),
            prob.obs_cam, num_segments=n_cam,
        ), axis)                                      # (C, 6)
        y = (y1 - y2) * free[:, None]
        return y + v * (1.0 - free)[:, None]          # identity on fixed

    return matvec


def _pcg(matvec, b, Minv, iters):
    """Block-Jacobi preconditioned CG on the (C, 6) vector space."""

    def precond(r):
        return _bmv(Minv, r)

    def dot(a, b_):
        return jnp.sum(a * b_)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    p0 = z0
    rz0 = dot(r0, z0)
    b_norm = jnp.maximum(dot(b, b), 1e-30)

    def body(_, st):
        x, r, p, rz = st
        live = (dot(r, r) / b_norm) > 1e-12     # freeze once converged
        Ap = matvec(p)
        alpha = rz / jnp.maximum(dot(p, Ap), 1e-30)
        alpha = jnp.where(live, alpha, 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = jnp.where(live, rz_new / jnp.maximum(rz, 1e-30), 0.0)
        p = z + beta * p
        return x, r, p, rz_new

    x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x0, r0, p0, rz0))
    return x


def _lm_iteration_cg(prob: BAProblem, cam_Tcw, pnt_pos, active, lam,
                     use_huber, cg_iters, axis=None):
    n_pnt = pnt_pos.shape[0]
    free = (~prob.cam_fixed).astype(jnp.float32)

    Hcc_d, bc, Hpp_inv, bp, W = _schur_blocks(
        prob, cam_Tcw, pnt_pos, active, lam, use_huber, axis
    )
    matvec = _make_matvec(prob, Hcc_d, Hpp_inv, W, free, axis)

    # rhs = bc - W Hpp^-1 bp, zeroed on fixed cameras
    t = _bmv(Hpp_inv, bp)
    rhs = bc - _psum(jax.ops.segment_sum(
        _bmv(W, t[prob.obs_pnt]),
        prob.obs_cam, num_segments=Hcc_d.shape[0],
    ), axis)
    rhs = rhs * free[:, None]

    # exact 6x6 diagonal blocks of S for the preconditioner
    WHW = _psum(jax.ops.segment_sum(
        _bmm(_bmm(W, Hpp_inv[prob.obs_pnt]), jnp.swapaxes(W, -1, -2)),
        prob.obs_cam, num_segments=Hcc_d.shape[0],
    ), axis)
    S_diag = Hcc_d - WHW
    S_diag = (
        S_diag * free[:, None, None]
        + jnp.eye(6) * (1.0 - free)[:, None, None]
        + 1e-8 * jnp.eye(6)
    )
    Minv = jnp.linalg.inv(S_diag)

    dc = -_pcg(matvec, rhs, Minv, cg_iters)
    dc = dc * free[:, None]

    # back-substitute landmarks
    Wt_dc = jax.ops.segment_sum(
        _btv(W, dc[prob.obs_cam]),
        prob.obs_pnt, num_segments=n_pnt,
    )
    dp = -_bmv(Hpp_inv, bp + Wt_dc)
    dp = dp * prob.pnt_active[:, None]

    cam_new = se3.retract(cam_Tcw, dc)
    cam_new = jnp.where(prob.cam_fixed[:, None, None], cam_Tcw, cam_new)
    pnt_new = pnt_pos + dp

    def total_cost(cT, pP):
        e2, _, _, _ = _residuals(prob, cT, pP)
        c2 = jnp.sum(e2 * e2, axis=-1) * prob.obs_inv_sigma2
        return _psum(
            jnp.sum(_robust_cost(c2, HUBER_DELTA, use_huber) * active), axis)

    improved = total_cost(cam_new, pnt_new) < total_cost(cam_Tcw, pnt_pos)
    cam_out = jnp.where(improved, cam_new, cam_Tcw)
    pnt_out = jnp.where(improved, pnt_new, pnt_pos)
    lam = jnp.where(improved, lam * 0.5, lam * 5.0)
    return cam_out, pnt_out, lam


@f32_matmuls
def _bundle_adjust_cg_core(prob: BAProblem, iters1: int, iters2: int,
                           cg_iters: int, axis=None) -> BAResult:
    """Shared body of :func:`bundle_adjust_cg`; with ``axis`` set it runs
    inside shard_map over a point/observation-sharded mesh (cameras
    replicated, one (C,6) psum per CG step — parallel/dist_ba.py)."""
    active = prob.obs_active.astype(jnp.float32)

    def phase(carry, iters, use_huber, act):
        def body(_, st):
            cT, pP, lam = st
            return _lm_iteration_cg(prob, cT, pP, act, lam, use_huber,
                                    cg_iters, axis)

        cT, pP, _ = jax.lax.fori_loop(
            0, iters, body, carry + (jnp.float32(1e-4),)
        )
        return cT, pP

    cam_Tcw, pnt_pos = phase((prob.cam_Tcw, prob.pnt_pos), iters1, True, active)

    e, _, _, z = _residuals(prob, cam_Tcw, pnt_pos)
    chi2 = jnp.sum(e * e, axis=-1) * prob.obs_inv_sigma2
    good = (chi2 <= CHI2_STEREO) & (z > 0)
    active2 = active * good.astype(jnp.float32)

    cam_Tcw, pnt_pos = phase((cam_Tcw, pnt_pos), iters2, False, active2)

    e, _, _, z = _residuals(prob, cam_Tcw, pnt_pos)
    chi2 = jnp.sum(e * e, axis=-1) * prob.obs_inv_sigma2
    depth_ok = z > 0
    inlier = prob.obs_active & (chi2 <= CHI2_STEREO) & depth_ok
    return BAResult(
        cam_Tcw=cam_Tcw, pnt_pos=pnt_pos, obs_chi2=chi2,
        obs_depth_ok=depth_ok, obs_inlier=inlier,
    )


@functools.partial(jax.jit, static_argnames=("iters1", "iters2", "cg_iters"))
def bundle_adjust_cg(prob: BAProblem, iters1: int = 5, iters2: int = 10,
                     cg_iters: int = 64) -> BAResult:
    """Drop-in replacement for :func:`ba.bundle_adjust` at global scale:
    same two-phase Huber/gating schedule (Optimizer.py:318-353), inexact
    LM steps via preconditioned CG on the implicit Schur complement."""
    return _bundle_adjust_cg_core(prob, iters1, iters2, cg_iters, axis=None)
