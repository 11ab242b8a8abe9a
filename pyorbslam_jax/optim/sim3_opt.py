"""Relative Sim3 refinement with bidirectional projection edges.

Replaces Optimizer.optimize_sim3 (Optimizer.py:368-483): one Sim3 vertex,
fixed 3-D points, 2-D projection residuals in both directions
(EdgeSim3ProjectXYZ / EdgeInverseSim3ProjectXYZ), Huber delta = sqrt(th2),
5 iterations, chi2 gate removing bad pairs, 5-10 more iterations,
inlier count.  Jacobians come from forward-mode autodiff of the
7-parameter retraction — the problem is a single small vertex, so
autodiff costs nothing and cannot disagree with the residual.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from pyorbslam_jax.geometry import sim3 as sim3_mod
from pyorbslam_jax.geometry.sim3 import Sim3

from pyorbslam_jax.utils.precision import f32_matmuls


class Sim3OptResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    s: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray


def _residuals(params: Sim3, X1c, X2c, obs1, obs2, cam4):
    """Bidirectional 2-D reprojection residuals: (M, 2), (M, 2)."""
    X2in1 = sim3_mod.act(params, X2c)
    X1in2 = sim3_mod.act(sim3_mod.inverse(params), X1c)

    def proj(P, obs):
        z = jnp.where(jnp.abs(P[:, 2]) < 1e-6, 1e-6, P[:, 2])
        u = cam4[0] * P[:, 0] / z + cam4[2]
        v = cam4[1] * P[:, 1] / z + cam4[3]
        return obs - jnp.stack([u, v], axis=-1)

    return proj(X2in1, obs1), proj(X1in2, obs2)


@functools.partial(jax.jit, static_argnames=("fix_scale", "iters1", "iters2"))
@f32_matmuls
def optimize_sim3(
    S12_R: jnp.ndarray, S12_t: jnp.ndarray, S12_s: jnp.ndarray,
    X1c: jnp.ndarray,        # (M, 3) matched points in camera-1 frame
    X2c: jnp.ndarray,        # (M, 3) matched points in camera-2 frame
    obs1: jnp.ndarray,       # (M, 2)
    obs2: jnp.ndarray,       # (M, 2)
    inv_sigma2_1: jnp.ndarray,
    inv_sigma2_2: jnp.ndarray,
    active: jnp.ndarray,     # (M,) bool
    cam4: jnp.ndarray,
    th2: float = 10.0,
    fix_scale: bool = True,
    iters1: int = 5,
    iters2: int = 10,
) -> Sim3OptResult:
    delta = jnp.sqrt(th2)

    def chi2_pair(params):
        e1, e2 = _residuals(params, X1c, X2c, obs1, obs2, cam4)
        c1 = jnp.sum(e1 * e1, -1) * inv_sigma2_1
        c2 = jnp.sum(e2 * e2, -1) * inv_sigma2_2
        return c1, c2

    def gn_phase(params, act, iters, use_huber):
        def body(_, st):
            p, lam = st

            def res_of_xi(xi):
                if fix_scale:
                    xi = xi.at[6].set(0.0)
                pp = sim3_mod.retract(p, xi)
                e1, e2 = _residuals(pp, X1c, X2c, obs1, obs2, cam4)
                return jnp.concatenate([e1, e2], axis=0)  # (2M, 2)

            zero = jnp.zeros(7, jnp.float32)
            e = res_of_xi(zero)
            J = jax.jacfwd(res_of_xi)(zero)               # (2M, 2, 7)
            isig = jnp.concatenate([inv_sigma2_1, inv_sigma2_2])
            c2 = jnp.sum(e * e, -1) * isig
            if use_huber:
                sq = jnp.sqrt(jnp.maximum(c2, 1e-12))
                hub = jnp.where(c2 <= th2, 1.0, delta / sq)
            else:
                hub = jnp.ones_like(c2)
            wgt = hub * isig * jnp.concatenate([act, act])
            H = jnp.einsum("mij,m,mik->jk", J, wgt, J)
            b = jnp.einsum("mij,m,mi->j", J, wgt, e)
            if fix_scale:
                H = H.at[6, :].set(0.0).at[:, 6].set(0.0).at[6, 6].set(1.0)
                b = b.at[6].set(0.0)
            dx = -jnp.linalg.solve(H + lam * jnp.diag(jnp.diag(H)) + 1e-8 * jnp.eye(7), b)
            if fix_scale:
                dx = dx.at[6].set(0.0)
            p_new = sim3_mod.retract(p, dx)
            e_new = res_of_xi_total(p_new, act)
            e_old = res_of_xi_total(p, act)
            better = e_new < e_old
            p = jax.tree_util.tree_map(
                lambda a, b2: jnp.where(better, a, b2), p_new, p
            )
            lam = jnp.where(better, lam * 0.5, lam * 5.0)
            return p, lam

        def res_of_xi_total(p, act_):
            e1, e2 = _residuals(p, X1c, X2c, obs1, obs2, cam4)
            c1 = jnp.sum(e1 * e1, -1) * inv_sigma2_1 * act_
            c2 = jnp.sum(e2 * e2, -1) * inv_sigma2_2 * act_
            return jnp.sum(c1 + c2)

        p, _ = jax.lax.fori_loop(0, iters, body, (params, jnp.float32(1e-3)))
        return p

    params = Sim3(R=S12_R, t=S12_t, s=S12_s)
    act = active.astype(jnp.float32)
    params = gn_phase(params, act, iters1, True)

    c1, c2 = chi2_pair(params)
    good = (c1 <= th2) & (c2 <= th2) & active
    act2 = good.astype(jnp.float32)
    params = gn_phase(params, act2, iters2, False)

    c1, c2 = chi2_pair(params)
    inliers = (c1 <= th2) & (c2 <= th2) & active
    return Sim3OptResult(
        R=params.R, t=params.t, s=params.s,
        inliers=inliers, n_inliers=inliers.sum(),
    )
