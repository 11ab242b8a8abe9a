"""Batched EPnP + parallel RANSAC.

Replaces PnPsolver.py: the reference runs EPnP (4 control points,
barycentric coordinates, 12x12 eigendecomposition, 3 beta approximations
with Gauss-Newton refinement — PnPsolver.compute_pose:370-411,
gauss_newton:537) inside a sequential adaptive RANSAC loop
(iterate:78-174).  Here every minimal set is a lane of a vmapped solver:
H hypotheses of 4 correspondences are solved simultaneously, inliers are
counted with the same per-octave chi2 gate (5.991 * sigma^2,
set_ransac_parameters:43-72), and the best hypothesis is refined by
re-running EPnP on its inlier set — batched hypotheses instead of a loop
(SURVEY.md §7 design stance).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.utils.precision import f32_matmuls


def _control_points(Xw: jnp.ndarray) -> jnp.ndarray:
    """World control points: centroid + scaled PCA axes. Xw: (n, 3) -> (4, 3)."""
    c0 = Xw.mean(axis=0)
    centered = Xw - c0
    n = Xw.shape[0]
    cov = centered.T @ centered / n
    eigval, eigvec = jnp.linalg.eigh(cov)          # ascending
    # descending order like the reference (largest principal axis first)
    scales = jnp.sqrt(jnp.maximum(eigval[::-1], 1e-12))
    axes = eigvec[:, ::-1].T                        # (3, 3) rows = axes
    cws = c0[None, :] + scales[:, None] * axes
    return jnp.concatenate([c0[None, :], cws], axis=0)   # (4, 3)


def _barycentric(Xw: jnp.ndarray, cw: jnp.ndarray) -> jnp.ndarray:
    """(n, 3), (4, 3) -> alphas (n, 4) with rows summing to 1."""
    B = (cw[1:] - cw[0]).T                          # (3, 3)
    Binv = jnp.linalg.inv(B + 1e-12 * jnp.eye(3))
    a123 = (Xw - cw[0]) @ Binv.T                    # (n, 3)
    a0 = 1.0 - a123.sum(axis=1, keepdims=True)
    return jnp.concatenate([a0, a123], axis=1)


def _build_M(alphas: jnp.ndarray, uv: jnp.ndarray, fx, fy, cx, cy) -> jnp.ndarray:
    """(n, 4), (n, 2) -> M (2n, 12)."""
    n = alphas.shape[0]
    u = uv[:, 0]
    v = uv[:, 1]
    row_u = jnp.stack([
        alphas * fx, jnp.zeros_like(alphas), alphas * (cx - u)[:, None]
    ], axis=-1)                                     # (n, 4, 3)
    row_v = jnp.stack([
        jnp.zeros_like(alphas), alphas * fy, alphas * (cy - v)[:, None]
    ], axis=-1)
    M = jnp.stack([row_u, row_v], axis=1)           # (n, 2, 4, 3)
    return M.reshape(2 * n, 12)


def _rho(cw: jnp.ndarray) -> jnp.ndarray:
    """Squared distances between the 6 control-point pairs."""
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    return jnp.stack([jnp.sum((cw[a] - cw[b]) ** 2) for a, b in pairs])


def _L6x10(V: jnp.ndarray) -> jnp.ndarray:
    """V: (4, 12) null-space basis (rows) -> L (6, 10) for the beta system
    with beta ordering (b11, b12, b22, b13, b23, b33, b14, b24, b34, b44)."""
    pairs = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    # dv[k][p] = difference vector of basis k at control pair p
    v = V.reshape(4, 4, 3)                          # (basis, ctrl, xyz)
    dv = jnp.stack([v[:, a, :] - v[:, b, :] for a, b in pairs], axis=1)  # (4, 6, 3)
    idx = [(0, 0), (0, 1), (1, 1), (0, 2), (1, 2), (2, 2),
           (0, 3), (1, 3), (2, 3), (3, 3)]
    cols = []
    for (i, j) in idx:
        dot = jnp.sum(dv[i] * dv[j], axis=-1)       # (6,)
        cols.append(jnp.where(i == j, dot, 2.0 * dot))
    return jnp.stack(cols, axis=1)                  # (6, 10)


def _betas_case1(L, rho):
    """betas_approx_1: unknowns (b11, b12, b13, b14)."""
    A = L[:, [0, 1, 3, 6]]
    x = jnp.linalg.lstsq(A, rho)[0]
    b1 = jnp.sqrt(jnp.abs(x[0]))
    sgn = jnp.sign(x[0])
    b1s = jnp.where(x[0] < 0, -b1, b1)  # keep magnitude; sign fixed later
    b = jnp.stack([b1, x[1] / jnp.where(b1 < 1e-8, 1e-8, b1),
                   x[2] / jnp.where(b1 < 1e-8, 1e-8, b1),
                   x[3] / jnp.where(b1 < 1e-8, 1e-8, b1)])
    return b


def _betas_case2(L, rho):
    """betas_approx_2: unknowns (b11, b12, b22)."""
    A = L[:, [0, 1, 2]]
    x = jnp.linalg.lstsq(A, rho)[0]
    b1 = jnp.sqrt(jnp.abs(x[0]))
    b2 = jnp.sqrt(jnp.abs(x[2]))
    b2 = jnp.where(x[1] < 0, -b2, b2)
    return jnp.stack([b1, b2, jnp.zeros(()), jnp.zeros(())])


def _betas_case3(L, rho):
    """betas_approx_3: unknowns (b11, b12, b22, b13, b23)."""
    A = L[:, [0, 1, 2, 3, 4]]
    x = jnp.linalg.lstsq(A, rho)[0]
    b1 = jnp.sqrt(jnp.abs(x[0]))
    b2 = jnp.sqrt(jnp.abs(x[2]))
    b2 = jnp.where(x[1] < 0, -b2, b2)
    b3 = x[3] / jnp.where(b1 < 1e-8, 1e-8, b1)
    return jnp.stack([b1, b2, b3, jnp.zeros(())])


def _gauss_newton_betas(L, rho, betas, iters: int = 5):
    """Refine betas on ||L b10(beta) - rho|| (PnPsolver.gauss_newton:537)."""
    def b10_of(b):
        b1, b2, b3, b4 = b[0], b[1], b[2], b[3]
        return jnp.stack([
            b1 * b1, b1 * b2, b2 * b2, b1 * b3, b2 * b3,
            b3 * b3, b1 * b4, b2 * b4, b3 * b4, b4 * b4,
        ])

    def body(_, b):
        r = L @ b10_of(b) - rho
        J = jax.jacfwd(lambda bb: L @ b10_of(bb))(b)     # (6, 4)
        JtJ = J.T @ J + 1e-9 * jnp.eye(4)
        step = jnp.linalg.solve(JtJ, J.T @ r)
        return b - step

    return jax.lax.fori_loop(0, iters, body, betas)


def _pose_from_betas(V, betas, alphas, Xw):
    """Camera control points from betas -> Horn alignment world->camera."""
    ccs = (betas @ V).reshape(4, 3)  # sum_k beta_k * v_k -> 4 control points
    pcs = alphas @ ccs                               # (n, 3) camera-frame points
    # enforce positive depth (EPnP sign ambiguity)
    flip = jnp.sum(jnp.sign(pcs[:, 2])) < 0
    pcs = jnp.where(flip, -pcs, pcs)

    # Horn: closed-form rigid alignment Xw -> pcs
    cw0 = Xw.mean(axis=0)
    cc0 = pcs.mean(axis=0)
    H = (Xw - cw0).T @ (pcs - cc0)
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    D = jnp.diag(jnp.stack([jnp.ones(()), jnp.ones(()), d]))
    R = Vt.T @ D @ U.T
    t = cc0 - R @ cw0
    return R, t


def epnp_single(Xw: jnp.ndarray, uv: jnp.ndarray, cam4: jnp.ndarray
                ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """EPnP closed form on one correspondence set.

    Xw (n, 3), uv (n, 2), cam4 = [fx, fy, cx, cy] -> (R (3,3), t (3,)).
    """
    fx, fy, cx, cy = cam4[0], cam4[1], cam4[2], cam4[3]
    cw = _control_points(Xw)
    alphas = _barycentric(Xw, cw)
    M = _build_M(alphas, uv, fx, fy, cx, cy)
    MtM = M.T @ M
    _, eigvec = jnp.linalg.eigh(MtM)
    V = eigvec[:, :4].T                              # (4, 12) smallest first
    L = _L6x10(V)
    rho = _rho(cw)

    def try_case(betas0):
        betas = _gauss_newton_betas(L, rho, betas0)
        R, t = _pose_from_betas(V, betas, alphas, Xw)
        Pc = Xw @ R.T + t
        z = jnp.where(jnp.abs(Pc[:, 2]) < 1e-6, 1e-6, Pc[:, 2])
        u = fx * Pc[:, 0] / z + cx
        v = fy * Pc[:, 1] / z + cy
        err = jnp.sum((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2)
        return err, R, t

    e1, R1, t1 = try_case(_betas_case1(L, rho))
    e2, R2, t2 = try_case(_betas_case2(L, rho))
    e3, R3, t3 = try_case(_betas_case3(L, rho))
    errs = jnp.stack([e1, e2, e3])
    Rs = jnp.stack([R1, R2, R3])
    ts = jnp.stack([t1, t2, t3])
    best = jnp.argmin(errs)
    return Rs[best], ts[best]


class PnPResult(NamedTuple):
    R: jnp.ndarray            # (3, 3)
    t: jnp.ndarray            # (3,)
    inliers: jnp.ndarray      # (N,) bool
    n_inliers: jnp.ndarray    # () int32
    ok: jnp.ndarray           # () bool


@functools.partial(jax.jit, static_argnames=("n_hyp",))
@f32_matmuls
def epnp_ransac(
    Xw: jnp.ndarray,          # (N, 3) world points
    uv: jnp.ndarray,          # (N, 2) observations
    sigma2: jnp.ndarray,      # (N,) per-match sigma^2 (levelSigma2[octave])
    active: jnp.ndarray,      # (N,) bool
    cam4: jnp.ndarray,        # [fx, fy, cx, cy]
    key: jnp.ndarray,         # PRNG key
    n_hyp: int = 128,
    chi2_th: float = 5.991,
    min_inliers: int = 10,
) -> PnPResult:
    """Parallel-hypothesis EPnP RANSAC + inlier-set refinement."""
    n = Xw.shape[0]
    weights = active.astype(jnp.float32)
    # sample minimal sets of 4 among active correspondences
    idx = jax.random.categorical(
        key, jnp.log(weights + 1e-9)[None, :].repeat(n_hyp * 4, 0)
    ).reshape(n_hyp, 4)

    def solve_one(ids):
        return epnp_single(Xw[ids], uv[ids], cam4)

    Rs, ts = jax.vmap(solve_one)(idx)               # (H, 3, 3), (H, 3)

    # count inliers per hypothesis
    Pc = jnp.einsum("hij,nj->hni", Rs, Xw) + ts[:, None, :]
    z = jnp.where(jnp.abs(Pc[..., 2]) < 1e-6, 1e-6, Pc[..., 2])
    u = cam4[0] * Pc[..., 0] / z + cam4[2]
    v = cam4[1] * Pc[..., 1] / z + cam4[3]
    err2 = (u - uv[None, :, 0]) ** 2 + (v - uv[None, :, 1]) ** 2
    inl = (err2 / sigma2[None, :] < chi2_th) & (z > 0) & active[None, :]
    counts = inl.sum(axis=1)
    best = jnp.argmax(counts)

    # refine: EPnP over the best inlier set (weighted by membership —
    # non-inliers contribute via zeroed rows using a masked gather trick:
    # resample indices from the inlier set)
    best_inl = inl[best]
    k2 = jax.random.fold_in(key, 1)
    ridx = jax.random.categorical(
        k2, jnp.log(best_inl.astype(jnp.float32) + 1e-9)[None, :].repeat(64, 0)
    )
    R_ref, t_ref = epnp_single(Xw[ridx], uv[ridx], cam4)

    Pc = Xw @ R_ref.T + t_ref
    z = jnp.where(jnp.abs(Pc[:, 2]) < 1e-6, 1e-6, Pc[:, 2])
    u = cam4[0] * Pc[:, 0] / z + cam4[2]
    v = cam4[1] * Pc[:, 1] / z + cam4[3]
    err2 = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
    inliers = (err2 / sigma2 < chi2_th) & (z > 0) & active
    n_in = inliers.sum()

    # fall back to the raw best hypothesis if refinement regressed
    use_ref = n_in >= counts[best]
    R = jnp.where(use_ref, R_ref, Rs[best])
    t = jnp.where(use_ref, t_ref, ts[best])
    inliers = jnp.where(use_ref, inliers, best_inl)
    n_in = jnp.maximum(n_in, counts[best])
    return PnPResult(R=R, t=t, inliers=inliers, n_inliers=n_in,
                     ok=n_in >= min_inliers)
