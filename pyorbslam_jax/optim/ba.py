"""Bundle adjustment: batched Schur-complement Levenberg-Marquardt.

Replaces g2o's BlockSolver + ``set_marginalized(True)`` landmark
marginalization (used by Optimizer.local_bundle_adjustment:210-366 and
bundle_adjustment:21-121) with dense batched linear algebra on device:

  * per-observation stereo residuals/Jacobians (EdgeStereoSE3ProjectXYZ,
    edge_project_stereo_xyz.cpp:33-89) are computed for all edges at once;
  * the block-sparse normal equations are reduced by the Schur complement:
    3x3 landmark blocks are inverted batched, the camera-point coupling
    blocks W are scattered into a dense (6C x 3P) matrix, and the reduced
    camera system S = Hcc - W Hpp^-1 W^T is ONE big matmul — the
    dense-array replacement for sparse Cholesky;
  * the reference's two-phase schedule is preserved: 5 Huber iterations,
    chi2/depth gating that *excludes* bad edges and drops the robust
    kernel, 10 more iterations, then a final gate marking observations to
    erase (Optimizer.py:318-353).

Shapes are static in (C cams, P points, O observations); padding rides
along with zero weight.  f32 throughout with multiplicative LM damping —
validated to recover poses/structure to sub-centimeter on synthetic
problems (tests/test_ba.py).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.geometry import se3

from pyorbslam_jax.utils.precision import f32_matmuls

CHI2_STEREO = 7.815
HUBER_DELTA = float(np.sqrt(CHI2_STEREO))


class BAProblem(NamedTuple):
    """Fixed-shape BA problem arrays."""

    cam_Tcw: jnp.ndarray       # (C, 4, 4)
    cam_fixed: jnp.ndarray     # (C,) bool (includes padding slots)
    pnt_pos: jnp.ndarray       # (P, 3)
    pnt_active: jnp.ndarray    # (P,) bool
    obs_cam: jnp.ndarray       # (O,) int32
    obs_pnt: jnp.ndarray       # (O,) int32
    obs_uvr: jnp.ndarray       # (O, 3)
    obs_inv_sigma2: jnp.ndarray  # (O,)
    obs_active: jnp.ndarray    # (O,) bool
    cam: jnp.ndarray           # (5,) [fx, fy, cx, cy, bf]


class BAResult(NamedTuple):
    cam_Tcw: jnp.ndarray
    pnt_pos: jnp.ndarray
    obs_chi2: jnp.ndarray      # final per-observation chi2
    obs_depth_ok: jnp.ndarray  # final per-observation depth > 0
    obs_inlier: jnp.ndarray    # survived the final gate


@f32_matmuls
def _bmv(A, x):
    """Batched (..., i, j) @ (..., j) as broadcast-multiply-sum.  The
    inner dims here are 3/6 — far too small for a matrix unit, and a
    dot outside a precision context may run in reduced precision; the
    broadcast form is one elementwise fusion in exact f32."""
    return jnp.sum(A * x[..., None, :], axis=-1)


def _bmm(A, B):
    """Batched (..., i, j) @ (..., j, k); see :func:`_bmv`."""
    return jnp.sum(A[..., :, :, None] * B[..., None, :, :], axis=-2)


def _btb(A, B):
    """Batched A^T B: (..., i, j), (..., i, k) -> (..., j, k);
    see :func:`_bmv`."""
    return jnp.sum(A[..., :, :, None] * B[..., :, None, :], axis=-3)


def _btv(A, x):
    """Batched A^T x: (..., i, j), (..., i) -> (..., j); see :func:`_bmv`."""
    return jnp.sum(A * x[..., :, None], axis=-2)


def _residuals_light(prob: BAProblem, cam_Tcw, pnt_pos):
    """Residuals (O, 3) and depth (O,) only — the cost-evaluation path.
    Skips the Jacobian algebra (~60% of :func:`_residuals`), which the
    LM accept/reject test and the phase gates never need."""
    fx, fy, cx, cy, bf = (prob.cam[i] for i in range(5))
    T = cam_Tcw[prob.obs_cam]
    X = pnt_pos[prob.obs_pnt]
    Pc = _bmv(T[:, :3, :3], X) + T[:, :3, 3]
    x, y, z = Pc[:, 0], Pc[:, 1], Pc[:, 2]
    zsafe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    invz = 1.0 / zsafe
    u = fx * x * invz + cx
    v = fy * y * invz + cy
    ur = u - bf * invz
    e = prob.obs_uvr - jnp.stack([u, v, ur], axis=-1)
    return e, z


def _residuals(prob: BAProblem, cam_Tcw, pnt_pos):
    """Residuals (O, 3), Jacobians Jc (O, 3, 6), Jp (O, 3, 3), depth (O,)."""
    fx, fy, cx, cy, bf = (prob.cam[i] for i in range(5))
    T = cam_Tcw[prob.obs_cam]            # (O, 4, 4)
    X = pnt_pos[prob.obs_pnt]            # (O, 3)
    Pc = _bmv(T[:, :3, :3], X) + T[:, :3, 3]
    x, y, z = Pc[:, 0], Pc[:, 1], Pc[:, 2]
    zsafe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    invz = 1.0 / zsafe
    invz2 = invz * invz

    u = fx * x * invz + cx
    v = fy * y * invz + cy
    ur = u - bf * invz
    e = prob.obs_uvr - jnp.stack([u, v, ur], axis=-1)

    zeros = jnp.zeros_like(x)
    du = jnp.stack([fx * invz, zeros, -fx * x * invz2], axis=-1)
    dv = jnp.stack([zeros, fy * invz, -fy * y * invz2], axis=-1)
    dur = du + jnp.stack([zeros, zeros, bf * invz2], axis=-1)
    dh_dp = jnp.stack([du, dv, dur], axis=1)       # (O, 3, 3)

    dp_dxi = jnp.concatenate(
        [-se3.hat(Pc), jnp.broadcast_to(jnp.eye(3), Pc.shape[:-1] + (3, 3))],
        axis=-1,
    )                                              # (O, 3, 6)
    Jc = -_bmm(dh_dp, dp_dxi)
    Jp = -_bmm(dh_dp, T[:, :3, :3])
    return e, Jc, Jp, z


def _huber_w(chi2, delta):
    s = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    return jnp.where(chi2 <= delta * delta, 1.0, delta / s)


def _robust_cost(chi2, delta, use_huber):
    if not use_huber:
        return chi2
    s = jnp.sqrt(jnp.maximum(chi2, 1e-12))
    return jnp.where(chi2 <= delta * delta, chi2, 2 * delta * s - delta * delta)


def _inv3x3(M):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)
    adj = jnp.stack([
        jnp.stack([A, B, C], -1),
        jnp.stack([D, E, F], -1),
        jnp.stack([G, H, I], -1),
    ], -2)
    return adj / det[..., None, None]


@f32_matmuls
def _lm_iteration(prob: BAProblem, cam_Tcw, pnt_pos, active, lam, use_huber,
                  sorted_pnt: bool = False):
    n_cam = cam_Tcw.shape[0]
    n_pnt = pnt_pos.shape[0]
    n_obs = prob.obs_cam.shape[0]

    e, Jc, Jp, z = _residuals(prob, cam_Tcw, pnt_pos)
    chi2 = jnp.sum(e * e, axis=-1) * prob.obs_inv_sigma2
    w = _huber_w(chi2, HUBER_DELTA) if use_huber else jnp.ones_like(chi2)
    w = w * prob.obs_inv_sigma2 * active

    # camera-keyed block sums as ONE-HOT MATMULS: C is small (<=256), so
    # the (C, O) one-hot product replaces a segment_sum scatter
    onehot_c = (prob.obs_cam[:, None]
                == jnp.arange(n_cam, dtype=jnp.int32)[None, :]
                ).astype(jnp.float32)                       # (O, C)
    Hcc = (onehot_c.T @ (w[:, None, None] * _btb(Jc, Jc)).reshape(
        n_obs, 36)).reshape(n_cam, 6, 6)
    bc = onehot_c.T @ (w[:, None] * _btv(Jc, e))            # (C, 6)
    # point-keyed sums stay segmented (P is large), but the assembly
    # sorts observations by point so the reduction is a sorted-segment
    # pass instead of a random scatter
    Hpp = jax.ops.segment_sum(
        w[:, None, None] * _btb(Jp, Jp),
        prob.obs_pnt, num_segments=n_pnt, indices_are_sorted=sorted_pnt,
    )  # (P, 3, 3)
    bp = jax.ops.segment_sum(
        w[:, None] * _btv(Jp, e), prob.obs_pnt, n_pnt,
        indices_are_sorted=sorted_pnt,
    )  # (P, 3)

    # multiplicative LM damping on both block diagonals
    eye6 = jnp.eye(6)
    eye3 = jnp.eye(3)
    Hcc_d = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
    Hpp_d = Hpp + lam * Hpp * eye3 + 1e-8 * eye3
    Hpp_inv = _inv3x3(Hpp_d)

    W = w[:, None, None] * _btb(Jc, Jp)   # (O, 6, 3)
    WHinv = _bmm(W, Hpp_inv[prob.obs_pnt])  # (O, 6, 3)

    A = jnp.zeros((n_cam, 6, n_pnt, 3)).at[prob.obs_cam, :, prob.obs_pnt, :].add(W)
    M = jnp.zeros((n_cam, 6, n_pnt, 3)).at[prob.obs_cam, :, prob.obs_pnt, :].add(WHinv)
    A2 = A.reshape(n_cam * 6, n_pnt * 3)
    M2 = M.reshape(n_cam * 6, n_pnt * 3)

    S = jax.scipy.linalg.block_diag
    # dense reduced camera system
    Hcc_bd = jnp.zeros((n_cam * 6, n_cam * 6))
    idx = jnp.arange(n_cam)
    Hcc_bd = Hcc_bd.reshape(n_cam, 6, n_cam, 6).at[idx, :, idx, :].set(Hcc_d).reshape(n_cam * 6, n_cam * 6)
    S_red = Hcc_bd - jnp.dot(M2, A2.T, preferred_element_type=jnp.float32)
    rhs = bc.reshape(-1) - M2 @ bp.reshape(-1)

    # freeze fixed / padded cameras: identity rows+cols, zero rhs
    free = (~prob.cam_fixed).astype(jnp.float32)
    free6 = jnp.repeat(free, 6)
    S_red = S_red * free6[:, None] * free6[None, :] + jnp.diag(1.0 - free6)
    rhs = rhs * free6

    dc = -jnp.linalg.solve(S_red, rhs).reshape(n_cam, 6)

    # back-substitute points: dp = -Hpp^-1 (bp + sum_o W^T dc[cam_o])
    Wt_dc = _btv(W, dc[prob.obs_cam])       # (O, 3)
    acc = jax.ops.segment_sum(Wt_dc, prob.obs_pnt, num_segments=n_pnt,
                              indices_are_sorted=sorted_pnt)
    dp = -_bmv(Hpp_inv, bp + acc)
    dp = dp * prob.pnt_active[:, None]

    cam_new = se3.retract(cam_Tcw, dc)
    cam_new = jnp.where(prob.cam_fixed[:, None, None], cam_Tcw, cam_new)
    pnt_new = pnt_pos + dp

    # accept / reject on total robust cost.  The current state's cost
    # reuses the chi2 already computed at the top of this iteration
    # (same state — no second residual evaluation); the candidate uses
    # the Jacobian-free light path.  Together this removes 2 of the 3
    # full residual evaluations each LM iteration paid.
    cost_old = jnp.sum(_robust_cost(chi2, HUBER_DELTA, use_huber) * active)
    e2, _ = _residuals_light(prob, cam_new, pnt_new)
    c2 = jnp.sum(e2 * e2, axis=-1) * prob.obs_inv_sigma2
    cost_new = jnp.sum(_robust_cost(c2, HUBER_DELTA, use_huber) * active)
    improved = cost_new < cost_old
    cam_out = jnp.where(improved, cam_new, cam_Tcw)
    pnt_out = jnp.where(improved, pnt_new, pnt_pos)
    lam = jnp.where(improved, lam * 0.5, lam * 5.0)
    return cam_out, pnt_out, lam


class BAGridProblem(NamedTuple):
    """The scatter-free BA layout: observations as a dense (P, K) grid —
    row p holds point p's observations in slots 0..K-1 (inactive slots
    padded).  K is the max observations per point (<= C).  Every
    reduction the Schur solve needs then becomes a plain axis sum or an
    einsum — no scatters, no segment ids, no point gathers."""

    cam_Tcw: jnp.ndarray       # (C, 4, 4)
    cam_fixed: jnp.ndarray     # (C,) bool
    pnt_pos: jnp.ndarray       # (P, 3)
    pnt_active: jnp.ndarray    # (P,) bool
    g_cam: jnp.ndarray         # (P, K) int32 camera per slot
    g_uvr: jnp.ndarray         # (P, K, 3)
    g_isig: jnp.ndarray        # (P, K)
    g_act: jnp.ndarray         # (P, K) bool
    cam: jnp.ndarray           # (5,)


class BAGridResult(NamedTuple):
    cam_Tcw: jnp.ndarray
    pnt_pos: jnp.ndarray
    g_chi2: jnp.ndarray        # (P, K) final chi2 per grid slot
    g_depth_ok: jnp.ndarray    # (P, K)
    g_inlier: jnp.ndarray      # (P, K)


def grid_from_obs(oc: np.ndarray, op: np.ndarray, ouvr: np.ndarray,
                  oisig: np.ndarray, n_pnt: int, K: int = 8):
    """Host-side (numpy) layout of flat observations into the dense
    (P, K) grid.  Returns (g_cam, g_uvr, g_isig, g_act, slot, kept,
    n_dropped): ``slot[i]``/``kept[i]`` map flat observation i to its
    grid cell for reading per-observation results back.  Observations
    must be sorted by point id.

    K is FIXED (default 8): the mean observation count per point is
    ~2-3, so sizing K to the max (a few heavily-observed points) would
    pad the grid to a few percent utilization and recompile on every
    max change.  A point's observations beyond K are dropped from the
    problem — those points are the over-determined ones, and the erase
    pass treats dropped slots as inliers (never erased on grid
    evidence)."""
    first = np.searchsorted(op, op)
    slot = (np.arange(len(op)) - first).astype(np.int32)
    kept = slot < K
    n_dropped = int((~kept).sum())
    g_cam = np.zeros((n_pnt, K), np.int32)
    g_uvr = np.zeros((n_pnt, K, 3), np.float32)
    g_isig = np.zeros((n_pnt, K), np.float32)
    g_act = np.zeros((n_pnt, K), bool)
    pk, kk = op[kept], slot[kept]
    g_cam[pk, kk] = oc[kept]
    g_uvr[pk, kk] = ouvr[kept]
    g_isig[pk, kk] = oisig[kept]
    g_act[pk, kk] = True
    return g_cam, g_uvr, g_isig, g_act, slot, kept, n_dropped


UVR_Q = 16.0   # fixed-point scale for packed (u, v, u_r): 1/16 px


def grid_pack_from_obs(oc: np.ndarray, op: np.ndarray, ouvr: np.ndarray,
                       ooct: np.ndarray, n_pnt: int, K: int = 8):
    """Like :func:`grid_from_obs` but laid out in the PACKED upload
    dtypes: camera ids int16, (u, v, u_r) as 1/16-px int16 fixed point,
    per-slot octave uint8 (the inverse-sigma2 is a tiny per-octave
    table, looked up on device).  Per-slot bytes drop 21 -> 10, so the
    host->device upload of a local-BA problem halves.
    Quantization error <= 1/32 px — an order below the finest
    measurement sigma (1 px at octave 0)."""
    first = np.searchsorted(op, op)
    slot = (np.arange(len(op)) - first).astype(np.int32)
    kept = slot < K
    n_dropped = int((~kept).sum())
    g_cam = np.zeros((n_pnt, K), np.int16)
    g_uvrq = np.zeros((n_pnt, K, 3), np.int16)
    g_oct = np.zeros((n_pnt, K), np.uint8)
    g_act = np.zeros((n_pnt, K), bool)
    pk, kk = op[kept], slot[kept]
    g_cam[pk, kk] = oc[kept].astype(np.int16)
    g_uvrq[pk, kk] = np.round(ouvr[kept] * UVR_Q).astype(np.int16)
    g_oct[pk, kk] = ooct[kept].astype(np.uint8)
    g_act[pk, kk] = True
    return g_cam, g_uvrq, g_oct, g_act, slot, kept, n_dropped


@functools.partial(jax.jit, static_argnames=("iters1", "iters2"))
def bundle_adjust_grid_packed(cam_Tcw, cam_fixed, pnt_pos, pnt_active,
                              g_cam16, g_uvrq16, g_oct8, g_act, cam,
                              isig_table, iters1: int = 5,
                              iters2: int = 10) -> BAGridResult:
    """Device-side unpack of :func:`grid_pack_from_obs` + the standard
    grid solve — same math as :func:`bundle_adjust_grid`, half the
    host->device bytes."""
    prob = BAGridProblem(
        cam_Tcw=cam_Tcw, cam_fixed=cam_fixed,
        pnt_pos=pnt_pos, pnt_active=pnt_active,
        g_cam=g_cam16.astype(jnp.int32),
        g_uvr=g_uvrq16.astype(jnp.float32) * jnp.float32(1.0 / UVR_Q),
        g_isig=isig_table[g_oct8.astype(jnp.int32)],
        g_act=g_act, cam=cam)
    return bundle_adjust_grid(prob, iters1=iters1, iters2=iters2)


def _grid_residuals(prob: BAGridProblem, cam_Tcw, pnt_pos, light=False):
    """Grid residuals: e (P, K, 3), Jc (P, K, 3, 6), Jp (P, K, 3, 3),
    z (P, K).  Points broadcast along K — no per-observation gather."""
    fx, fy, cx, cy, bf = (prob.cam[i] for i in range(5))
    T = cam_Tcw[prob.g_cam]                  # (P, K, 4, 4)
    R = T[..., :3, :3]
    Pc = _bmv(R, pnt_pos[:, None, :]) + T[..., :3, 3]
    x, y, z = Pc[..., 0], Pc[..., 1], Pc[..., 2]
    zsafe = jnp.where(jnp.abs(z) < 1e-6, 1e-6, z)
    invz = 1.0 / zsafe
    invz2 = invz * invz
    u = fx * x * invz + cx
    v = fy * y * invz + cy
    ur = u - bf * invz
    e = prob.g_uvr - jnp.stack([u, v, ur], axis=-1)
    if light:
        return e, None, None, z
    zeros = jnp.zeros_like(x)
    du = jnp.stack([fx * invz, zeros, -fx * x * invz2], axis=-1)
    dv = jnp.stack([zeros, fy * invz, -fy * y * invz2], axis=-1)
    dur = du + jnp.stack([zeros, zeros, bf * invz2], axis=-1)
    dh_dp = jnp.stack([du, dv, dur], axis=-2)        # (P, K, 3, 3)
    dp_dxi = jnp.concatenate(
        [-se3.hat(Pc),
         jnp.broadcast_to(jnp.eye(3), Pc.shape[:-1] + (3, 3))], axis=-1)
    Jc = -_bmm(dh_dp, dp_dxi)                        # (P, K, 3, 6)
    Jp = -_bmm(dh_dp, R)                             # (P, K, 3, 3)
    return e, Jc, Jp, z


@f32_matmuls
def _grid_lm_iteration(prob: BAGridProblem, cam_Tcw, pnt_pos, active,
                       lam, use_huber):
    n_cam = cam_Tcw.shape[0]
    P, K = prob.g_cam.shape

    e, Jc, Jp, z = _grid_residuals(prob, cam_Tcw, pnt_pos)
    chi2 = jnp.sum(e * e, axis=-1) * prob.g_isig
    w = _huber_w(chi2, HUBER_DELTA) if use_huber else jnp.ones_like(chi2)
    w = w * prob.g_isig * active                     # (P, K)

    onehot = (prob.g_cam[..., None]
              == jnp.arange(n_cam, dtype=jnp.int32)).astype(jnp.float32)
    onehot = onehot * w[..., None]                   # (P, K, C) weighted

    # camera blocks: one einsum each, no scatters
    JcJc = _btb(Jc, Jc)                              # (P, K, 6, 6)
    Jce = _btv(Jc, e)                                # (P, K, 6)
    Hcc = jnp.einsum("pkc,pkij->cij", onehot, JcJc)
    bc = jnp.einsum("pkc,pki->ci", onehot, Jce)
    # point blocks: plain K-axis sums
    Hpp = jnp.sum(w[..., None, None] * _btb(Jp, Jp), axis=1)   # (P, 3, 3)
    bp = jnp.sum(w[..., None] * _btv(Jp, e), axis=1)           # (P, 3)

    eye6 = jnp.eye(6)
    eye3 = jnp.eye(3)
    Hcc_d = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
    Hpp_d = Hpp + lam * Hpp * eye3 + 1e-8 * eye3
    Hpp_inv = _inv3x3(Hpp_d)

    W = w[..., None, None] * _btb(Jc, Jp)            # (P, K, 6, 3)
    WHinv = _bmm(W, Hpp_inv[:, None])                # (P, K, 6, 3)

    # per-point camera-stacked blocks via one-hot einsum (the scatter
    # the flat layout needed), then the reduced system as one matmul
    onehot01 = (prob.g_cam[..., None]
                == jnp.arange(n_cam, dtype=jnp.int32)).astype(jnp.float32)
    A = jnp.einsum("pkc,pkix->pcix", onehot01, W)       # (P, C, 6, 3)
    M = jnp.einsum("pkc,pkix->pcix", onehot01, WHinv)   # (P, C, 6, 3)
    Hcc_bd = jnp.zeros((n_cam, 6, n_cam, 6))
    idx = jnp.arange(n_cam)
    Hcc_bd = Hcc_bd.at[idx, :, idx, :].set(Hcc_d)
    S_red = Hcc_bd.reshape(n_cam * 6, n_cam * 6) - jnp.einsum(
        "pcix,pdjx->cidj", M, A).reshape(n_cam * 6, n_cam * 6)
    rhs = bc.reshape(-1) - jnp.einsum("pcix,px->ci", M, bp).reshape(-1)

    free = (~prob.cam_fixed).astype(jnp.float32)
    free6 = jnp.repeat(free, 6)
    S_red = S_red * free6[:, None] * free6[None, :] + jnp.diag(1.0 - free6)
    rhs = rhs * free6

    dc = -jnp.linalg.solve(S_red, rhs).reshape(n_cam, 6)

    # back-substitute: dp = -Hpp^-1 (bp + sum_k W^T dc[cam])
    Wt_dc = _btv(W, dc[prob.g_cam])                  # (P, K, 3)
    dp = -_bmv(Hpp_inv, bp + jnp.sum(Wt_dc, axis=1))
    dp = dp * prob.pnt_active[:, None]

    cam_new = se3.retract(cam_Tcw, dc)
    cam_new = jnp.where(prob.cam_fixed[:, None, None], cam_Tcw, cam_new)
    pnt_new = pnt_pos + dp

    cost_old = jnp.sum(_robust_cost(chi2, HUBER_DELTA, use_huber) * active)
    e2, _, _, _ = _grid_residuals(prob, cam_new, pnt_new, light=True)
    c2 = jnp.sum(e2 * e2, axis=-1) * prob.g_isig
    cost_new = jnp.sum(_robust_cost(c2, HUBER_DELTA, use_huber) * active)
    improved = cost_new < cost_old
    cam_out = jnp.where(improved, cam_new, cam_Tcw)
    pnt_out = jnp.where(improved, pnt_new, pnt_pos)
    lam = jnp.where(improved, lam * 0.5, lam * 5.0)
    return cam_out, pnt_out, lam


@functools.partial(jax.jit, static_argnames=("iters1", "iters2"))
@f32_matmuls
def bundle_adjust_grid(prob: BAGridProblem, iters1: int = 5,
                       iters2: int = 10) -> BAGridResult:
    """Local/global BA on the dense observation grid — the reference's
    two-phase gating schedule (Optimizer.py:318-353), scatter-free."""
    active = prob.g_act.astype(jnp.float32)

    def phase(carry, iters, use_huber, act):
        def body(_, st):
            cT, pP, lam = st
            return _grid_lm_iteration(prob, cT, pP, act, lam, use_huber)

        cT, pP, _ = jax.lax.fori_loop(
            0, iters, body, carry + (jnp.float32(1e-4),))
        return cT, pP

    cam_Tcw, pnt_pos = phase(
        (prob.cam_Tcw, prob.pnt_pos), iters1, True, active)

    e, _, _, z = _grid_residuals(prob, cam_Tcw, pnt_pos, light=True)
    chi2 = jnp.sum(e * e, axis=-1) * prob.g_isig
    good = (chi2 <= CHI2_STEREO) & (z > 0)
    active2 = active * good.astype(jnp.float32)

    cam_Tcw, pnt_pos = phase((cam_Tcw, pnt_pos), iters2, False, active2)

    e, _, _, z = _grid_residuals(prob, cam_Tcw, pnt_pos, light=True)
    chi2 = jnp.sum(e * e, axis=-1) * prob.g_isig
    depth_ok = z > 0
    inlier = prob.g_act & (chi2 <= CHI2_STEREO) & depth_ok
    return BAGridResult(
        cam_Tcw=cam_Tcw, pnt_pos=pnt_pos, g_chi2=chi2,
        g_depth_ok=depth_ok, g_inlier=inlier,
    )


@functools.partial(
    jax.jit, static_argnames=("iters1", "iters2", "sorted_pnt"))
@f32_matmuls
def bundle_adjust(prob: BAProblem, iters1: int = 5, iters2: int = 10,
                  sorted_pnt: bool = False) -> BAResult:
    """Local/global BA with the reference's two-phase gating schedule.
    Pass ``sorted_pnt=True`` when observations are sorted by point id
    (slam_map assembles them that way) — the point-block reductions then
    run as sorted-segment passes."""
    active = prob.obs_active.astype(jnp.float32)

    def phase(carry, iters, use_huber, act):
        cam_Tcw, pnt_pos = carry

        def body(_, st):
            cT, pP, lam = st
            cT, pP, lam = _lm_iteration(prob, cT, pP, act, lam, use_huber,
                                        sorted_pnt)
            return cT, pP, lam

        cT, pP, _ = jax.lax.fori_loop(
            0, iters, body, (cam_Tcw, pnt_pos, jnp.float32(1e-4))
        )
        return cT, pP

    cam_Tcw, pnt_pos = phase((prob.cam_Tcw, prob.pnt_pos), iters1, True, active)

    # gate: chi2 > 7.815 or non-positive depth -> exclude; kernel dropped
    e, z = _residuals_light(prob, cam_Tcw, pnt_pos)
    chi2 = jnp.sum(e * e, axis=-1) * prob.obs_inv_sigma2
    good = (chi2 <= CHI2_STEREO) & (z > 0)
    active2 = active * good.astype(jnp.float32)

    cam_Tcw, pnt_pos = phase((cam_Tcw, pnt_pos), iters2, False, active2)

    e, z = _residuals_light(prob, cam_Tcw, pnt_pos)
    chi2 = jnp.sum(e * e, axis=-1) * prob.obs_inv_sigma2
    depth_ok = z > 0
    inlier = prob.obs_active & (chi2 <= CHI2_STEREO) & depth_ok
    return BAResult(
        cam_Tcw=cam_Tcw, pnt_pos=pnt_pos, obs_chi2=chi2,
        obs_depth_ok=depth_ok, obs_inlier=inlier,
    )
