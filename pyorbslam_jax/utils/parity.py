"""Device parity: the same jitted computation on two devices, compared.

``chip_smoke.py`` runs each check with the GPU against the host CPU in one
process; the CPU tests run the same helpers CPU against CPU, where every
comparison must come out exact.  Each ``*_parity`` function returns a flat
report dict; :func:`failures` holds a report to the tolerances below.

Tolerances, and why they are not zero on the GPU:
  * frame features — XLA may contract multiply-adds (FMA) in the pyramid
    resize and Gaussian blur and sums prefix scans in another order, so a
    pixel value can land on the other side of a ``jnp.round`` tie or a
    FAST threshold.  That moves single keypoints and flips single
    descriptor bits; it must stay rare (>= 99 % identical keypoints,
    median descriptor distance 0, mean <= 1 bit, >= 99 % of stereo depths
    within 1e-3 relative).
  * ``hamming_matrix`` — an s8 x s8 -> s32 product: exact, no tolerance.
  * pose optimisation / bundle adjustment — full-f32 LM (``f32_matmuls``)
    with reductions in another order: 1e-4 m and 1e-5 rad.
"""

from __future__ import annotations

import functools
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

KP_SHARE_MIN = 0.99
DESC_MEDIAN_MAX = 0.0
DESC_MEAN_MAX = 1.0
DEPTH_REL_TOL = 1e-3
DEPTH_SHARE_MIN = 0.99
POSE_T_TOL_M = 1e-4
POSE_R_TOL_RAD = 1e-5
# distributed vs single-device solvers (different reduction trees over
# 4 shards, CG stopped at a fixed iteration count)
DIST_T_TOL_M = 2e-3
DIST_R_TOL = 5e-3
# the essential graph's CG stops at a fixed iteration count short of
# convergence on a long ring, so the two engines agree to a share of the
# correction the solve applies, not to an absolute distance
DIST_PG_REL = 1e-2


class NotAGpu(RuntimeError):
    pass


def require_gpu(devices: Optional[list] = None) -> jax.Device:
    """The default device, if it is a GPU; raise otherwise (a CPU run
    must never pass for a run on the card)."""
    devs = jax.devices() if devices is None else devices
    if not devs or devs[0].platform != "gpu":
        found = devs[0].platform if devs else "none"
        raise NotAGpu(f"no GPU: JAX's default device platform is {found!r}")
    return devs[0]


def card_name_and_power() -> str:
    """``name, power.limit`` of every visible card, as nvidia-smi prints
    them (one line per card)."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        raise RuntimeError("nvidia-smi not found")
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def on_device(fn, device, *args):
    """Run jitted ``fn`` with every array argument committed to
    ``device``; results come back as numpy."""
    args = jax.device_put(args, device)
    return jax.tree_util.tree_map(np.asarray, fn(*args))


# ---------------------------------------------------------------------------
# frame features


def _kp_keys(f) -> Dict[Tuple[float, float, int], int]:
    idx = np.nonzero(f.valid)[0]
    return {(float(f.xy[i, 0]), float(f.xy[i, 1]), int(f.octave[i])): int(i)
            for i in idx}


def _popcount_rows(x: np.ndarray) -> np.ndarray:
    """Set bits per row of a (..., 8) uint32 array."""
    table = np.array([bin(i).count("1") for i in range(256)], np.int32)
    return table[np.ascontiguousarray(x).view(np.uint8)].reshape(
        x.shape[:-1] + (-1,)).sum(-1)


def compare_frames(fa, fb) -> dict:
    """Compare two StereoFrames (numpy fields): keypoints matched on
    identical (x, y, octave); descriptor Hamming distance and stereo
    depth over the matched keypoints."""
    ka, kb = _kp_keys(fa), _kp_keys(fb)
    common = sorted(set(ka) & set(kb))
    ia = np.array([ka[k] for k in common], np.int64)
    ib = np.array([kb[k] for k in common], np.int64)
    n = max(len(ka), len(kb), 1)
    rep = dict(n_kp_a=len(ka), n_kp_b=len(kb), n_matched=len(common),
               kp_share=len(common) / n)
    if len(common) == 0:
        return dict(rep, desc_median=float("nan"), desc_mean=float("nan"),
                    desc_max=-1, depth_share=0.0,
                    depth_rel_median=float("nan"), depth_rel_max=float("nan"))
    ham = _popcount_rows(fa.desc[ia] ^ fb.desc[ib])
    da, db = fa.depth[ia], fb.depth[ib]
    both = (da > 0) & (db > 0)
    rel = np.abs(da[both] - db[both]) / db[both]
    agree = np.where(both, False, (da > 0) == (db > 0))
    agree[np.nonzero(both)[0]] = rel <= DEPTH_REL_TOL
    return dict(
        rep,
        desc_median=float(np.median(ham)), desc_mean=float(ham.mean()),
        desc_max=int(ham.max()),
        n_depth_a=int((da > 0).sum()), n_depth_b=int((db > 0).sum()),
        depth_share=float(agree.mean()),
        depth_rel_median=float(np.median(rel)) if rel.size else 0.0,
        depth_rel_max=float(rel.max()) if rel.size else 0.0,
    )


def stereo_frame_on(device, left, right, cfg):
    """``build_stereo_frame`` of one pair on ``device``, as numpy."""
    from pyorbslam_jax.slam.frame import build_stereo_frame

    fn = jax.jit(functools.partial(build_stereo_frame, cfg=cfg))
    return on_device(fn, device, np.asarray(left), np.asarray(right))


def frame_parity(left, right, cfg, dev_a, dev_b) -> dict:
    """``build_stereo_frame`` on one stereo pair, on two devices."""
    return compare_frames(stereo_frame_on(dev_a, left, right, cfg),
                          stereo_frame_on(dev_b, left, right, cfg))


# ---------------------------------------------------------------------------
# Hamming distance


def hamming_reference(a: np.ndarray, b: np.ndarray,
                      rows: int = 128) -> np.ndarray:
    """Plain numpy popcount(a_i ^ b_j), row block by row block."""
    out = np.empty((a.shape[0], b.shape[0]), np.int32)
    for r0 in range(0, a.shape[0], rows):
        out[r0:r0 + rows] = _popcount_rows(a[r0:r0 + rows, None, :] ^ b[None])
    return out


def hamming_parity(device, n: int = 2048, m: int = 2048,
                   seed: int = 0) -> dict:
    from pyorbslam_jax.ops.hamming import hamming_matrix

    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (m, 8), dtype=np.uint32)
    got = on_device(jax.jit(hamming_matrix), device, a, b)
    ref = hamming_reference(a, b)
    return dict(shape=[n, m], n_mismatch=int((got != ref).sum()))


# ---------------------------------------------------------------------------
# pose optimisation and bundle adjustment on identical inputs


def pose_delta(Ta: np.ndarray, Tb: np.ndarray) -> Tuple[float, float]:
    """(camera-centre distance in m, rotation angle in rad) between two
    Tcw poses."""
    Ta = np.asarray(Ta, np.float64)
    Tb = np.asarray(Tb, np.float64)
    Ca = -Ta[:3, :3].T @ Ta[:3, 3]
    Cb = -Tb[:3, :3].T @ Tb[:3, 3]
    # ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2): exact for small angles,
    # where arccos of the trace loses everything below ~5e-4 rad
    chord = np.linalg.norm(Ta[:3, :3] - Tb[:3, :3]) / (2.0 * np.sqrt(2.0))
    return (float(np.linalg.norm(Ca - Cb)),
            float(2.0 * np.arcsin(min(chord, 1.0))))


_CAM = np.array([718.856, 718.856, 607.19, 185.22, 386.14], np.float32)


def _project(T, X, cam=_CAM):
    fx, fy, cx, cy, bf = cam
    Pc = X @ T[:3, :3].T + T[:3, 3]
    u = fx * Pc[:, 0] / Pc[:, 2] + cx
    v = fy * Pc[:, 1] / Pc[:, 2] + cy
    return np.stack([u, v, u - bf / Pc[:, 2]], 1), Pc[:, 2]


def _perturb(rng, T, rot, trans):
    from pyorbslam_jax.geometry import se3

    xi = np.concatenate([rng.normal(0, rot, 3), rng.normal(0, trans, 3)])
    return (np.asarray(se3.exp_se3(jnp.asarray(xi, jnp.float32)))
            @ T).astype(np.float32)


def pose_problem(seed: int = 0, n: int = 2000) -> tuple:
    """Motion-only pose optimisation inputs at the tracking width: ``n``
    stereo observations of known points, 0.5 px noise, 5 % outliers."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-15, 15, n), rng.uniform(-3, 3, n),
                  rng.uniform(4, 40, n)], 1).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    obs, _ = _project(T, X)
    obs += rng.normal(0, 0.5, obs.shape)
    out = rng.random(n) < 0.05
    obs[out, :2] += rng.uniform(20, 60, (int(out.sum()), 2))
    T0 = _perturb(rng, T, 0.01, 0.1)
    sigma = (1.0 / 1.44 ** rng.integers(0, 8, n)).astype(np.float32)
    return (T0, X, obs.astype(np.float32), sigma, np.ones(n, bool), _CAM)


def pose_parity(dev_a, dev_b, seed: int = 0) -> dict:
    from pyorbslam_jax.optim.pose_opt import pose_optimization

    args = pose_problem(seed)
    fn = jax.jit(lambda *a: pose_optimization(*a).Tcw)
    dt, dr = pose_delta(on_device(fn, dev_a, *args),
                        on_device(fn, dev_b, *args))
    return dict(n_obs=len(args[1]), t_m=dt, r_rad=dr)


def local_ba_problem(seed: int = 0, n_cam: int = 10, n_pnt: int = 4000):
    """A local-BA window: ``n_cam`` keyframes along +x (the first fixed),
    ``n_pnt`` points, 0.5 px noise, packed into the production grid
    layout (``ba.grid_pack_from_obs``)."""
    from pyorbslam_jax.optim import ba

    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-15, 15, n_pnt), rng.uniform(-3, 3, n_pnt),
                  rng.uniform(5, 40, n_pnt)], 1).astype(np.float32)
    Tt = np.tile(np.eye(4, dtype=np.float32), (n_cam, 1, 1))
    Tt[:, 0, 3] = -0.8 * np.arange(n_cam)
    oc, op, ouvr = [], [], []
    for c in range(n_cam):
        uvr, z = _project(Tt[c], X)
        ids = np.nonzero((z > 1) & (uvr[:, 0] > 0) & (uvr[:, 0] < 1241)
                         & (uvr[:, 1] > 0) & (uvr[:, 1] < 376))[0]
        oc.append(np.full(len(ids), c, np.int32))
        op.append(ids.astype(np.int32))
        ouvr.append(uvr[ids])
    oc, op = np.concatenate(oc), np.concatenate(op)
    ouvr = (np.concatenate(ouvr)
            + rng.normal(0, 0.5, (len(oc), 3))).astype(np.float32)
    octv = rng.integers(0, 8, len(oc)).astype(np.uint8)
    T0 = Tt.copy()
    for c in range(1, n_cam):
        T0[c] = _perturb(rng, Tt[c], 0.002, 0.03)
    X0 = (X + rng.normal(0, 0.05, X.shape)).astype(np.float32)
    fixed = np.arange(n_cam) == 0
    order = np.lexsort((fixed[oc], op))
    oc, op, ouvr, octv = oc[order], op[order], ouvr[order], octv[order]
    g_cam, g_uvrq, g_oct, g_act, *_ = ba.grid_pack_from_obs(
        oc, op, ouvr, octv, n_pnt, K=16)
    inv_sigma2 = (1.0 / 1.44 ** np.arange(8)).astype(np.float32)
    return (T0, fixed, X0, np.ones(n_pnt, bool), g_cam, g_uvrq, g_oct,
            g_act, _CAM, inv_sigma2)


def local_ba_parity(dev_a, dev_b, seed: int = 0) -> dict:
    from pyorbslam_jax.optim import ba

    args = local_ba_problem(seed)
    fn = jax.jit(lambda *a: ba.bundle_adjust_grid_packed(*a).cam_Tcw)
    Ta = on_device(fn, dev_a, *args)
    Tb = on_device(fn, dev_b, *args)
    d = np.array([pose_delta(Ta[c], Tb[c]) for c in range(len(Ta))])
    return dict(n_cam=len(Ta), n_pnt=len(args[2]),
                n_obs=int(args[7].sum()),
                t_m=float(d[:, 0].max()), r_rad=float(d[:, 1].max()))


# ---------------------------------------------------------------------------
# TF32 probe: do the formerly unscoped f32 products move results?


def precision_probe(frame1, frame2, T1, T2, cfg, dev_a, dev_b) -> dict:
    """Two-view triangulation (``ops.triangulation.triangulate_pair``) of
    one keyframe pair on both devices, with its full-f32 scope and
    without it (default matmul precision, which may be TF32 on a GPU).
    ``frame1``/``frame2`` are numpy StereoFrames, ``T1``/``T2`` Tcw."""
    from pyorbslam_jax.ops import triangulation as tri

    orb = cfg.orb
    c = cfg.camera
    args = (
        frame1.xy, frame1.octave, frame1.desc, frame1.u_right,
        frame1.depth, frame1.valid,
        frame2.xy, frame2.octave, frame2.desc, frame2.u_right,
        frame2.depth, frame2.valid,
        np.asarray(T1, np.float32), np.asarray(T2, np.float32),
        np.array([c.fx, c.fy, c.cx, c.cy, c.bf], np.float32),
        np.float32(c.baseline),
        orb.scale_factors.astype(np.float32), orb.level_sigma2,
    )
    scoped = tri.triangulate_pair.__wrapped__          # f32_matmuls wrapper
    unscoped = scoped.__wrapped__                      # raw function
    rep = {}
    ref = on_device(jax.jit(scoped, static_argnames=("scale_factor",)),
                    dev_b, *args)
    T1 = np.asarray(T1, np.float64)
    C1 = -T1[:3, :3].T @ T1[:3, 3]
    for name, fn in (("scoped", scoped), ("unscoped", unscoped)):
        got = on_device(jax.jit(fn, static_argnames=("scale_factor",)),
                        dev_a, *args)
        both = got.valid & ref.valid
        # position error relative to the point's distance: far points
        # with little parallax move metres along the ray for any rounding
        dist = np.linalg.norm(ref.pos_w[both] - C1, axis=1)
        rel = np.linalg.norm(got.pos_w[both] - ref.pos_w[both], axis=1) / dist
        rep[f"{name}_valid"] = [int(got.valid.sum()), int(ref.valid.sum())]
        rep[f"{name}_valid_mismatch"] = int((got.valid != ref.valid).sum())
        if rel.size:
            rep[f"{name}_rel_median"] = float(np.median(rel))
            rep[f"{name}_rel_p99"] = float(np.quantile(rel, 0.99))
            rep[f"{name}_rel_max"] = float(rel.max())
    return rep


# ---------------------------------------------------------------------------
# distributed solvers vs their single-device engines


def global_ba_problem(n_cam: int = 128, n_pnt: int = 32768,
                      obs_per_cam: int = 1024, seed: int = 0):
    """The ``tools/scaling_report.py`` problem: ``n_cam`` cameras along
    -x, ``n_pnt`` points, ``obs_per_cam`` observations per camera."""
    from pyorbslam_jax.optim.ba import BAProblem

    rng = np.random.default_rng(seed)
    fx, cx, cy, bf = 718.0, 607.0, 185.0, 386.0
    pts = np.stack([rng.uniform(-20, 20, n_pnt), rng.uniform(-3, 3, n_pnt),
                    rng.uniform(4, 60, n_pnt)], 1).astype(np.float32)
    cams = np.tile(np.eye(4, dtype=np.float32), (n_cam, 1, 1))
    cams[:, 0, 3] = -0.4 * np.arange(n_cam)
    obs_cam = np.repeat(np.arange(n_cam, dtype=np.int32), obs_per_cam)
    obs_pnt = np.concatenate([
        rng.choice(n_pnt, obs_per_cam, replace=False) for _ in range(n_cam)
    ]).astype(np.int32)
    Pc = (np.einsum("oij,oj->oi", cams[obs_cam, :3, :3], pts[obs_pnt])
          + cams[obs_cam, :3, 3])
    z = np.maximum(Pc[:, 2], 0.5)
    u = fx * Pc[:, 0] / z + cx
    v = fx * Pc[:, 1] / z + cy
    obs_uvr = np.stack([u, v, u - bf / z], 1).astype(np.float32)
    cams0 = cams.copy()
    for c in range(1, n_cam):
        cams0[c] = _perturb(rng, cams[c], 0.001, 0.02)
    noisy = (pts + rng.normal(0, 0.05, pts.shape)).astype(np.float32)
    return BAProblem(
        cam_Tcw=cams0, cam_fixed=np.arange(n_cam) == 0,
        pnt_pos=noisy, pnt_active=np.ones(n_pnt, bool),
        obs_cam=obs_cam, obs_pnt=obs_pnt, obs_uvr=obs_uvr,
        obs_inv_sigma2=np.ones(len(obs_cam), np.float32),
        obs_active=np.ones(len(obs_cam), bool),
        cam=np.array([fx, fx, cx, cy, bf], np.float32),
    )


def shard_bytes(tree) -> Dict[str, int]:
    """Bytes each device holds of the arrays in ``tree``."""
    out: Dict[str, int] = {}
    for leaf in jax.tree_util.tree_leaves(tree):
        for s in leaf.addressable_shards:
            key = str(s.device)
            out[key] = out.get(key, 0) + int(s.data.nbytes)
    return out


def dist_ba_parity(mesh, prob=None, iters1: int = 10, iters2: int = 0) -> dict:
    """Sharded implicit-Schur CG BA over ``mesh`` vs ``ba_cg`` on one
    device, same problem, same iteration counts (the global-BA
    schedule: ``gba_iters`` robust iterations, no second phase)."""
    from pyorbslam_jax.optim import ba_cg
    from pyorbslam_jax.parallel import dist_ba

    prob = global_ba_problem() if prob is None else prob
    n_shards = mesh.shape["map"]
    n_cam = prob.cam_Tcw.shape[0]
    dev0 = mesh.devices.flat[0]
    ref = ba_cg.bundle_adjust_cg(jax.device_put(prob, dev0),
                                 iters1=iters1, iters2=iters2)
    ref_T = np.asarray(ref.cam_Tcw)
    ref_P = np.asarray(ref.pnt_pos)

    new_pnt, (oc, ouvr, oisig), act = dist_ba.group_observations_by_point_shard(
        np.asarray(prob.obs_pnt), prob.pnt_pos.shape[0], n_shards,
        (np.asarray(prob.obs_cam), np.asarray(prob.obs_uvr),
         np.asarray(prob.obs_inv_sigma2)))
    gp = prob._replace(obs_cam=oc, obs_pnt=new_pnt, obs_uvr=ouvr,
                       obs_inv_sigma2=oisig, obs_active=act)
    sharded = dist_ba.shard_problem(gp, mesh)
    d_T, d_P, _ = dist_ba.distributed_bundle_adjust_cg(
        sharded, mesh, n_cam=n_cam, iters1=iters1, iters2=iters2)
    d_T, d_P = np.asarray(d_T), np.asarray(d_P)
    d = np.array([pose_delta(d_T[c], ref_T[c]) for c in range(n_cam)])
    pdiff = np.linalg.norm(d_P - ref_P, axis=1)
    moved = np.linalg.norm(ref_P - np.asarray(prob.pnt_pos), axis=1)
    return dict(
        n_cam=n_cam, n_pnt=int(prob.pnt_pos.shape[0]),
        n_obs=int(len(prob.obs_cam)), n_shards=n_shards,
        cam_t_max_m=float(d[:, 0].max()), cam_r_max_rad=float(d[:, 1].max()),
        pnt_median_m=float(np.median(pdiff)), pnt_max_m=float(pdiff.max()),
        pnt_moved_median_m=float(np.median(moved)),
        shard_bytes=shard_bytes(sharded),
    )


def pose_graph_problem(n_kf: int = 512, seed: int = 0):
    """An essential graph past the CG threshold: a ``n_kf``-keyframe ring
    (drifting odometry chain, covisibility edges to the next 3
    keyframes, one loop edge closing the ring)."""
    from pyorbslam_jax.geometry import se3

    rng = np.random.default_rng(seed)
    gt = []
    for i in range(n_kf):
        ang = 2 * np.pi * i / n_kf
        Twc = np.eye(4, dtype=np.float32)
        Twc[:3, :3] = np.asarray(se3.exp_so3(
            jnp.asarray(np.array([0, ang, 0], np.float32))))
        Twc[:3, 3] = [40 * np.sin(ang), 0, 40 * (1 - np.cos(ang))]
        gt.append(np.linalg.inv(Twc).astype(np.float32))
    gt = np.stack(gt)
    est = [gt[0]]
    for i in range(1, n_kf):
        est.append(_perturb(rng, gt[i] @ np.linalg.inv(gt[i - 1]),
                            0.002, 0.01) @ est[-1])
    est = np.stack(est).astype(np.float32)
    e_i, e_j, mR, mt = [], [], [], []
    for i in range(n_kf):
        for k in (1, 2, 3):
            j = i + k
            if j >= n_kf:
                continue
            S = est[j] @ np.linalg.inv(est[i])
            e_i.append(i), e_j.append(j), mR.append(S[:3, :3]), mt.append(S[:3, 3])
    loop = gt[0] @ np.linalg.inv(gt[n_kf - 1])
    e_i.append(n_kf - 1), e_j.append(0)
    mR.append(loop[:3, :3]), mt.append(loop[:3, 3])
    E = len(e_i)
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True
    return (est[:, :3, :3].copy(), est[:, :3, 3].copy(),
            np.ones(n_kf, np.float32), fixed,
            np.array(e_i, np.int32), np.array(e_j, np.int32),
            np.stack(mR).astype(np.float32), np.stack(mt).astype(np.float32),
            np.ones(E, np.float32), np.ones(E, bool))


def dist_pose_graph_parity(mesh, problem=None, cg_iters: int = 96) -> dict:
    """Sharded essential-graph solve vs ``optimize_pose_graph_cg``."""
    from pyorbslam_jax.optim.pose_graph import optimize_pose_graph_cg
    from pyorbslam_jax.parallel import dist_pose_graph

    problem = pose_graph_problem() if problem is None else problem
    R, t, s, fixed, e_i, e_j, mR, mt, ms, act = problem
    dev0 = mesh.devices.flat[0]
    ref = optimize_pose_graph_cg(*jax.device_put(problem, dev0),
                                 cg_iters=cg_iters)
    pe = dist_pose_graph.pad_edges(mesh.shape["map"], e_i, e_j, mR, mt, ms, act)
    reps, shds = dist_pose_graph.place_pose_graph(mesh, [R, t, s, fixed],
                                                  list(pe))
    res = dist_pose_graph.distributed_pose_graph(mesh, *reps, *shds,
                                                 cg_iters=cg_iters)
    ref_t = np.asarray(ref.t)
    return dict(
        n_kf=int(R.shape[0]), n_edges=int(len(e_i)),
        t_max_m=float(np.abs(np.asarray(res.t) - ref_t).max()),
        t_correction_max_m=float(np.abs(ref_t - t).max()),
        R_max=float(np.abs(np.asarray(res.R) - np.asarray(ref.R)).max()),
        shard_bytes=shard_bytes(shds),
    )


# ---------------------------------------------------------------------------


def failures(kind: str, rep: dict) -> List[str]:
    """The tolerance violations of one report (empty list: it passed)."""
    bad = []

    def need(ok, what):
        if not ok:
            bad.append(f"{kind}: {what}")

    if kind == "frame":
        need(rep["kp_share"] >= KP_SHARE_MIN,
             f"kp_share {rep['kp_share']} < {KP_SHARE_MIN}")
        need(rep["desc_median"] <= DESC_MEDIAN_MAX,
             f"desc_median {rep['desc_median']} > {DESC_MEDIAN_MAX}")
        need(rep["desc_mean"] <= DESC_MEAN_MAX,
             f"desc_mean {rep['desc_mean']} > {DESC_MEAN_MAX}")
        need(rep["depth_share"] >= DEPTH_SHARE_MIN,
             f"depth_share {rep['depth_share']} < {DEPTH_SHARE_MIN}")
    elif kind == "hamming":
        need(rep["n_mismatch"] == 0, f"{rep['n_mismatch']} entries differ")
    elif kind in ("pose", "local_ba"):
        need(rep["t_m"] <= POSE_T_TOL_M, f"t {rep['t_m']} m > {POSE_T_TOL_M}")
        need(rep["r_rad"] <= POSE_R_TOL_RAD,
             f"r {rep['r_rad']} rad > {POSE_R_TOL_RAD}")
    elif kind == "dist_ba":
        need(rep["cam_t_max_m"] <= DIST_T_TOL_M,
             f"cam_t_max {rep['cam_t_max_m']} m > {DIST_T_TOL_M}")
        need(rep["pnt_median_m"] <= DIST_T_TOL_M,
             f"pnt_median {rep['pnt_median_m']} m > {DIST_T_TOL_M}")
        need(len(rep["shard_bytes"]) == rep["n_shards"],
             f"arrays on {len(rep['shard_bytes'])} devices, "
             f"not {rep['n_shards']}")
    elif kind == "dist_pose_graph":
        lim = DIST_PG_REL * rep["t_correction_max_m"]
        need(rep["t_max_m"] <= lim, f"t_max {rep['t_max_m']} m > {lim}")
        need(rep["R_max"] <= DIST_R_TOL, f"R_max {rep['R_max']} > {DIST_R_TOL}")
    else:
        raise ValueError(kind)
    return bad
