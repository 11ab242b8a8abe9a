"""Distributed GBA at deployment map scale, built from a REAL System
map (round-3 verdict item 8): run the full pipeline on a synthetic
sequence, extract the resulting keyframe/landmark/observation structure
through the native core, tile it to >=500 cameras / >=200k observations
(rigid copies around a ring — preserving each copy's true covisibility
topology, the part a fabricated random problem can't reproduce), and
drive the mesh-sharded CG engine (parallel/dist_ba.py) against the
single-device CG engine on the identical problem.

Runs on the 8-device virtual CPU mesh (tests/conftest.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_jax.io.synthetic import generate_sequence
from pyorbslam_jax.optim import ba, ba_cg
from pyorbslam_jax.parallel import dist_ba
from pyorbslam_jax.slam.system import System


@pytest.fixture(scope="module")
def system_map(data_cache_dir):
    seq = generate_sequence(
        n_frames=40, width=512, height=160, trajectory="straight",
        speed=0.8, seed=3, cache_dir=data_cache_dir,
    )
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=512, height=160, bf=seq.bf, th_depth=40.0),
        orb=OrbConfig(n_features=1000),
    )
    sysm = System(cfg)
    for i in range(40):
        sysm.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
    return sysm


def _centers(T: np.ndarray) -> np.ndarray:
    """Camera centers from (N, 4, 4) Tcw.  Errors MUST be measured on
    centers: at a few hundred meters from the origin the Tcw translation
    COLUMN amplifies any orientation difference by the lever arm
    (|dt| ~ |dtheta| * |t|), which misreads a sub-milliradian rotation
    as tens of centimeters."""
    return np.einsum(
        "nij,nj->ni", -np.transpose(T[:, :3, :3], (0, 2, 1)), T[:, :3, 3])


def _ring_T(r: int, n: int, radius: float = 400.0) -> np.ndarray:
    """World->world rigid motion placing copy r on a big ring."""
    ang = 2 * np.pi * r / n
    c, s = np.cos(ang), np.sin(ang)
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    T[0, 3] = radius * np.sin(ang)
    T[2, 3] = radius * (1 - np.cos(ang))
    return T


def test_dist_gba_at_system_scale(system_map):
    assert len(jax.devices()) >= 8
    mesh = dist_ba.make_mesh(8)
    sysm = system_map
    m = sysm.map
    ks = m.keyframes
    lm = m.landmarks

    cams = np.asarray(
        [k for k in range(ks.n) if ks.alive[k]], np.int32)
    pnt_ids = m.core.observed_landmarks(lm.n)
    oc, op, okf, oft = m.core.assemble_obs(cams, pnt_ids, cap=1 << 20)
    C0, P0, O0 = len(cams), len(pnt_ids), len(oc)
    assert C0 >= 10 and O0 >= 4000, (C0, O0)

    inv_sigma2 = np.asarray(sysm.cfg.orb.inv_level_sigma2)
    uvr0 = np.stack([
        ks.kp_xy[okf, oft, 0], ks.kp_xy[okf, oft, 1],
        ks.u_right[okf, oft]], axis=1).astype(np.float32)
    isig0 = inv_sigma2[ks.kp_octave[okf, oft]].astype(np.float32)
    Tcw0 = ks.Tcw[cams].astype(np.float64)
    pos0 = lm.pos[pnt_ids].astype(np.float64)

    # ---- tile to >=512 cams / >=200k obs ----
    R = max(-(-512 // C0), -(-200_000 // O0))
    C, Ob = R * C0, R * O0
    n_shards = 8
    P = -(-R * P0 // n_shards) * n_shards
    rng = np.random.default_rng(11)

    cam_Tcw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    cam_fixed = np.zeros(C, bool)
    pnt_pos = np.zeros((P, 3), np.float32)
    pnt_active = np.zeros(P, bool)
    g_oc = np.empty(Ob, np.int32)
    g_op = np.empty(Ob, np.int32)
    g_uvr = np.tile(uvr0, (R, 1)).astype(np.float32)
    g_isig = np.tile(isig0, R).astype(np.float32)
    true_c = np.empty((C, 3), np.float64)
    for r in range(R):
        T = _ring_T(r, R)
        Tinv = np.linalg.inv(T)
        true_c[r * C0:(r + 1) * C0] = _centers(Tcw0 @ Tinv)
        Tcw_r = (Tcw0 @ Tinv).astype(np.float32)
        noise = rng.normal(0, 0.03, (C0, 3)).astype(np.float32)
        noise[0] = 0.0
        Tcw_r[:, :3, 3] += noise
        cam_Tcw[r * C0:(r + 1) * C0] = Tcw_r
        cam_fixed[r * C0] = True          # per-copy gauge anchor (KF0)
        pnt_pos[r * P0:(r + 1) * P0] = (
            pos0 @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        pnt_active[r * P0:(r + 1) * P0] = True
        g_oc[r * O0:(r + 1) * O0] = oc + r * C0
        g_op[r * O0:(r + 1) * O0] = op + r * P0

    assert C >= 500 and Ob >= 200_000, (C, Ob)

    new_pnt, (s_oc, s_uvr, s_isig), s_act = \
        dist_ba.group_observations_by_point_shard(
            g_op, P, n_shards, (g_oc, g_uvr, g_isig))
    prob = ba.BAProblem(
        cam_Tcw=jnp.asarray(cam_Tcw),
        cam_fixed=jnp.asarray(cam_fixed),
        pnt_pos=jnp.asarray(pnt_pos),
        pnt_active=jnp.asarray(pnt_active),
        obs_cam=jnp.asarray(s_oc),
        obs_pnt=jnp.asarray(new_pnt),
        obs_uvr=jnp.asarray(s_uvr),
        obs_inv_sigma2=jnp.asarray(s_isig),
        obs_active=jnp.asarray(s_act),
        cam=jnp.asarray([
            sysm.cfg.camera.fx, sysm.cfg.camera.fy, sysm.cfg.camera.cx,
            sysm.cfg.camera.cy, sysm.cfg.camera.bf], jnp.float32),
    )

    sharded = dist_ba.shard_problem(prob, mesh)
    d_cam, d_pnt, _ = dist_ba.distributed_bundle_adjust_cg(
        sharded, mesh, n_cam=C, iters1=3, iters2=0, cg_iters=48)
    d_cam = np.asarray(d_cam)
    assert np.isfinite(d_cam).all()

    err_before = np.linalg.norm(
        _centers(cam_Tcw.astype(np.float64)) - true_c, axis=1)
    err_after = np.linalg.norm(
        _centers(d_cam.astype(np.float64)) - true_c, axis=1)
    # the solve must pull the noised poses back toward the map's own
    # geometry (the System map is internally consistent to ~cm)
    assert np.median(err_after) < 0.8 * np.median(err_before), (
        np.median(err_after), np.median(err_before))

    # parity with the single-device CG engine on the identical problem
    ref = ba_cg.bundle_adjust_cg(prob, iters1=3, iters2=0, cg_iters=48)
    ref_err = np.linalg.norm(
        _centers(np.asarray(ref.cam_Tcw).astype(np.float64)) - true_c,
        axis=1)
    assert np.median(err_after) < 1.5 * np.median(ref_err) + 1e-3, (
        np.median(err_after), np.median(ref_err))
