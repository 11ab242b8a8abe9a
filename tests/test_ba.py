"""Schur-reduced bundle adjustment unit tests on synthetic problems."""

import jax.numpy as jnp
import numpy as np
import pytest

from pyorbslam_jax.geometry import se3
from pyorbslam_jax.optim import ba


def make_ba_problem(
    rng, n_cam=8, n_pnt=200, noise_px=0.3, pose_noise=0.05, pnt_noise=0.10,
    outlier_frac=0.0, pad_cam=0, pad_pnt=0, pnt_span=None,
):
    fx = fy = 400.0
    cx, cy = 320.0, 120.0
    bf = 180.0
    cam_vec = np.array([fx, fy, cx, cy, bf], np.float32)

    # cameras along a line, looking +z
    T_true = np.tile(np.eye(4, dtype=np.float32), (n_cam, 1, 1))
    for i in range(n_cam):
        T_true[i, :3, 3] = [-0.8 * i + rng.normal(0, 0.1), rng.normal(0, 0.05), rng.normal(0, 0.1)]

    if pnt_span is None:
        pnt_span = (-12.0, 12.0)  # default: points around the short trajectory
    pts = np.stack([
        rng.uniform(pnt_span[0], pnt_span[1], n_pnt),
        rng.uniform(-4, 4, n_pnt),
        rng.uniform(6, 40, n_pnt),
    ], 1).astype(np.float32)

    obs_cam, obs_pnt, obs_uvr = [], [], []
    for c in range(n_cam):
        Pc = pts @ T_true[c, :3, :3].T + T_true[c, :3, 3]
        u = fx * Pc[:, 0] / Pc[:, 2] + cx
        v = fy * Pc[:, 1] / Pc[:, 2] + cy
        ur = u - bf / Pc[:, 2]
        vis = (Pc[:, 2] > 1) & (u > 0) & (u < 640) & (v > 0) & (v < 240)
        ids = np.nonzero(vis)[0]
        obs_cam += [c] * len(ids)
        obs_pnt += ids.tolist()
        obs_uvr.append(np.stack([u[ids], v[ids], ur[ids]], 1))
    obs_cam = np.array(obs_cam, np.int32)
    obs_pnt = np.array(obs_pnt, np.int32)
    obs_uvr = np.concatenate(obs_uvr).astype(np.float32)
    obs_uvr += rng.normal(0, noise_px, obs_uvr.shape).astype(np.float32)

    n_out = int(outlier_frac * len(obs_cam))
    if n_out:
        sel = rng.choice(len(obs_cam), n_out, replace=False)
        obs_uvr[sel, :2] += rng.uniform(15, 60, (n_out, 2)).astype(np.float32)

    # perturb initial estimates (first camera fixed at truth)
    T0 = T_true.copy()
    for i in range(1, n_cam):
        xi = np.concatenate([
            rng.normal(0, pose_noise * 0.2, 3), rng.normal(0, pose_noise, 3)
        ]).astype(np.float32)
        T0[i] = np.asarray(se3.exp_se3(jnp.asarray(xi))) @ T_true[i]
    p0 = pts + rng.normal(0, pnt_noise, pts.shape).astype(np.float32)

    C = n_cam + pad_cam
    P = n_pnt + pad_pnt
    O = len(obs_cam)
    prob = ba.BAProblem(
        cam_Tcw=jnp.asarray(np.concatenate([T0, np.tile(np.eye(4, dtype=np.float32), (pad_cam, 1, 1))])),
        cam_fixed=jnp.asarray(np.array([True] + [False] * (n_cam - 1) + [True] * pad_cam)),
        pnt_pos=jnp.asarray(np.concatenate([p0, np.zeros((pad_pnt, 3), np.float32)])),
        pnt_active=jnp.asarray(np.array([True] * n_pnt + [False] * pad_pnt)),
        obs_cam=jnp.asarray(obs_cam),
        obs_pnt=jnp.asarray(obs_pnt),
        obs_uvr=jnp.asarray(obs_uvr),
        obs_inv_sigma2=jnp.ones(O, jnp.float32),
        obs_active=jnp.ones(O, bool),
        cam=jnp.asarray(cam_vec),
    )
    return prob, T_true, pts


class TestBundleAdjust:
    def test_clean_recovery(self):
        rng = np.random.default_rng(0)
        prob, T_true, pts = make_ba_problem(rng, noise_px=0.0)
        res = ba.bundle_adjust(prob)
        cam_err = np.linalg.norm(
            np.asarray(res.cam_Tcw)[:, :3, 3] - T_true[:, :3, 3], axis=1
        )
        assert cam_err.max() < 5e-3, cam_err
        pnt_err = np.linalg.norm(np.asarray(res.pnt_pos) - pts, axis=1)
        assert np.median(pnt_err) < 2e-2, np.median(pnt_err)

    def test_noisy_recovery_improves_initialization(self):
        rng = np.random.default_rng(1)
        prob, T_true, pts = make_ba_problem(
            rng, noise_px=0.4, pose_noise=0.08, pnt_noise=0.15
        )
        res = ba.bundle_adjust(prob)
        init_err = np.linalg.norm(
            np.asarray(prob.cam_Tcw)[:, :3, 3] - T_true[:, :3, 3], axis=1
        )
        final_err = np.linalg.norm(
            np.asarray(res.cam_Tcw)[:, :3, 3] - T_true[:, :3, 3], axis=1
        )
        assert final_err.mean() < 0.3 * init_err.mean(), (init_err, final_err)
        # far cameras drift from the single gauge anchor; 0.4px noise at
        # 6-40m depth bounds accuracy to a few cm
        assert final_err.max() < 0.06

    def test_outlier_gating(self):
        rng = np.random.default_rng(2)
        prob, T_true, pts = make_ba_problem(
            rng, noise_px=0.3, outlier_frac=0.15
        )
        res = ba.bundle_adjust(prob)
        n_obs = len(np.asarray(prob.obs_cam))
        inlier_rate = float(np.asarray(res.obs_inlier).mean())
        assert 0.75 < inlier_rate < 0.92, inlier_rate
        final_err = np.linalg.norm(
            np.asarray(res.cam_Tcw)[:, :3, 3] - T_true[:, :3, 3], axis=1
        )
        assert final_err.max() < 0.03, final_err

    def test_padding_is_inert(self):
        rng = np.random.default_rng(3)
        prob_a, T_true, _ = make_ba_problem(rng, noise_px=0.2)
        rng = np.random.default_rng(3)
        prob_b, _, _ = make_ba_problem(rng, noise_px=0.2, pad_cam=4, pad_pnt=50)
        res_a = ba.bundle_adjust(prob_a)
        res_b = ba.bundle_adjust(prob_b)
        n_cam = T_true.shape[0]
        np.testing.assert_allclose(
            np.asarray(res_a.cam_Tcw), np.asarray(res_b.cam_Tcw)[:n_cam],
            atol=1e-4,
        )

    def test_fixed_camera_untouched(self):
        rng = np.random.default_rng(4)
        prob, T_true, _ = make_ba_problem(rng, noise_px=0.3)
        res = ba.bundle_adjust(prob)
        np.testing.assert_allclose(
            np.asarray(res.cam_Tcw)[0], np.asarray(prob.cam_Tcw)[0], atol=1e-7
        )


class TestBundleAdjustCG:
    """Implicit-Schur PCG engine (optim/ba_cg.py) — the global-BA path."""

    def test_cg_matches_dense(self):
        from pyorbslam_jax.optim import ba_cg

        rng = np.random.default_rng(10)
        prob, T_true, pts = make_ba_problem(
            rng, noise_px=0.3, pose_noise=0.06, pnt_noise=0.12
        )
        res_d = ba.bundle_adjust(prob)
        res_c = ba_cg.bundle_adjust_cg(prob, cg_iters=96)
        err_d = np.linalg.norm(
            np.asarray(res_d.cam_Tcw)[:, :3, 3] - T_true[:, :3, 3], axis=1
        )
        err_c = np.linalg.norm(
            np.asarray(res_c.cam_Tcw)[:, :3, 3] - T_true[:, :3, 3], axis=1
        )
        # both engines converge to the same optimum within solver noise
        assert err_c.max() < max(2.0 * err_d.max(), 0.02), (err_d, err_c)

    def test_cg_outlier_gating(self):
        from pyorbslam_jax.optim import ba_cg

        rng = np.random.default_rng(11)
        prob, T_true, _ = make_ba_problem(rng, noise_px=0.3, outlier_frac=0.15)
        res = ba_cg.bundle_adjust_cg(prob)
        inlier_rate = float(np.asarray(res.obs_inlier).mean())
        assert 0.75 < inlier_rate < 0.92, inlier_rate
        final_err = np.linalg.norm(
            np.asarray(res.cam_Tcw)[:, :3, 3] - T_true[:, :3, 3], axis=1
        )
        assert final_err.max() < 0.05, final_err

    def test_cg_large_problem(self):
        """A problem size the dense engine cannot touch: 192 cams, 12k
        points (dense coupling would be 192*6 x 12000*3 = 41M floats per
        materialization x2)."""
        from pyorbslam_jax.optim import ba_cg

        rng = np.random.default_rng(12)
        prob, T_true, pts = make_ba_problem(
            rng, n_cam=192, n_pnt=12000, noise_px=0.3,
            pose_noise=0.04, pnt_noise=0.10,
            pnt_span=(-12.0, 0.8 * 191 + 12.0),  # cover the whole trajectory
        )
        res = ba_cg.bundle_adjust_cg(prob, iters1=4, iters2=6, cg_iters=48)
        init_err = np.linalg.norm(
            np.asarray(prob.cam_Tcw)[:, :3, 3] - T_true[:, :3, 3], axis=1
        )
        final_err = np.linalg.norm(
            np.asarray(res.cam_Tcw)[:, :3, 3] - T_true[:, :3, 3], axis=1
        )
        assert final_err.mean() < 0.3 * init_err.mean(), (
            init_err.mean(), final_err.mean()
        )

    def test_cg_fixed_camera_untouched(self):
        from pyorbslam_jax.optim import ba_cg

        rng = np.random.default_rng(13)
        prob, _, _ = make_ba_problem(rng, noise_px=0.3)
        res = ba_cg.bundle_adjust_cg(prob)
        np.testing.assert_allclose(
            np.asarray(res.cam_Tcw)[0], np.asarray(prob.cam_Tcw)[0], atol=1e-7
        )


class TestGridLongTracks:
    """Points observed by more free cameras than the
    grid width K silently lose pose constraints.  The adaptive-K path
    (slam_map picks K in {8,16,32} so no free-camera observation drops)
    must match the flat engine, which uses every observation."""

    def test_adaptive_k_matches_flat_on_long_tracks(self):
        rng = np.random.default_rng(5)
        prob, T_true, pts = make_ba_problem(
            rng, n_cam=12, n_pnt=160, noise_px=0.3, pose_noise=0.04,
            pnt_noise=0.08)
        oc = np.asarray(prob.obs_cam)
        op = np.asarray(prob.obs_pnt)
        ouvr = np.asarray(prob.obs_uvr)
        ois = np.asarray(prob.obs_inv_sigma2)
        cam_fixed = np.asarray(prob.cam_fixed)
        # the production assembly order: by point, free cameras first
        order = np.lexsort((cam_fixed[oc], op))
        oc, op, ouvr, ois = oc[order], op[order], ouvr[order], ois[order]
        # long tracks exist (this is the premise of the test)
        assert np.bincount(op).max() > 8
        P = int(prob.pnt_pos.shape[0])

        def run_grid(K):
            g_cam, g_uvr, g_isig, g_act, _, _, n_drop = ba.grid_from_obs(
                oc, op, ouvr, ois, P, K=K)
            gprob = ba.BAGridProblem(
                cam_Tcw=prob.cam_Tcw, cam_fixed=prob.cam_fixed,
                pnt_pos=prob.pnt_pos, pnt_active=prob.pnt_active,
                g_cam=jnp.asarray(g_cam), g_uvr=jnp.asarray(g_uvr),
                g_isig=jnp.asarray(g_isig), g_act=jnp.asarray(g_act),
                cam=prob.cam)
            res = ba.bundle_adjust_grid(gprob)
            return np.asarray(res.cam_Tcw), n_drop

        def cam_err(Tcw):
            C = len(T_true)
            err = 0.0
            for i in range(C):
                Ce = -Tcw[i, :3, :3].T @ Tcw[i, :3, 3]
                Ct = -T_true[i, :3, :3].T @ T_true[i, :3, 3]
                err += float(np.linalg.norm(Ce - Ct))
            return err / C

        flat = ba.bundle_adjust(prob)
        e_flat = cam_err(np.asarray(flat.cam_Tcw))

        cam16, drop16 = run_grid(16)
        cam8, drop8 = run_grid(8)
        assert drop8 > 0, "K=8 must drop on this problem (test premise)"
        assert drop16 == 0, "K=16 must keep every obs (12-camera tracks)"
        e16 = cam_err(cam16)
        e8 = cam_err(cam8)
        # the no-drop grid matches the flat engine's accuracy class
        assert e16 < max(1.3 * e_flat, 0.01), (e16, e_flat)
        # and never loses to the dropping grid
        assert e16 <= e8 * 1.05 + 1e-4, (e16, e8)


class TestPackedGridUpload:
    """bundle_adjust_grid_packed (i16/u8 upload, device-side unpack) must
    match bundle_adjust_grid on the same problem: identical math, half
    the host->device bytes, <=1/32 px quantization on (u, v, u_r)."""

    def test_packed_matches_unpacked(self):
        rng = np.random.default_rng(11)
        prob, T_true, pts = make_ba_problem(
            rng, n_cam=10, n_pnt=120, noise_px=0.3, pose_noise=0.03,
            pnt_noise=0.06)
        oc = np.asarray(prob.obs_cam)
        op = np.asarray(prob.obs_pnt)
        ouvr = np.asarray(prob.obs_uvr)
        cam_fixed = np.asarray(prob.cam_fixed)
        # per-observation octaves + the production per-octave table
        table = (1.0 / 1.44 ** np.arange(8)).astype(np.float32)
        oct_ = rng.integers(0, 8, len(oc)).astype(np.uint8)
        ois = table[oct_]
        order = np.lexsort((cam_fixed[oc], op))
        oc, op, ouvr, ois, oct_ = (a[order] for a in
                                   (oc, op, ouvr, ois, oct_))
        P = int(prob.pnt_pos.shape[0])
        K = 12

        g_cam, g_uvr, g_isig, g_act, slot, kept, nd = ba.grid_from_obs(
            oc, op, ouvr, ois, P, K=K)
        ref = ba.bundle_adjust_grid(ba.BAGridProblem(
            cam_Tcw=prob.cam_Tcw, cam_fixed=prob.cam_fixed,
            pnt_pos=prob.pnt_pos, pnt_active=prob.pnt_active,
            g_cam=jnp.asarray(g_cam), g_uvr=jnp.asarray(g_uvr),
            g_isig=jnp.asarray(g_isig), g_act=jnp.asarray(g_act),
            cam=prob.cam))

        p_cam, p_uvrq, p_oct, p_act, slot2, kept2, nd2 = \
            ba.grid_pack_from_obs(oc, op, ouvr, oct_, P, K=K)
        assert nd2 == nd and np.array_equal(kept2, kept)
        assert p_uvrq.dtype == np.int16 and p_cam.dtype == np.int16
        got = ba.bundle_adjust_grid_packed(
            prob.cam_Tcw, prob.cam_fixed, prob.pnt_pos, prob.pnt_active,
            jnp.asarray(p_cam), jnp.asarray(p_uvrq), jnp.asarray(p_oct),
            jnp.asarray(p_act), prob.cam, jnp.asarray(table))

        ref_T, got_T = np.asarray(ref.cam_Tcw), np.asarray(got.cam_Tcw)
        for i in range(len(ref_T)):
            Cr = -ref_T[i, :3, :3].T @ ref_T[i, :3, 3]
            Cg = -got_T[i, :3, :3].T @ got_T[i, :3, 3]
            assert np.linalg.norm(Cr - Cg) < 2e-3, (i, Cr, Cg)
        agree = (np.asarray(ref.g_inlier) == np.asarray(got.g_inlier))
        assert agree.mean() > 0.99
