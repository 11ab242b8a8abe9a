"""Horn Sim3 RANSAC, relative Sim3 optimization, and pose-graph tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyorbslam_jax.geometry import se3, sim3 as sim3_mod
from pyorbslam_jax.geometry.sim3 import Sim3
from pyorbslam_jax.optim.horn import horn_align, sim3_ransac
from pyorbslam_jax.optim.pose_graph import (
    optimize_pose_graph,
    optimize_pose_graph_cg,
)
from pyorbslam_jax.optim.sim3_opt import optimize_sim3


def rand_rot(rng, scale=1.0):
    w = rng.normal(0, scale, 3).astype(np.float32)
    return np.asarray(se3.exp_so3(jnp.asarray(w)))


class TestHorn:
    def test_exact_alignment(self):
        rng = np.random.default_rng(0)
        P = rng.normal(0, 3, (20, 3)).astype(np.float32)
        R_true = rand_rot(rng)
        t_true = rng.normal(0, 2, 3).astype(np.float32)
        Q = P @ R_true.T + t_true
        R, t, s = horn_align(jnp.asarray(P), jnp.asarray(Q))
        np.testing.assert_allclose(np.asarray(R), R_true, atol=1e-4)
        np.testing.assert_allclose(np.asarray(t), t_true, atol=1e-4)

    def test_with_scale(self):
        rng = np.random.default_rng(1)
        P = rng.normal(0, 3, (20, 3)).astype(np.float32)
        R_true = rand_rot(rng)
        Q = 1.7 * (P @ R_true.T) + np.array([1, 2, 3], np.float32)
        R, t, s = horn_align(jnp.asarray(P), jnp.asarray(Q), with_scale=True)
        assert abs(float(s) - 1.7) < 1e-3

    def test_ransac_with_outliers(self):
        rng = np.random.default_rng(2)
        n = 80
        fx = fy = 400.0
        cx, cy = 320.0, 120.0
        cam4 = jnp.asarray([fx, fy, cx, cy], jnp.float32)
        # points in camera-2 frame, visible (z > 2)
        X2 = np.stack([
            rng.uniform(-5, 5, n), rng.uniform(-2, 2, n), rng.uniform(4, 25, n)
        ], 1).astype(np.float32)
        R_true = rand_rot(rng, 0.3)
        t_true = rng.normal(0, 1.0, 3).astype(np.float32)
        X1 = X2 @ R_true.T + t_true
        # corrupt 30%
        X2n = X2.copy()
        bad = rng.choice(n, int(0.3 * n), replace=False)
        X2n[bad] += rng.normal(0, 3.0, (len(bad), 3))

        def project(P):
            return np.stack([
                fx * P[:, 0] / P[:, 2] + cx, fy * P[:, 1] / P[:, 2] + cy
            ], 1).astype(np.float32)

        uv1 = project(X1)
        uv2 = project(X2n)
        res = sim3_ransac(
            jnp.asarray(X1), jnp.asarray(X2n), jnp.asarray(uv1), jnp.asarray(uv2),
            jnp.ones(n, jnp.float32), jnp.ones(n, jnp.float32),
            jnp.ones(n, bool), cam4, jax.random.PRNGKey(0),
        )
        assert bool(res.ok)
        np.testing.assert_allclose(np.asarray(res.R), R_true, atol=5e-3)
        np.testing.assert_allclose(np.asarray(res.t), t_true, atol=2e-2)


class TestOptimizeSim3:
    def test_refines_noisy_estimate(self):
        rng = np.random.default_rng(3)
        n = 60
        fx = fy = 400.0
        cam4 = jnp.asarray([fx, fy, 320.0, 120.0], jnp.float32)
        X2 = np.stack([
            rng.uniform(-5, 5, n), rng.uniform(-2, 2, n), rng.uniform(4, 25, n)
        ], 1).astype(np.float32)
        R_true = rand_rot(rng, 0.2)
        t_true = rng.normal(0, 0.5, 3).astype(np.float32)
        X1 = X2 @ R_true.T + t_true

        def project(P):
            return np.stack([
                fx * P[:, 0] / P[:, 2] + 320.0, fy * P[:, 1] / P[:, 2] + 120.0
            ], 1).astype(np.float32)

        obs1 = project(X1) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)
        obs2 = project(X2) + rng.normal(0, 0.3, (n, 2)).astype(np.float32)

        # perturbed initial S12
        R0 = np.asarray(se3.exp_so3(jnp.asarray(
            np.asarray(se3.log_so3(jnp.asarray(R_true))) + rng.normal(0, 0.02, 3).astype(np.float32))))
        t0 = t_true + rng.normal(0, 0.1, 3).astype(np.float32)
        res = optimize_sim3(
            jnp.asarray(R0), jnp.asarray(t0), jnp.ones((), jnp.float32),
            jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(obs1), jnp.asarray(obs2),
            jnp.ones(n, jnp.float32), jnp.ones(n, jnp.float32),
            jnp.ones(n, bool), cam4, fix_scale=True,
        )
        assert int(res.n_inliers) > 50
        d = np.asarray(res.R) @ R_true.T
        ang = np.arccos(np.clip((np.trace(d) - 1) / 2, -1, 1))
        assert ang < 2e-3
        assert np.linalg.norm(np.asarray(res.t) - t_true) < 2e-2
        assert abs(float(res.s) - 1.0) < 1e-6  # scale frozen


class TestPoseGraph:
    def test_loop_correction_distributes_drift(self):
        """Chain of keyframes with accumulated drift + one loop edge to
        the start: the pose graph must spread the error and close the
        loop (the essential-graph role in LoopClosing)."""
        rng = np.random.default_rng(4)
        C = 20
        # ground truth: poses on a circle (Twc), stored as Siw = Tcw
        gt = []
        for i in range(C):
            ang = 2 * np.pi * i / C
            Rwc = np.asarray(se3.exp_so3(jnp.asarray(
                np.array([0, ang, 0], np.float32))))
            twc = np.array([10 * np.sin(ang), 0, 10 * (1 - np.cos(ang))], np.float32)
            Twc = np.eye(4, dtype=np.float32)
            Twc[:3, :3] = Rwc
            Twc[:3, 3] = twc
            gt.append(np.linalg.inv(Twc).astype(np.float32))
        gt = np.stack(gt)

        # drifted estimates: inject noise into each relative motion
        est = [gt[0]]
        for i in range(1, C):
            rel = gt[i] @ np.linalg.inv(gt[i - 1])
            xi = np.concatenate([
                rng.normal(0, 0.01, 3), rng.normal(0, 0.05, 3)
            ]).astype(np.float32)
            rel_noisy = np.asarray(se3.exp_se3(jnp.asarray(xi))) @ rel
            est.append((rel_noisy @ est[-1]).astype(np.float32))
        est = np.stack(est)

        # edges: consecutive (measured from noisy relatives = consistent
        # with est) + loop edge C-1 -> 0 measured from GROUND TRUTH
        e_i, e_j, mR, mt, ms = [], [], [], [], []
        for i in range(C - 1):
            Sji = est[i + 1] @ np.linalg.inv(est[i])
            e_i.append(i)
            e_j.append(i + 1)
            mR.append(Sji[:3, :3])
            mt.append(Sji[:3, 3])
            ms.append(1.0)
        loop = gt[0] @ np.linalg.inv(gt[C - 1])
        e_i.append(C - 1)
        e_j.append(0)
        mR.append(loop[:3, :3])
        mt.append(loop[:3, 3])
        ms.append(1.0)

        fixed = np.zeros(C, bool)
        fixed[0] = True
        res = optimize_pose_graph(
            jnp.asarray(est[:, :3, :3]), jnp.asarray(est[:, :3, 3]),
            jnp.ones(C, jnp.float32), jnp.asarray(fixed),
            jnp.asarray(np.array(e_i, np.int32)), jnp.asarray(np.array(e_j, np.int32)),
            jnp.asarray(np.stack(mR).astype(np.float32)),
            jnp.asarray(np.stack(mt).astype(np.float32)),
            jnp.asarray(np.array(ms, np.float32)),
            jnp.ones(len(e_i), bool),
        )
        # compare camera centers
        def centers(Rm, tm):
            return -np.einsum("cij,cj->ci", np.transpose(Rm, (0, 2, 1)), tm)

        err_before = np.linalg.norm(
            centers(est[:, :3, :3], est[:, :3, 3])
            - centers(gt[:, :3, :3], gt[:, :3, 3]), axis=1)
        err_after = np.linalg.norm(
            centers(np.asarray(res.R), np.asarray(res.t))
            - centers(gt[:, :3, :3], gt[:, :3, 3]), axis=1)
        assert err_after.mean() < 0.5 * err_before.mean(), (
            err_before.mean(), err_after.mean())
        # loop closure gap
        gap = np.linalg.norm(
            centers(np.asarray(res.R), np.asarray(res.t))[C - 1]
            - centers(gt[:, :3, :3], gt[:, :3, 3])[C - 1])
        assert gap < 0.25, gap


    def test_cg_matches_dense(self):
        """The matrix-free PCG solver and the dense normal-matrix solver
        are the same algorithm (same damping, same acceptance); on a
        well-conditioned graph they must land on the same poses."""
        rng = np.random.default_rng(9)
        C = 24
        gt, est = [], []
        for i in range(C):
            ang = 2 * np.pi * i / C
            Rwc = np.asarray(se3.exp_so3(jnp.asarray(
                np.array([0, ang, 0], np.float32))))
            Twc = np.eye(4, dtype=np.float32)
            Twc[:3, :3] = Rwc
            Twc[:3, 3] = [8 * np.sin(ang), 0, 8 * (1 - np.cos(ang))]
            gt.append(np.linalg.inv(Twc).astype(np.float32))
        est = [gt[0]]
        for i in range(1, C):
            rel = gt[i] @ np.linalg.inv(gt[i - 1])
            xi = np.concatenate([
                rng.normal(0, 0.008, 3), rng.normal(0, 0.04, 3)
            ]).astype(np.float32)
            est.append((np.asarray(se3.exp_se3(jnp.asarray(xi))) @ rel
                        @ est[-1]).astype(np.float32))
        gt, est = np.stack(gt), np.stack(est)

        e_i, e_j, mR, mt = [], [], [], []
        for i in range(C - 1):
            Sji = est[i + 1] @ np.linalg.inv(est[i])
            e_i.append(i); e_j.append(i + 1)
            mR.append(Sji[:3, :3]); mt.append(Sji[:3, 3])
        loop = gt[0] @ np.linalg.inv(gt[C - 1])
        e_i.append(C - 1); e_j.append(0)
        mR.append(loop[:3, :3]); mt.append(loop[:3, 3])

        fixed = np.zeros(C, bool); fixed[0] = True
        args = (
            jnp.asarray(est[:, :3, :3]), jnp.asarray(est[:, :3, 3]),
            jnp.ones(C, jnp.float32), jnp.asarray(fixed),
            jnp.asarray(np.array(e_i, np.int32)),
            jnp.asarray(np.array(e_j, np.int32)),
            jnp.asarray(np.stack(mR).astype(np.float32)),
            jnp.asarray(np.stack(mt).astype(np.float32)),
            jnp.ones(len(e_i), jnp.float32),
            jnp.ones(len(e_i), bool),
        )
        dense = optimize_pose_graph(*args)
        cg = optimize_pose_graph_cg(*args, cg_iters=160)

        def centers(Rm, tm):
            return -np.einsum("cij,cj->ci", np.transpose(Rm, (0, 2, 1)), tm)

        c_d = centers(np.asarray(dense.R), np.asarray(dense.t))
        c_c = centers(np.asarray(cg.R), np.asarray(cg.t))
        d = np.linalg.norm(c_d - c_c, axis=1)
        assert d.max() < 2e-2, d.max()
        # and both actually closed the loop
        c_gt = centers(gt[:, :3, :3], gt[:, :3, 3])
        assert np.linalg.norm(c_c[C - 1] - c_gt[C - 1]) < 0.25
