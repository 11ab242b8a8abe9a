"""Unit tests for the batched LM pose optimizer (g2o-equivalent)."""

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.geometry import se3
from pyorbslam_jax.optim import pose_opt


def make_problem(rng, n=300, noise_px=0.3, outlier_frac=0.0, pose_err=0.2):
    fx = fy = 400.0
    cx, cy = 320.0, 120.0
    bf = 180.0
    cam = np.array([fx, fy, cx, cy, bf], np.float32)

    Xw = np.stack([
        rng.uniform(-10, 10, n), rng.uniform(-3, 3, n), rng.uniform(4, 40, n)
    ], axis=1).astype(np.float32)

    T_true = np.asarray(se3.exp_se3(jnp.asarray(
        np.concatenate([rng.normal(0, 0.05, 3), rng.normal(0, 0.5, 3)]).astype(np.float32)
    )))
    Pc = Xw @ T_true[:3, :3].T + T_true[:3, 3]
    u = fx * Pc[:, 0] / Pc[:, 2] + cx
    v = fy * Pc[:, 1] / Pc[:, 2] + cy
    ur = u - bf / Pc[:, 2]
    obs = np.stack([u, v, ur], axis=1).astype(np.float32)
    obs += rng.normal(0, noise_px, obs.shape).astype(np.float32)

    n_out = int(outlier_frac * n)
    if n_out:
        idx = rng.choice(n, n_out, replace=False)
        obs[idx, :2] += rng.uniform(20, 80, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
        obs[idx, 2] = obs[idx, 0] - rng.uniform(1, 50, n_out)

    xi0 = np.concatenate([
        rng.normal(0, pose_err * 0.1, 3), rng.normal(0, pose_err, 3)
    ]).astype(np.float32)
    T0 = np.asarray(se3.exp_se3(jnp.asarray(xi0))) @ T_true

    active = np.ones(n, bool)
    inv_sigma2 = np.ones(n, np.float32)
    return (jnp.asarray(T0), jnp.asarray(Xw), jnp.asarray(obs),
            jnp.asarray(inv_sigma2), jnp.asarray(active), jnp.asarray(cam),
            T_true)


def pose_error(T_est, T_true):
    d = np.asarray(T_est) @ np.linalg.inv(T_true)
    t_err = np.linalg.norm(d[:3, 3])
    r_err = np.arccos(np.clip((np.trace(d[:3, :3]) - 1) / 2, -1, 1))
    return t_err, r_err


class TestPoseOptimization:
    def test_clean_convergence(self):
        rng = np.random.default_rng(0)
        *problem, T_true = make_problem(rng, noise_px=0.0, pose_err=0.3)
        res = pose_opt.pose_optimization(*problem)
        t_err, r_err = pose_error(res.Tcw, T_true)
        assert t_err < 2e-3, t_err
        assert r_err < 1e-3, r_err  # f32 floor for this conditioning
        assert int(res.num_inliers) == 300

    def test_noisy_convergence(self):
        rng = np.random.default_rng(1)
        *problem, T_true = make_problem(rng, noise_px=0.5, pose_err=0.3)
        res = pose_opt.pose_optimization(*problem)
        t_err, r_err = pose_error(res.Tcw, T_true)
        assert t_err < 0.02, t_err
        assert r_err < 2e-3, r_err

    def test_outlier_rejection(self):
        rng = np.random.default_rng(2)
        *problem, T_true = make_problem(rng, noise_px=0.3, outlier_frac=0.3, pose_err=0.2)
        res = pose_opt.pose_optimization(*problem)
        t_err, r_err = pose_error(res.Tcw, T_true)
        assert t_err < 0.03, t_err
        # ~30% outliers must be flagged
        n_in = int(res.num_inliers)
        assert 180 < n_in <= 220, n_in

    def test_too_few_points_returns_initial(self):
        rng = np.random.default_rng(3)
        T0, Xw, obs, isig, active, cam, T_true = make_problem(rng)
        active = jnp.zeros_like(active).at[:2].set(True)
        res = pose_opt.pose_optimization(T0, Xw, obs, isig, active, cam)
        np.testing.assert_allclose(np.asarray(res.Tcw), np.asarray(T0))

    def test_jacobian_matches_autodiff(self):
        """Analytic stereo Jacobian vs jax.jacfwd of the retracted residual
        (the numeric-vs-analytic discipline of g2o's jacobians_sim3.cpp
        unit tests, without finite-difference noise)."""
        rng = np.random.default_rng(4)
        _, Xw, obs, _, _, cam, T_true = make_problem(rng, n=20)
        T = jnp.asarray(T_true, jnp.float32)

        _, J = pose_opt.stereo_residual_jacobian(T, Xw, obs, cam)

        def res_of_xi(xi):
            e, _ = pose_opt.stereo_residual_jacobian(
                se3.retract(T, xi), Xw, obs, cam)
            return e

        J_auto = jax.jacfwd(res_of_xi)(jnp.zeros(6, jnp.float32))  # (N, 3, 6)
        np.testing.assert_allclose(
            np.asarray(J), np.asarray(J_auto), atol=5e-3, rtol=1e-4
        )
