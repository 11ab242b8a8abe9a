import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyorbslam_jax.geometry import se3, sim3

jax.config.update("jax_enable_x64", False)


def random_se3(rng, n=None, max_angle=1.5):
    shape = () if n is None else (n,)
    w = rng.normal(size=shape + (3,))
    w = w / np.linalg.norm(w, axis=-1, keepdims=True) * rng.uniform(0, max_angle, shape + (1,))[..., 0][..., None]
    t = rng.normal(size=shape + (3,))
    return np.concatenate([w, t], axis=-1).astype(np.float32)


class TestSE3:
    def test_exp_log_roundtrip(self):
        rng = np.random.default_rng(0)
        xi = random_se3(rng, 64)
        T = se3.exp_se3(jnp.asarray(xi))
        xi2 = se3.log_se3(T)
        np.testing.assert_allclose(np.asarray(xi2), xi, atol=2e-3)

    def test_exp_zero_is_identity(self):
        T = se3.exp_se3(jnp.zeros(6))
        np.testing.assert_allclose(np.asarray(T), np.eye(4), atol=1e-6)

    def test_small_angle_stable(self):
        xi = jnp.array([1e-9, -1e-9, 1e-10, 0.5, -0.2, 0.1], jnp.float32)
        T = se3.exp_se3(xi)
        assert np.isfinite(np.asarray(T)).all()
        np.testing.assert_allclose(np.asarray(T)[:3, 3], [0.5, -0.2, 0.1], atol=1e-5)

    def test_inverse(self):
        rng = np.random.default_rng(1)
        T = se3.exp_se3(jnp.asarray(random_se3(rng, 8)))
        I = T @ se3.inverse(T)
        np.testing.assert_allclose(
            np.asarray(I), np.tile(np.eye(4), (8, 1, 1)), atol=1e-5
        )

    def test_transform_matches_matmul(self):
        rng = np.random.default_rng(2)
        T = se3.exp_se3(jnp.asarray(random_se3(rng)))
        pts = jnp.asarray(rng.normal(size=(10, 3)).astype(np.float32))
        got = se3.transform(T, pts)
        h = jnp.concatenate([pts, jnp.ones((10, 1))], axis=1)
        want = (np.asarray(T) @ np.asarray(h).T).T[:, :3]
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-5)

    def test_camera_center(self):
        rng = np.random.default_rng(3)
        Tcw = se3.exp_se3(jnp.asarray(random_se3(rng)))
        Ow = se3.camera_center(Tcw)
        # transforming the center into camera coords must give 0
        z = se3.transform(Tcw, Ow)
        np.testing.assert_allclose(np.asarray(z), np.zeros(3), atol=1e-5)

    def test_orthonormalize(self):
        R = jnp.eye(3) + 0.01 * jnp.asarray(np.random.default_rng(4).normal(size=(3, 3)).astype(np.float32))
        Rn = se3.orthonormalize(R)
        np.testing.assert_allclose(np.asarray(Rn @ Rn.T), np.eye(3), atol=1e-5)
        assert abs(float(jnp.linalg.det(Rn)) - 1.0) < 1e-5


class TestSim3:
    def test_exp_log_roundtrip(self):
        rng = np.random.default_rng(5)
        xi = np.concatenate(
            [random_se3(rng, 32), rng.uniform(-0.4, 0.4, (32, 1)).astype(np.float32)],
            axis=-1,
        )
        g = sim3.exp(jnp.asarray(xi))
        xi2 = sim3.log(g)
        np.testing.assert_allclose(np.asarray(xi2), xi, atol=5e-4)

    def test_compose_inverse(self):
        rng = np.random.default_rng(6)
        xi = np.concatenate(
            [random_se3(rng, 8), rng.uniform(-0.3, 0.3, (8, 1)).astype(np.float32)],
            axis=-1,
        )
        g = sim3.exp(jnp.asarray(xi))
        gi = sim3.inverse(g)
        e = sim3.compose(g, gi)
        np.testing.assert_allclose(np.asarray(e.s), np.ones(8), atol=1e-5)
        np.testing.assert_allclose(np.asarray(e.t), np.zeros((8, 3)), atol=1e-4)

    def test_act_matches_matrix(self):
        rng = np.random.default_rng(7)
        xi = jnp.asarray(
            np.concatenate([random_se3(rng), [0.3]]).astype(np.float32)
        )
        g = sim3.exp(xi)
        pts = jnp.asarray(rng.normal(size=(5, 3)).astype(np.float32))
        got = sim3.act(g, pts)
        M = np.asarray(sim3.to_matrix(g))
        h = np.concatenate([np.asarray(pts), np.ones((5, 1), np.float32)], axis=1)
        want = (M @ h.T).T[:, :3]
        np.testing.assert_allclose(np.asarray(got), want, atol=1e-4)

    def test_se3_embedding(self):
        rng = np.random.default_rng(8)
        T = se3.exp_se3(jnp.asarray(random_se3(rng)))
        g = sim3.Sim3.from_se3(T)
        pts = jnp.asarray(rng.normal(size=(4, 3)).astype(np.float32))
        np.testing.assert_allclose(
            np.asarray(sim3.act(g, pts)), np.asarray(se3.transform(T, pts)), atol=1e-5
        )


class TestMetrics:
    def test_ate_zero_for_identical(self):
        from pyorbslam_jax.utils.metrics import ate_rmse

        rng = np.random.default_rng(9)
        poses = np.tile(np.eye(4), (20, 1, 1))
        poses[:, :3, 3] = rng.normal(size=(20, 3))
        assert ate_rmse(poses, poses) < 1e-9

    def test_ate_invariant_to_rigid_motion(self):
        from pyorbslam_jax.utils.metrics import ate_rmse
        from scipy.spatial.transform import Rotation

        rng = np.random.default_rng(10)
        poses = np.tile(np.eye(4), (20, 1, 1))
        poses[:, :3, 3] = np.cumsum(rng.normal(size=(20, 3)), axis=0)
        R = Rotation.random(random_state=1).as_matrix()
        moved = poses.copy()
        moved[:, :3, :3] = R @ poses[:, :3, :3]
        moved[:, :3, 3] = poses[:, :3, 3] @ R.T + np.array([5.0, -2.0, 3.0])
        assert ate_rmse(moved, poses) < 1e-9


class TestConfig:
    def test_features_per_level_sums_to_total(self):
        from pyorbslam_jax.config import OrbConfig

        orb = OrbConfig(n_features=2000, scale_factor=1.2, n_levels=8)
        per = orb.features_per_level
        assert per.sum() == 2000
        # geometric decay: finest level has the most features
        assert per[0] == max(per)

    def test_yaml_parity(self, tmp_path):
        from pyorbslam_jax.config import SlamConfig

        yaml_text = """%YAML:1.0
Camera.fx: 718.856
Camera.fy: 718.856
Camera.cx: 607.1928
Camera.cy: 185.2157
Camera.k1: 0.0
Camera.bf: 386.1448
Camera.fps: 10.0
Camera.RGB: 1
ThDepth: 35
ORBextractor.nFeatures: 2000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
"""
        p = tmp_path / "settings.yaml"
        p.write_text(yaml_text)
        cfg = SlamConfig.from_yaml(str(p))
        assert cfg.camera.fx == 718.856
        assert cfg.camera.th_depth == 35
        assert cfg.orb.ini_th_fast == 20
        np.testing.assert_allclose(
            cfg.camera.depth_threshold, 386.1448 * 35 / 718.856, rtol=1e-6
        )


class TestKittiIO:
    def test_trajectory_roundtrip(self, tmp_path):
        from pyorbslam_jax.io.kitti import load_trajectory_kitti, save_trajectory_kitti
        from scipy.spatial.transform import Rotation

        rng = np.random.default_rng(11)
        n = 7
        Twc = np.tile(np.eye(4), (n, 1, 1))
        for i in range(n):
            Twc[i, :3, :3] = Rotation.random(random_state=i).as_matrix()
            Twc[i, :3, 3] = rng.normal(size=3)
        Tcw = np.linalg.inv(Twc)
        path = tmp_path / "traj.txt"
        save_trajectory_kitti(str(path), Tcw)
        back = load_trajectory_kitti(str(path))
        np.testing.assert_allclose(back, Twc, atol=1e-6)
