"""Distributed Schur BA on the 8-device virtual CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyorbslam_jax.optim import ba
from pyorbslam_jax.parallel import dist_ba
from tests.test_ba import make_ba_problem


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return dist_ba.make_mesh(8)


def shardable_problem(rng, n_shards=8):
    prob, T_true, pts = make_ba_problem(rng, n_cam=8, n_pnt=512 - 8, noise_px=0.3,
                                        pad_pnt=8)  # pad points to 512
    n_pnt = prob.pnt_pos.shape[0]
    assert n_pnt % n_shards == 0
    obs_pnt = np.asarray(prob.obs_pnt)
    arrays = (
        np.asarray(prob.obs_cam), np.asarray(prob.obs_uvr),
        np.asarray(prob.obs_inv_sigma2),
    )
    new_pnt, (oc, ouvr, oisig), active = (
        dist_ba.group_observations_by_point_shard(obs_pnt, n_pnt, n_shards, arrays)
    )
    prob2 = prob._replace(
        obs_pnt=jnp.asarray(new_pnt),
        obs_cam=jnp.asarray(oc),
        obs_uvr=jnp.asarray(ouvr),
        obs_inv_sigma2=jnp.asarray(oisig),
        obs_active=jnp.asarray(active),
    )
    return prob2, T_true, pts


class TestDistributedBA:
    def test_matches_single_device_quality(self, mesh):
        rng = np.random.default_rng(0)
        prob, T_true, pts = shardable_problem(rng)
        sharded = dist_ba.shard_problem(prob, mesh)
        cam_out, pnt_out, inlier = dist_ba.distributed_bundle_adjust(
            sharded, mesh, n_cam=prob.cam_Tcw.shape[0]
        )
        cam_err = np.linalg.norm(
            np.asarray(cam_out)[:8, :3, 3] - T_true[:, :3, 3], axis=1
        )
        assert cam_err.max() < 0.06, cam_err

        # single-device result for comparison
        res = ba.bundle_adjust(prob)
        cam_err_1dev = np.linalg.norm(
            np.asarray(res.cam_Tcw)[:8, :3, 3] - T_true[:, :3, 3], axis=1
        )
        assert cam_err.mean() < 2.0 * cam_err_1dev.mean() + 1e-3

    def test_point_updates_happen_on_shards(self, mesh):
        rng = np.random.default_rng(1)
        prob, T_true, pts = shardable_problem(rng)
        sharded = dist_ba.shard_problem(prob, mesh)
        _, pnt_out, _ = dist_ba.distributed_bundle_adjust(
            sharded, mesh, n_cam=prob.cam_Tcw.shape[0]
        )
        n_pnt = len(pts)
        moved = np.linalg.norm(
            np.asarray(pnt_out)[:n_pnt] - np.asarray(prob.pnt_pos)[:n_pnt], axis=1
        )
        assert (moved > 1e-6).mean() > 0.9  # points actually optimized
        err = np.linalg.norm(np.asarray(pnt_out)[:n_pnt] - pts, axis=1)
        assert np.median(err) < 0.1


class TestDistributedBACG:
    def test_large_camera_count_no_truncation(self, mesh):
        """The implicit-Schur distributed CG engine must carry a problem
        LARGER than the dense engine's 256-camera cap with every camera
        free, finite, and improved — the KITTI-00-scale regression guard
        for the engine ladder (SlamMap._run_ba engine='dist')."""
        rng = np.random.default_rng(7)
        n_cam, n_shards = 300, 8
        # small pose noise: BA always starts near the tracked solution;
        # large left-multiplied rotation noise would put far-chain
        # cameras metres off (rotation x lever arm), which no local
        # bundle adjustment is meant to recover from
        # cameras march +x (Tcw translation is -0.8i, so centers are at
        # +0.8i); the point field must span the whole track
        prob, T_true, pts = make_ba_problem(
            rng, n_cam=n_cam, n_pnt=3072 - 8, noise_px=0.3,
            pose_noise=0.004, pnt_noise=0.05, pad_pnt=8,
            pnt_span=(-12.0, 250.0),
        )
        n_pnt = prob.pnt_pos.shape[0]
        assert n_pnt % n_shards == 0
        arrays = (
            np.asarray(prob.obs_cam), np.asarray(prob.obs_uvr),
            np.asarray(prob.obs_inv_sigma2),
        )
        new_pnt, (oc, ouvr, oisig), active = (
            dist_ba.group_observations_by_point_shard(
                np.asarray(prob.obs_pnt), n_pnt, n_shards, arrays)
        )
        prob = prob._replace(
            obs_pnt=jnp.asarray(new_pnt), obs_cam=jnp.asarray(oc),
            obs_uvr=jnp.asarray(ouvr), obs_inv_sigma2=jnp.asarray(oisig),
            obs_active=jnp.asarray(active),
        )

        from pyorbslam_jax.optim import ba_cg

        sharded = dist_ba.shard_problem(prob, mesh)
        cam_out, pnt_out, _ = dist_ba.distributed_bundle_adjust_cg(
            sharded, mesh, n_cam=prob.cam_Tcw.shape[0],
            iters1=3, iters2=5, cg_iters=64,
        )
        cam_out = np.asarray(cam_out)
        assert np.isfinite(cam_out).all()
        # cameras past the dense engine's 256 cap are NOT frozen: they
        # moved off their (noisy) initialization
        moved = np.linalg.norm(
            cam_out[256:n_cam, :3, 3]
            - np.asarray(prob.cam_Tcw)[256:n_cam, :3, 3], axis=1)
        assert (moved > 1e-6).all(), moved.min()
        # and the sharded solve reaches the single-device CG engine's
        # solution QUALITY on the same untruncated problem (exact f32
        # trajectory equality is not guaranteed at 54k observations —
        # psum reduction order differs — the small-problem test above
        # pins numerical equivalence)
        ref = ba_cg.bundle_adjust_cg(prob, iters1=3, iters2=5, cg_iters=64)
        ref_err = np.linalg.norm(
            np.asarray(ref.cam_Tcw)[:n_cam, :3, 3] - T_true[:, :3, 3],
            axis=1)
        err = np.linalg.norm(
            cam_out[:n_cam, :3, 3] - T_true[:, :3, 3], axis=1)
        assert np.median(err) < 1.5 * np.median(ref_err) + 1e-3, (
            np.median(err), np.median(ref_err))
        assert np.median(err) < 0.08, np.median(err)

    def test_matches_single_device_cg(self, mesh):
        """psum of per-shard segment sums == the global segment sum: the
        sharded CG engine must numerically track the single-device one."""
        from pyorbslam_jax.optim import ba_cg

        rng = np.random.default_rng(3)
        prob, T_true, pts = shardable_problem(rng)
        ref = ba_cg.bundle_adjust_cg(prob, iters1=3, iters2=5, cg_iters=48)
        sharded = dist_ba.shard_problem(prob, mesh)
        cam_out, pnt_out, _ = dist_ba.distributed_bundle_adjust_cg(
            sharded, mesh, n_cam=prob.cam_Tcw.shape[0],
            iters1=3, iters2=5, cg_iters=48,
        )
        np.testing.assert_allclose(
            np.asarray(cam_out)[:, :3, 3],
            np.asarray(ref.cam_Tcw)[:, :3, 3], atol=2e-3)


class TestDistributedPoseGraph:
    def test_matches_single_device_cg(self, mesh):
        """Sharded pose graph == single-device CG solver (the psum of
        per-shard segment sums is the global segment sum)."""
        from pyorbslam_jax.geometry import se3
        from pyorbslam_jax.optim.pose_graph import optimize_pose_graph_cg
        from pyorbslam_jax.parallel import dist_pose_graph

        rng = np.random.default_rng(5)
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
        e_i = np.array(e_i, np.int32); e_j = np.array(e_j, np.int32)
        mR = np.stack(mR).astype(np.float32)
        mt = np.stack(mt).astype(np.float32)
        ms = np.ones(len(e_i), np.float32)
        act = np.ones(len(e_i), bool)

        ref = optimize_pose_graph_cg(
            jnp.asarray(est[:, :3, :3]), jnp.asarray(est[:, :3, 3]),
            jnp.ones(C, jnp.float32), jnp.asarray(fixed),
            jnp.asarray(e_i), jnp.asarray(e_j), jnp.asarray(mR),
            jnp.asarray(mt), jnp.asarray(ms), jnp.asarray(act),
            cg_iters=128,
        )

        pe_i, pe_j, pmR, pmt, pms, pact = dist_pose_graph.pad_edges(
            8, e_i, e_j, mR, mt, ms, act)
        (reps, shds) = dist_pose_graph.place_pose_graph(
            mesh,
            [est[:, :3, :3], est[:, :3, 3],
             np.ones(C, np.float32), fixed],
            [pe_i, pe_j, pmR, pmt, pms, pact])
        res = dist_pose_graph.distributed_pose_graph(
            mesh, *reps, *shds, cg_iters=128)

        np.testing.assert_allclose(
            np.asarray(res.t), np.asarray(ref.t), atol=5e-3)
        np.testing.assert_allclose(
            np.asarray(res.R), np.asarray(ref.R), atol=5e-3)

        def centers(Rm, tm):
            return -np.einsum("cij,cj->ci", np.transpose(Rm, (0, 2, 1)), tm)

        c_gt = centers(gt[:, :3, :3], gt[:, :3, 3])
        c_d = centers(np.asarray(res.R), np.asarray(res.t))
        assert np.linalg.norm(c_d[C - 1] - c_gt[C - 1]) < 0.25
