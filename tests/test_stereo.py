"""Stereo matcher accuracy against synthetic ground-truth depth."""

import jax.numpy as jnp
import numpy as np
import pytest

from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_jax.io.synthetic import generate_sequence, render_depth
from pyorbslam_jax.slam.frame import build_stereo_frame_jit, unproject


@pytest.fixture(scope="module")
def frame_and_gt(data_cache_dir):
    seq = generate_sequence(
        n_frames=2, width=512, height=160, trajectory="straight",
        seed=5, cache_dir=data_cache_dir,
    )
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=512, height=160, bf=seq.bf,
        ),
        orb=OrbConfig(n_features=1000),
    )
    frame = build_stereo_frame_jit(
        jnp.asarray(seq.left[0]), jnp.asarray(seq.right[0]), cfg
    )
    gt_depth = render_depth(seq.poses_wc[0], seq.K, 512, 160)
    return frame, gt_depth, cfg, seq


class TestStereoMatching:
    def test_depth_accuracy(self, frame_and_gt):
        frame, gt_depth, cfg, _ = frame_and_gt
        d = np.asarray(frame.depth)
        xy = np.asarray(frame.xy)
        have = d > 0
        assert have.sum() > 200, f"only {have.sum()} stereo matches"
        xi = np.clip(np.round(xy[have, 0]).astype(int), 0, 511)
        yi = np.clip(np.round(xy[have, 1]).astype(int), 0, 159)
        gt = gt_depth[yi, xi]
        ok = np.isfinite(gt)
        # gate in disparity space (scale-independent): sub-pixel SAD should
        # land well under half a pixel of the true disparity
        bf = cfg.camera.bf
        ddisp = np.abs(bf / d[have][ok] - bf / gt[ok])
        assert np.median(ddisp) < 0.35, f"median disparity err {np.median(ddisp)} px"
        assert (ddisp < 1.0).mean() > 0.9, f"1px-inlier rate {(ddisp < 1.0).mean()}"
        rel = np.abs(d[have][ok] - gt[ok]) / gt[ok]
        assert np.median(rel) < 0.05, f"median rel depth err {np.median(rel)}"

    def test_u_right_consistency(self, frame_and_gt):
        frame, _, cfg, _ = frame_and_gt
        d = np.asarray(frame.depth)
        ur = np.asarray(frame.u_right)
        xy = np.asarray(frame.xy)
        have = d > 0
        disp = xy[have, 0] - ur[have]
        np.testing.assert_allclose(cfg.camera.bf / disp, d[have], rtol=1e-4)
        assert (disp > 0).all()
        assert (disp <= cfg.camera.fx).all()

    def test_unproject_hits_scene_planes(self, frame_and_gt):
        frame, _, cfg, seq = frame_and_gt
        pts = np.asarray(unproject(frame, cfg, jnp.asarray(seq.poses_wc[0], jnp.float32)))
        have = np.asarray(frame.depth) > 0
        pts = pts[have]
        depth = np.asarray(frame.depth)[have]
        # corridor geometry: ground y=1.7, walls x=+-8, ceiling y=-6.
        # tolerance scales with range: a ~2% stereo depth error at 15 m
        # moves a point ~30 cm along the ray.
        tol = np.maximum(0.05 * depth, 0.15)
        on_ground = np.abs(pts[:, 1] - 1.7) < tol
        on_wall = np.abs(np.abs(pts[:, 0]) - 8.0) < tol
        on_ceiling = np.abs(pts[:, 1] + 6.0) < tol
        frac = (on_ground | on_wall | on_ceiling).mean()
        assert frac > 0.85, f"only {frac:.2%} of points on scene surfaces"
