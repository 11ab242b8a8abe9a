"""End-to-end tracking integration test — the first accuracy gate
(SURVEY.md §7 step 4: trajectory + ATE on the tracking-only slice)."""

import numpy as np
import pytest

from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_jax.slam.tracking import Tracker
from pyorbslam_jax.utils.metrics import ate_rmse, rpe


@pytest.fixture(scope="module")
def vo_run(synth_seq):
    seq = synth_seq
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=seq.left.shape[2], height=seq.left.shape[1],
            bf=seq.bf, th_depth=40.0,
        ),
        orb=OrbConfig(n_features=1000),
    )
    tracker = Tracker(cfg)
    for i in range(len(seq.left)):
        tracker.track(seq.left[i], seq.right[i], seq.timestamps[i])
    est_wc = np.linalg.inv(np.stack(tracker.trajectory))
    return tracker, est_wc, seq


class TestTrackingVO:
    # Gates calibrated for VO-ONLY (no bundle adjustment, no loop
    # closure) on the auto-widened corridor: the curving path keeps the
    # walls 15-25 m away, so stereo geometry is KITTI-like rather than
    # the old 8 m corridor (which the trajectory actually exited —
    # the camera spent half the run outside a wall).  The full System
    # with per-keyframe BA holds ~0.02 m ATE on the same world
    # (tests/test_system.py); VO alone is the drift-bounded slice.
    #
    # Calibration (measured on the v6 world, 2026-08-21): ATE 0.845 m,
    # drift 1.79%, RPE-t 0.214 m, RPE-r 0.0115 rad, 0 weak frames,
    # median inliers 125.  Gates below are ~1.2-1.5x those values.
    def test_ate_gate(self, vo_run):
        tracker, est_wc, seq = vo_run
        track_len = np.linalg.norm(
            np.diff(seq.poses_wc[:, :3, 3], axis=0), axis=1
        ).sum()
        ate = ate_rmse(est_wc, seq.poses_wc)
        assert ate < 1.2, f"ATE {ate:.3f} m over {track_len:.1f} m"
        assert ate / track_len < 0.025, f"drift {ate / track_len:.2%}"

    def test_rpe_gate(self, vo_run):
        _, est_wc, seq = vo_run
        t_rmse, r_rmse = rpe(est_wc, seq.poses_wc)
        assert t_rmse < 0.25, f"RPE-t {t_rmse:.3f} m/frame"
        assert r_rmse < 0.017, f"RPE-r {r_rmse:.4f} rad/frame"

    def test_tracking_never_lost(self, vo_run):
        tracker, _, _ = vo_run
        weak = sum(1 for s in tracker.stats if s["inliers"] < 20)
        assert weak <= 3, f"{weak} weak/lost frames"
        med_inliers = np.median([s["inliers"] for s in tracker.stats])
        assert med_inliers > 60, f"median inliers {med_inliers}"

    def test_landmark_bookkeeping(self, vo_run):
        tracker, _, _ = vo_run
        lm = tracker.landmarks
        assert lm.n > 500
        assert lm.alive[:lm.n].all()
        # scale-invariance bands are sane
        assert (lm.dmin[:lm.n] < lm.dmax[:lm.n]).all()
        assert np.isfinite(lm.pos[:lm.n]).all()
