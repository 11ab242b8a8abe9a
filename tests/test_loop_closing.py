"""Full-circle loop closure integration (the reference's KITTI-00-style
gate, SURVEY.md §7 step 7, on the synthetic loop world)."""

import numpy as np
import pytest

from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_jax.io.synthetic import generate_sequence
from pyorbslam_jax.slam.system import System
from pyorbslam_jax.utils.metrics import ate_rmse


# full_loop_run fixture is shared session-wide (tests/conftest.py)


class TestLoopClosing:
    def test_loop_detected_and_closed(self, full_loop_run):
        sysm, _ = full_loop_run
        assert sysm.loop_closer is not None
        assert sysm.loop_closer.n_loops_closed >= 1

    def test_corrected_ate(self, full_loop_run):
        sysm, seq = full_loop_run
        corr = np.linalg.inv(sysm.corrected_trajectory())
        ate = ate_rmse(corr, seq.poses_wc)
        assert ate < 0.6, f"corrected ATE {ate:.3f} m over ~113 m circle"

    def test_loop_edges_recorded(self, full_loop_run):
        sysm, _ = full_loop_run
        edges = [(k, v) for k, v in sysm.map.loop_edges.items() if v]
        assert edges, "loop edges missing from the essential graph"

    def test_no_tracking_loss(self, full_loop_run):
        sysm, _ = full_loop_run
        weak = sum(1 for s in sysm.stats if s["inliers"] < 10)
        assert weak == 0


class TestCorrectionAcceptGate:
    def test_garbage_sim3_correction_is_rolled_back(self, full_loop_run):
        """Loop corrections must never make the map worse (observed once:
        one bad tail-end Sim3 doubled a well-conditioned run's ATE).
        Feed correct() a grossly wrong Scw: the reprojection-chi2 A/B
        must restore the snapshot geometry and count a rejection."""
        sysm, _ = full_loop_run
        lc = sysm.loop_closer
        ks = sysm.map.keyframes
        kf = ks.n - 1
        loop_kf = 0
        pre_Tcw = ks.Tcw[: ks.n].copy()
        pre_closed = lc.n_loops_closed
        pre_rejected = lc.n_loops_rejected

        # garbage Sim3: true pose of kf shifted 6 m sideways, 20 deg yaw
        bad = ks.Tcw[kf].copy()
        c, s = np.cos(0.35), np.sin(0.35)
        bad[:3, :3] = np.array(
            [[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32) @ bad[:3, :3]
        bad[0, 3] += 6.0
        Scw = (bad[:3, :3].copy(), bad[:3, 3].copy(), 1.0)

        lc.correct(kf, loop_kf, Scw, match_map={})

        assert lc.n_loops_rejected == pre_rejected + 1
        assert lc.n_loops_closed == pre_closed
        delta = np.abs(ks.Tcw[: ks.n] - pre_Tcw).max()
        assert delta < 1e-4, f"geometry not restored (max delta {delta})"
        assert any("accept_check" in e for e in lc.events)
