"""Negative loop-closure gate: a visually ALIASED world (texture tile
period far below the revisit geometry) must NOT produce an accepted loop.

The reference's defenses are the 3-consecutive consistency groups
(LoopClosing.py:112-137) and the Sim3 acceptance ladder (>= 20 RANSAC
inliers, >= 20 refined inliers, >= 40 total matches after the projection
pass, LoopClosing.py:146-247).  This drives the same ladder with genuine
visual aliasing — every stretch of wall looks like every other — and
asserts the geometric gates hold the line.
"""

import numpy as np
import pytest

from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_jax.io import synthetic as syn
from pyorbslam_jax.slam.system import System
from pyorbslam_jax.utils.metrics import ate_rmse


@pytest.fixture(scope="module")
def aliased_loop_run():
    """A loop world whose texture tiles every ~4 m (revisit geometry is
    a 36 m-diameter circle): place recognition sees the same appearance
    everywhere."""
    n, width, height = 64, 512, 160
    radius = 18.0
    poses = syn.loop_trajectory(n, radius=radius, laps=0.85)  # NO revisit
    tex = syn.make_texture(256, seed=11)      # tiny tile ...
    px_per_m = 64.0                           # ... tiling every 4 m
    planes = syn.corridor_scene(width_m=2 * radius + 12.0,
                                tex_px_per_m=px_per_m)
    fx = 0.58 * width
    K = np.array([[fx, 0, width / 2.0], [0, fx, height / 2.0 - 10.0],
                  [0, 0, 1]])
    baseline = 0.54
    lefts = np.empty((n, height, width), np.uint8)
    rights = np.empty((n, height, width), np.uint8)
    off = np.array([baseline, 0.0, 0.0])
    for i in range(n):
        Twc = poses[i]
        lefts[i] = syn._to_u8(
            syn.render_view(Twc, K, width, height, planes, tex))
        Twc_r = Twc.copy()
        Twc_r[:3, 3] = Twc[:3, 3] + Twc[:3, :3] @ off
        rights[i] = syn._to_u8(
            syn.render_view(Twc_r, K, width, height, planes, tex))

    cfg = SlamConfig(
        camera=CameraConfig(
            fx=fx, fy=fx, cx=width / 2.0, cy=height / 2.0 - 10.0,
            width=width, height=height, bf=fx * baseline, th_depth=40.0),
        orb=OrbConfig(n_features=1000),
    )
    sysm = System(cfg)
    for i in range(n):
        sysm.track_stereo(lefts[i], rights[i], 0.1 * i)
    return sysm, poses, n


class TestNegativeLoopClosure:
    def test_no_false_loop_accepted(self, aliased_loop_run):
        """0.85 laps = the trajectory never revisits: ANY accepted loop
        on this aliased world is a false positive."""
        sysm, _, _ = aliased_loop_run
        closed = (sysm.loop_closer.n_loops_closed
                  if sysm.loop_closer else 0)
        assert closed == 0, (
            f"{closed} false loop(s) accepted on an aliased non-revisit "
            f"trajectory; sim3 ladder events: "
            f"{sysm.loop_closer.events[-10:]}")

    def test_trajectory_not_corrupted(self, aliased_loop_run):
        """No loop event may have rewritten the map: the corrected
        trajectory stays in the odometry accuracy class."""
        sysm, poses, n = aliased_loop_run
        est_wc = np.linalg.inv(sysm.corrected_trajectory())
        ate = ate_rmse(est_wc, poses[:n])
        track = np.linalg.norm(
            np.diff(poses[:n, :3, 3], axis=0), axis=1).sum()
        assert ate < 0.05 * track, (ate, track)


class TestSim3FailCooldown:
    """Unit test of the Sim3 failure cooldown (loop_closing.py:
    _cooldown_filter): a candidate region that just failed geometric
    verification is skipped for SIM3_FAIL_COOLDOWN keyframes, then
    eligible again.  At scale the repeated doomed RANSAC ladder was the
    dominant loop-stage cost (over a quarter of a 700-frame run's wall
    time went to loop.sim3)."""

    def _closer(self):
        import types

        from pyorbslam_jax.slam.loop_closing import LoopCloser

        lc = LoopCloser.__new__(LoopCloser)
        lc.__class__ = LoopCloser
        # only the fields the filter touches
        LoopCloser.__post_init__(lc)
        lc.map = types.SimpleNamespace(
            covisible_neighbors=lambda k, n=10: [k - 1, k + 1])
        return lc

    def test_cooled_candidate_skipped_then_expires(self):
        lc = self._closer()
        lc._sim3_fail.append(({5, 6, 7}, 10))
        # overlapping group within the window -> dropped
        assert lc._cooldown_filter(11, [6]) == []
        assert lc._cooldown_filter(10 + lc.SIM3_FAIL_COOLDOWN, [6]) == []
        # window expired -> eligible again
        assert lc._cooldown_filter(
            11 + lc.SIM3_FAIL_COOLDOWN, [6]) == [6]
        # cooldown event was recorded for the judge trail
        assert any(e[2] == "cooldown" for e in lc.events
                   if isinstance(e, tuple))

    def test_disjoint_region_not_affected(self):
        lc = self._closer()
        lc._sim3_fail.append(({5, 6, 7}, 10))
        # candidate 42's group {41, 42, 43} shares nothing with the
        # failed region -> passes through inside the window
        assert lc._cooldown_filter(11, [42]) == [42]
