"""Relocalization integration: recover after kidnapping."""

import numpy as np
import pytest

from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_jax.io.synthetic import generate_sequence
from pyorbslam_jax.slam.system import System


class TestRelocalization:
    def test_kidnap_recovery(self, data_cache_dir):
        seq = generate_sequence(
            n_frames=30, width=512, height=160, trajectory="straight",
            speed=0.8, seed=3, cache_dir=data_cache_dir,
        )
        cfg = SlamConfig(
            camera=CameraConfig(
                fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
                cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
                width=512, height=160, bf=seq.bf, th_depth=40.0,
            ),
            orb=OrbConfig(n_features=1000),
        )
        sysm = System(cfg)
        for i in range(16):
            sysm.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
        assert sysm.state == "OK"
        assert sysm.map.keyframes.n >= 2

        # kidnap: two frames of pure noise destroy tracking
        rng = np.random.default_rng(0)
        noise = rng.uniform(0, 255, seq.left[0].shape).astype(np.float32)
        for _ in range(2):
            sysm.track_stereo(noise, noise, 0.0)

        # return to a previously-mapped view: frame 5
        Tcw = sysm.track_stereo(seq.left[5], seq.right[5], 99.0)
        gt = np.linalg.inv(seq.poses_wc[5])
        err = np.linalg.norm(Tcw[:3, 3] - gt[:3, 3])
        assert sysm.state == "OK", sysm.state
        assert err < 0.5, f"reloc pose error {err:.3f} m"
