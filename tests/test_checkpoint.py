"""Map checkpoint save/load roundtrip + tracking resume."""

import numpy as np

from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_jax.io.synthetic import generate_sequence
from pyorbslam_jax.slam.system import System
from pyorbslam_jax.utils.checkpoint import load_map, save_map


class TestCheckpoint:
    def test_roundtrip_and_resume(self, data_cache_dir, tmp_path):
        seq = generate_sequence(
            n_frames=20, width=512, height=160, trajectory="straight",
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
        for i in range(12):
            sysm.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])

        path = str(tmp_path / "map.npz")
        save_map(sysm.map, path)
        m2 = load_map(cfg, path)

        assert m2.keyframes.n == sysm.map.keyframes.n
        assert m2.landmarks.n == sysm.map.landmarks.n
        np.testing.assert_array_equal(
            m2.keyframes.Tcw[: m2.keyframes.n],
            sysm.map.keyframes.Tcw[: sysm.map.keyframes.n],
        )
        np.testing.assert_array_equal(
            m2.landmarks.pos[: m2.landmarks.n],
            sysm.map.landmarks.pos[: sysm.map.landmarks.n],
        )
        np.testing.assert_array_equal(
            m2.keyframes.obs_lm[: m2.keyframes.n],
            sysm.map.keyframes.obs_lm[: sysm.map.keyframes.n],
        )
        # rebuilt covisibility must be a FRESH recount of the restored
        # observation table (live maps carry stale weights: the reference
        # also recounts only on update_connections)
        obs = m2.keyframes.obs_lm[: m2.keyframes.n]
        a2, b2, w2 = m2.core.covis_edges()
        got = {(a, b): w for a, b, w in zip(a2.tolist(), b2.tolist(),
                                           w2.tolist())}
        from collections import Counter
        for (a, b), w in list(got.items())[:50]:
            ca = Counter(obs[a][obs[a] >= 0].tolist())
            cb = Counter(obs[b][obs[b] >= 0].tolist())
            expect = sum(ca[k] * cb[k] for k in ca.keys() & cb.keys())
            assert w == expect, (a, b, w, expect)
        assert m2.parent == sysm.map.parent

        # resume: swap the reloaded map in and keep tracking
        sysm.map = m2
        if sysm.local_mapper is not None:
            sysm.local_mapper.map = m2
        if sysm.loop_closer is not None:
            sysm.loop_closer.map = m2
        for i in range(12, 20):
            sysm.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
        assert sysm.state in ("OK", "MARGINAL")
        assert sysm.stats[-1]["inliers"] > 30
