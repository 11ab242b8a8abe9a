"""Live viewer (viz/live_viewer.py): the HTTP surface must serve the
page and a coherent state snapshot from a tracking System — the runtime
equivalent of the reference Viewer/MapDrawer/FrameDrawer threads
(Viewer.py:40-147)."""

import json
import urllib.request

import numpy as np

from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_jax.io.synthetic import generate_sequence
from pyorbslam_jax.slam.system import System
from pyorbslam_jax.viz.live_viewer import LiveViewer, _gray_bmp_b64


def test_viewer_serves_state(data_cache_dir):
    seq = generate_sequence(
        n_frames=8, width=512, height=160, trajectory="straight",
        speed=0.8, seed=3, cache_dir=data_cache_dir,
    )
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=512, height=160, bf=seq.bf, th_depth=40.0),
        orb=OrbConfig(n_features=600),
    )
    sysm = System(cfg)
    for i in range(8):
        sysm._viewer_image = seq.left[i]
        sysm.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])

    viewer = LiveViewer(sysm, port=0).start()
    try:
        base = f"http://127.0.0.1:{viewer.port}"
        page = urllib.request.urlopen(f"{base}/", timeout=10).read()
        assert b"follow camera" in page

        state = json.loads(
            urllib.request.urlopen(f"{base}/state", timeout=10).read())
        assert state["status"]["kfs"] >= 1
        assert state["status"]["lms"] > 100
        assert len(state["points"]) == state["status"]["lms"] or \
            len(state["points"]) > 0
        assert len(state["traj"]) == 8
        assert state["cam"] is not None
        # the camera advanced ~0.8 m/frame along +z
        assert state["traj"][-1][1] > 3.0
        assert state["frame"], "frame image missing"
    finally:
        viewer.stop()


def test_bmp_encoder_roundtrip_header():
    img = (np.arange(40 * 64, dtype=np.uint8).reshape(40, 64) % 251)
    import base64

    raw = base64.b64decode(_gray_bmp_b64(img, stride=1))
    assert raw[:2] == b"BM"
    w = int.from_bytes(raw[18:22], "little")
    h = int.from_bytes(raw[22:26], "little")
    assert (w, h) == (64, 40)
