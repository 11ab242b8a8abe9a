"""Isolate the windowed-scan cost: image upload, scan compute with and
without the vocab/pack_frame row extras, and the packed read.

Usage: python tools/profile_scan.py [--window 8] [--frames 24]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--frames", type=int, default=24)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
    from pyorbslam_jax.io.synthetic import generate_sequence
    from pyorbslam_jax.slam.system import System
    from pyorbslam_jax.slam import tracking as trk

    W = args.window
    n_frames = args.frames
    width, height = 1241, 376
    seq = generate_sequence(
        n_frames=n_frames, width=width, height=height, trajectory="straight",
        speed=0.8, seed=3, cache_dir="tests/_data",
    )
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=width, height=height, bf=seq.bf, th_depth=40.0,
        ),
        orb=OrbConfig(n_features=2000),
    )

    # init the system on the first W frames (per-frame path)
    sysm = System(cfg)
    for i in range(W):
        sysm.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])

    lm = sysm.map.landmarks
    local_ids = sysm._local_point_ids(sysm.last_assign)
    from pyorbslam_jax.slam.system import _cap_bucket
    cap = _cap_bucket(len(local_ids), cfg.tracking.max_local_points)
    p_ids = np.full(cap, -1, np.int32)
    p_ids[: len(local_ids)] = local_ids

    def upload(w0):
        return jnp.stack([
            jnp.stack([jnp.asarray(seq.left[w0 + i], jnp.float32),
                       jnp.asarray(seq.right[w0 + i], jnp.float32)])
            for i in range(W)
        ])

    def t(label, fn, n=3):
        fn()  # warm / compile
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = (time.perf_counter() - t0) / n
        print(f"{label:42s} {dt * 1000:8.1f} ms")
        return dt

    images = upload(W)
    jax.block_until_ready(images)
    t("image upload f32 (W pairs, blocked)",
      lambda: jax.block_until_ready(upload(W)))

    u8 = [(seq.left[i].astype(np.uint8), seq.right[i].astype(np.uint8))
          for i in range(W, 2 * W)]

    def upload_u8():
        return jnp.stack([
            jnp.stack([jnp.asarray(l), jnp.asarray(r)]) for l, r in u8])

    t("image upload u8 (W pairs, blocked)",
      lambda: jax.block_until_ready(upload_u8()))

    u8b = np.stack([np.stack([l, r]) for l, r in u8])
    t("image upload u8 one batched array",
      lambda: jax.block_until_ready(jnp.asarray(u8b)))
    images = jnp.asarray(u8b)  # the deployment dtype for the scans below
    jax.block_until_ready(images)

    frame0 = sysm.last_frame
    q_lm0 = jnp.asarray(lm.resolve(sysm.last_assign))
    Tlw0 = jnp.asarray(sysm.Tcw)
    Tllw0 = jnp.asarray(
        (np.linalg.inv(sysm.velocity) @ sysm.Tcw).astype(np.float32))
    voc = sysm.vocabulary
    mirror = sysm._landmark_mirror()

    def run_slim():
        packed, frames, carry = trk.fused_track_window(
            images, *mirror, frame0, q_lm0, jnp.asarray(p_ids), Tlw0, Tllw0,
            cfg)
        return np.asarray(packed)

    t("scan slim rows dispatch+read", run_slim)

    frames_dev = None

    def run_snapshot():
        nonlocal frames_dev
        packed, frames, carry = trk.fused_track_window(
            images, *mirror, frame0, q_lm0, jnp.asarray(p_ids), Tlw0, Tllw0,
            cfg)
        f0 = jax.tree_util.tree_map(lambda a: a[0], frames)
        buf = trk.kf_snapshot(
            f0, voc._device_arrays(), voc.k, voc.L, voc.feature_levels_up)
        return np.asarray(packed), np.asarray(buf)

    t("scan slim + one kf_snapshot read", run_snapshot)


if __name__ == "__main__":
    main()
