"""Decompose the per-frame fused-track cost into upload / dispatch /
device-compute / read / host-prep components, to size the pipelining win.

Usage: python tools/profile_perframe.py [--frames N]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=24)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
    from pyorbslam_jax.io.synthetic import generate_sequence
    from pyorbslam_jax.slam.system import System

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

    # ---- raw host<->device transfer costs ----
    img = np.ascontiguousarray(seq.left[0])
    print(f"image bytes per frame (pair): {2 * img.nbytes}")
    for label, payload in [
        ("upload 1 image (u8)", img),
        ("upload stereo pair (u8)", np.stack([seq.left[0], seq.right[0]])),
    ]:
        xs = []
        for _ in range(6):
            t0 = time.perf_counter()
            d = jnp.asarray(payload)
            d.block_until_ready()
            xs.append(time.perf_counter() - t0)
        print(f"{label}: median {1e3 * np.median(xs):.1f} ms")

    # small read latency
    d = jnp.zeros(2048, jnp.int32) + 1
    d.block_until_ready()
    xs = []
    for _ in range(6):
        t0 = time.perf_counter()
        _ = np.asarray(d)
        xs.append(time.perf_counter() - t0)
    print(f"read 8KB buffer: median {1e3 * np.median(xs):.1f} ms")

    # dispatch latency (tiny jitted op, async cost only)
    @jax.jit
    def tiny(x):
        return x + 1

    _ = tiny(d).block_until_ready()
    xs = []
    for _ in range(6):
        t0 = time.perf_counter()
        h = tiny(d)
        xs.append(time.perf_counter() - t0)
        h.block_until_ready()
    print(f"dispatch latency (async return): median {1e3 * np.median(xs):.1f} ms")

    # ---- the actual per-frame loop, instrumented ----
    from pyorbslam_jax.slam.tracking import fused_track_step

    sysm = System(cfg)
    # warm: run the first frames through the system to initialize
    for i in range(4):
        sysm.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])

    # instrument: replicate _track_fused_inner with stage timers
    stages = {k: [] for k in
              ("host_prep", "upload", "dispatch", "device_wait", "read",
               "host_post", "total")}
    for i in range(4, n_frames):
        t_all = time.perf_counter()
        left, right = seq.left[i], seq.right[i]
        sysm.frame_id += 1

        t0 = time.perf_counter()
        lm = sysm.map.landmarks
        Tcw_pred = (sysm.velocity @ sysm.Tcw).astype(np.float32)
        q_lm = lm.resolve(sysm.last_assign)
        local_ids = sysm._local_point_ids(sysm.last_assign)
        from pyorbslam_jax.slam.system import _cap_bucket
        cap = _cap_bucket(len(local_ids), cfg.tracking.max_local_points)
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: len(local_ids)] = local_ids
        mirror = sysm._landmark_mirror()
        stages["host_prep"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        dl = jnp.asarray(left)
        dr = jnp.asarray(right)
        dl.block_until_ready(); dr.block_until_ready()
        stages["upload"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        fres = fused_track_step(
            dl, dr, *mirror,
            jnp.asarray(q_lm), sysm.last_frame,
            jnp.asarray(p_ids), jnp.asarray(Tcw_pred),
            jnp.asarray(sysm.Tcw), cfg,
        )
        stages["dispatch"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        fres.packed.block_until_ready()
        stages["device_wait"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        packed = np.asarray(fres.packed)
        stages["read"].append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        n_feat = q_lm.shape[0]
        stats = packed[:5]
        Tcw = packed[5:21].view(np.float32).reshape(4, 4)
        assign = packed[21: 21 + n_feat]
        p_visible = packed[21 + n_feat:].astype(bool)
        (n_matches, n_in_motion, n_inliers, tracked_close,
         non_tracked_close) = (int(x) for x in stats)
        vis_ids = p_ids[p_visible]
        vis_ids = vis_ids[vis_ids >= 0]
        lm.visible[vis_ids] += 1
        found_ids = np.unique(assign[assign >= 0])
        lm.found[found_ids] += 1
        lm.visible[found_ids] += 1
        sysm.state = "OK" if n_inliers >= 20 else "MARGINAL"
        sysm.Tcw = np.asarray(Tcw, np.float32)
        sysm._finish_track(
            fres.frame, assign, n_matches, n_inliers,
            tracked_close, non_tracked_close, len(local_ids),
            seq.timestamps[i])
        sysm.trajectory.append(sysm.Tcw.copy())
        ref = sysm.map.keyframes.n - 1
        Tcr = sysm.Tcw @ np.linalg.inv(sysm.map.keyframes.Tcw[ref])
        sysm.frame_refs.append((ref, Tcr.astype(np.float32)))
        stages["host_post"].append(time.perf_counter() - t0)
        stages["total"].append(time.perf_counter() - t_all)

    print("\nper-frame stage medians (ms):")
    for k, v in stages.items():
        v = np.array(v) * 1e3
        print(f"  {k:12s} median {np.median(v):7.1f}  mean {v.mean():7.1f}  "
              f"max {v.max():7.1f}")
    print("\nsystem stage timers:")
    for k, v in sorted(sysm.times.items(), key=lambda kv: -kv[1]):
        print(f"  {k:22s} {v:7.3f}s / {sysm.time_counts[k]}")


if __name__ == "__main__":
    main()
