"""Wall-clock profile of the full pipeline: wraps each pipeline stage
with timers and reports total seconds per stage over the timed pass.

Usage: python tools/profile_pipeline.py [--window W] [--frames N]
"""

import argparse
import functools
import os
import sys
import time
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--frames", type=int, default=34)
    ap.add_argument("--pipelined", action="store_true",
                    help="use window_feed/window_flush (overlap scan N+1 "
                         "with host processing of window N)")
    args = ap.parse_args()

    import jax

    from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
    from pyorbslam_jax.io.synthetic import generate_sequence
    from pyorbslam_jax.slam import local_mapping, system as system_mod
    from pyorbslam_jax.slam.system import System
    from pyorbslam_jax.slam import slam_map as slam_map_mod
    from pyorbslam_jax.slam.loop_closing import LoopCloser

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

    times = defaultdict(float)
    counts = defaultdict(int)
    enabled = [False]

    def wrap(obj, name, label=None):
        label = label or name
        orig = getattr(obj, name)

        @functools.wraps(orig)
        def timed(*a, **kw):
            if not enabled[0]:
                return orig(*a, **kw)
            t0 = time.perf_counter()
            out = orig(*a, **kw)
            times[label] += time.perf_counter() - t0
            counts[label] += 1
            return out
        setattr(obj, name, timed)

    wrap(local_mapping.LocalMapper, "create_new_points", "lm.triangulate")
    wrap(local_mapping.LocalMapper, "fuse_neighbors", "lm.fuse")
    wrap(local_mapping.LocalMapper, "cull_keyframes", "lm.cull_kf")
    wrap(slam_map_mod.SlamMap, "local_ba", "map.local_ba")
    wrap(slam_map_mod.SlamMap, "add_keyframe", "map.add_keyframe")
    wrap(slam_map_mod.SlamMap, "cull_map_points", "map.cull_points")
    wrap(slam_map_mod.SlamMap, "update_connections", "map.update_conn")
    wrap(LoopCloser, "on_keyframe", "loop.on_keyframe")
    wrap(System, "_insert_keyframe", "sys.insert_kf(total)")
    wrap(System, "_create_landmarks", "sys.create_landmarks")
    wrap(System, "_frame_host", "sys.frame_pull")
    wrap(System, "_local_point_ids", "sys.local_point_ids")
    wrap(System, "_landmark_mirror", "sys.mirror_upload")
    import pyorbslam_jax.place.vocabulary as vm
    wrap(vm.Vocabulary, "transform", "vocab.transform")
    wrap(vm, "train", "vocab.train")
    wrap(System, "_stereo_initialization", "sys.init(total)")
    wrap(System, "_track_fused", "sys.track_fused(total)")
    wrap(System, "_commit_window", "sys.commit_window(total)")
    wrap(System, "_dispatch_window", "sys.dispatch_window")
    wrap(System, "_retrack_window_frame", "sys.retrack_frame")

    # time the window device dispatch + the packed read separately
    import pyorbslam_jax.slam.tracking as trk
    import pyorbslam_jax.slam.system as sysm_mod
    orig_window = trk.fused_track_window

    def timed_window(*a, **kw):
        if not enabled[0]:
            return orig_window(*a, **kw)
        t0 = time.perf_counter()
        packed, frames, carry = orig_window(*a, **kw)
        times["window.dispatch(async)"] += time.perf_counter() - t0
        counts["window.dispatch(async)"] += 1
        t0 = time.perf_counter()
        out = np.asarray(packed)
        times["window.sync_read"] += time.perf_counter() - t0
        counts["window.sync_read"] += 1
        return out, frames, carry
    sysm_mod.fused_track_window = timed_window

    def run():
        sysm = System(cfg)
        W = args.window
        if W and args.pipelined:
            for w0 in range(0, n_frames - n_frames % W, W):
                sysm.window_feed(
                    seq.left[w0: w0 + W], seq.right[w0: w0 + W],
                    seq.timestamps[w0: w0 + W])
            sysm.window_flush()
        elif W:
            for w0 in range(0, n_frames - n_frames % W, W):
                sysm.track_stereo_window(
                    seq.left[w0: w0 + W], seq.right[w0: w0 + W],
                    seq.timestamps[w0: w0 + W])
        else:
            for i in range(n_frames):
                sysm.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
        return sysm

    run()  # warm/compile pass (untimed)
    enabled[0] = True
    t0 = time.perf_counter()
    sysm = run()
    total = time.perf_counter() - t0

    n_tracked = (n_frames - n_frames % args.window) if args.window else n_frames
    print(f"\ntotal {total:.2f}s  {n_tracked / total:.2f} fps  "
          f"kfs={int(sysm.map.keyframes.n)}")
    if sysm.events:
        from collections import Counter
        print("schedule events:", dict(Counter(sysm.events)))
    acc = 0.0
    for k in sorted(times, key=times.get, reverse=True):
        print(f"{times[k]:7.3f}s  x{counts[k]:<4d} {k}")
        if "(total)" not in k:
            acc += times[k]
    print(f"{acc:7.3f}s  accounted (excl. (total) rollups)")
    print(f"{total - acc:7.3f}s  unaccounted (window dispatch + host glue)")


if __name__ == "__main__":
    main()
