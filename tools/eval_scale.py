"""Scale integration run: a KITTI-00-shaped synthetic sequence (hundreds
to thousands of frames, multi-lap loop with repeated revisit events)
through the FULL pipelined System — exercising keyframe culling, the CG
pose graph and CG/distributed global BA at the map sizes they exist for.

    python tools/eval_scale.py [--frames 1000] [--width 1241]
        [--height 376] [--laps 2.2] [--window 8] [--cpu]

Prints per-100-frame progress and a final JSON line with fps / ATE /
map statistics.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=1000)
    ap.add_argument("--width", type=int, default=1241)
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--features", type=int, default=2000)
    ap.add_argument("--laps", type=float, default=2.2)
    ap.add_argument("--radius", type=float, default=60.0)
    ap.add_argument("--window", type=int, default=8)
    ap.add_argument("--scene", default="corridor",
                    choices=["corridor", "interior"],
                    help="interior = pillar rings inside the stereo "
                         "depth gate (the drift-then-repair world)")
    ap.add_argument("--no-loop", action="store_true",
                    help="disable loop closing (odometry-drift ablation)")
    ap.add_argument("--render-backend", default="numpy",
                    choices=["numpy", "jax"],
                    help="jax = io/render_jax.py on the device (distinct "
                         "stream-cache key; pre-render with "
                         "tools/prerender.py --backend jax)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
    from pyorbslam_jax.io.synthetic import SyntheticStream
    from pyorbslam_jax.slam.system import System
    from pyorbslam_jax.utils.metrics import ate_rmse

    stream = SyntheticStream(
        n_frames=args.frames, width=args.width, height=args.height,
        trajectory="loop", loop_radius=args.radius, laps=args.laps,
        scene=args.scene, render_backend=args.render_backend,
        cache_dir=os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests", "_data", "stream_cache"))
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(stream.K[0, 0]), fy=float(stream.K[1, 1]),
            cx=float(stream.K[0, 2]), cy=float(stream.K[1, 2]),
            width=args.width, height=args.height, bf=stream.bf,
            th_depth=40.0),
        orb=OrbConfig(n_features=args.features),
    )
    sysm = System(cfg, enable_loop_closing=not args.no_loop)
    W = args.window
    t0 = time.time()
    render_s = 0.0

    def progress(done, n):
        ks = sysm.map.keyframes
        print(f"frame {done}/{n}: kfs={int(ks.alive[:ks.n].sum())}"
              f"/{ks.n} lms={int(sysm.map.landmarks.alive.sum())}"
              f" loops={sysm.loop_closer.n_loops_closed if sysm.loop_closer else 0}"
              f" state={sysm.state}"
              f" elapsed={time.time() - t0:.0f}s", flush=True)
        stages = sorted(sysm.times.items(), key=lambda kv: -kv[1])[:6]
        print("  stages: " + "  ".join(
            f"{k}={v:.1f}s/{sysm.time_counts[k]}" for k, v in stages),
            flush=True)
        if sysm.loop_closer is not None and sysm.loop_closer.times:
            print("  loop:   " + "  ".join(
                f"{k}={v:.1f}s" for k, v in sorted(
                    sysm.loop_closer.times.items(), key=lambda kv: -kv[1])),
                flush=True)
        if sysm.map.times:
            print("  map:    " + "  ".join(
                f"{k}={v:.1f}s" for k, v in sorted(
                    sysm.map.times.items(), key=lambda kv: -kv[1])[:6]),
                flush=True)

    if W == 0:
        # pipelined per-frame schedule (the deployment default)
        n = args.frames
        for i in range(n):
            tr = time.time()
            left, right = stream.frame(i)
            render_s += time.time() - tr
            sysm.track_stereo_async(left, right, stream.timestamps[i])
            if (i + 1) % 100 == 0:
                progress(i + 1, n)
        sysm.flush_async()
    else:
        n = args.frames - args.frames % W
        for w0 in range(0, n, W):
            tr = time.time()
            pairs = [stream.frame(w0 + j) for j in range(W)]
            render_s += time.time() - tr
            lefts = [p[0] for p in pairs]
            rights = [p[1] for p in pairs]
            sysm.window_feed(lefts, rights, stream.timestamps[w0: w0 + W])
            if (w0 + W) % 100 < W:
                progress(w0 + W, n)
        sysm.window_flush()
    dt = time.time() - t0 - render_s

    est_wc = np.linalg.inv(sysm.corrected_trajectory())
    ate = float(ate_rmse(est_wc, stream.poses_wc[:n]))
    ks = sysm.map.keyframes
    print(json.dumps({
        "metric": "scale_run",
        "frames": n, "fps": round(n / dt, 2), "ate_rmse_m": round(ate, 3),
        "track_len_m": round(float(np.linalg.norm(
            np.diff(stream.poses_wc[:n, :3, 3], axis=0), axis=1).sum()), 1),
        "keyframes_alive": int(ks.alive[: ks.n].sum()),
        "keyframes_total": int(ks.n),
        "landmarks": int(sysm.map.landmarks.alive.sum()),
        "loops_closed": (sysm.loop_closer.n_loops_closed
                         if sysm.loop_closer else 0),
        "loops_rejected": (sysm.loop_closer.n_loops_rejected
                           if sysm.loop_closer else 0),
        "loops_fused": (sysm.loop_closer.n_loops_fused
                        if sysm.loop_closer else 0),
        "ba_rejected_writebacks": int(
            sysm.map.counters.get("ba.rejected_writebacks", 0)),
        "render_s": round(render_s, 1), "slam_s": round(dt, 1),
        "scene": args.scene, "loop_closing": not args.no_loop,
        "render_backend": args.render_backend,
        "backend": jax.devices()[0].platform,
    }))


if __name__ == "__main__":
    main()
