"""Batch trajectory evaluation — the synthetic stand-in for the KITTI
00-10 sweep (BASELINE config 3; no KITTI data ships on this machine).

Runs the full System (tracking + local mapping + local BA + loop closing
+ global BA on loop closure) over a set of synthetic sequences and
prints an ATE/RPE table plus one JSON summary line.

    python tools/eval_synth.py [--frames 60] [--width 512] [--height 160]
        [--window 0] [--quick]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


SEQUENCES = [
    # name, trajectory, n_frames multiplier, seed
    ("straight-0", "straight", 1.0, 3),
    ("straight-1", "straight", 1.0, 7),
    ("turn-0", "turn", 1.0, 5),
    ("loop-0", "loop", 1.6, 11),
]


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=160)
    ap.add_argument("--features", type=int, default=1000)
    ap.add_argument("--window", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="first two sequences only")
    args = ap.parse_args()

    from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
    from pyorbslam_jax.io.synthetic import generate_sequence
    from pyorbslam_jax.slam.system import System
    from pyorbslam_jax.utils.metrics import ate_rmse, rpe

    cache = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests", "_data")
    rows = []
    seqs = SEQUENCES[:2] if args.quick else SEQUENCES
    for name, traj, mult, seed in seqs:
        n = int(args.frames * mult)
        seq = generate_sequence(
            n_frames=n, width=args.width, height=args.height,
            trajectory=traj, seed=seed, cache_dir=cache,
        )
        cfg = SlamConfig(
            camera=CameraConfig(
                fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
                cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
                width=args.width, height=args.height,
                bf=seq.bf, th_depth=40.0,
            ),
            orb=OrbConfig(n_features=args.features),
        )
        sysm = System(cfg)
        t0 = time.time()
        if args.window:
            W = args.window
            for w0 in range(0, n - n % W, W):
                sysm.track_stereo_window(
                    seq.left[w0: w0 + W], seq.right[w0: w0 + W],
                    seq.timestamps[w0: w0 + W])
            for i in range(n - n % W, n):
                sysm.track_stereo(seq.left[i], seq.right[i],
                                  seq.timestamps[i])
        else:
            for i in range(n):
                sysm.track_stereo(seq.left[i], seq.right[i],
                                  seq.timestamps[i])
        dt = time.time() - t0
        est_wc = np.linalg.inv(sysm.corrected_trajectory())
        gt = seq.poses_wc[:n]
        ate = ate_rmse(est_wc, gt)
        rpe_t, rpe_r = rpe(est_wc, gt)
        path_len = float(np.sum(np.linalg.norm(
            np.diff(gt[:, :3, 3], axis=0), axis=1)))
        loops = getattr(sysm.loop_closer, "n_loops_closed", 0) or 0
        rows.append(dict(
            seq=name, frames=n, path_m=round(path_len, 1),
            ate_rmse_m=round(float(ate), 4),
            rpe_t_m=round(float(rpe_t), 4),
            rpe_r_deg=round(float(np.degrees(rpe_r)), 4),
            kfs=int(sysm.map.keyframes.n), loops=int(loops),
            fps=round(n / dt, 2),
        ))
        r = rows[-1]
        print(f"{name:12s} frames={n:3d} path={r['path_m']:6.1f}m "
              f"ATE={r['ate_rmse_m']:.3f}m RPE={r['rpe_t_m']:.3f}m/"
              f"{r['rpe_r_deg']:.3f}deg kfs={r['kfs']} loops={r['loops']} "
              f"{r['fps']:.1f} fps")

    print(json.dumps(dict(
        metric="synthetic_batch_eval",
        mean_ate_rmse_m=round(float(np.mean([r["ate_rmse_m"] for r in rows])), 4),
        max_ate_rmse_m=round(float(np.max([r["ate_rmse_m"] for r in rows])), 4),
        sequences=rows,
    )))


if __name__ == "__main__":
    main()
