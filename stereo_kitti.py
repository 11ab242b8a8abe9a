"""KITTI stereo CLI — reference parity (stereo_kitti.py:12-59).

Usage:
    python stereo_kitti.py --pathToSequence <seq_dir> \
        --pathToVocabulary <ORBvoc.txt or "auto"> \
        --pathToSettings <KITTIxx.yaml> [--output CameraTrajectory.txt]

The sequence dir must contain image_2/, image_3/, times.txt (KITTI
odometry layout).  Vocabulary "auto" (or a missing file) trains a scene
vocabulary from the first frame instead of loading ORBvoc.txt.
"""

import argparse
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pathToSequence", required=True)
    ap.add_argument("--pathToVocabulary", default="auto")
    ap.add_argument("--pathToSettings", required=True)
    ap.add_argument("--output", default="CameraTrajectory.txt")
    ap.add_argument("--maxFrames", type=int, default=0)
    ap.add_argument("--window", type=int, default=0,
                    help="track W frames per device dispatch "
                         "(System.track_stereo_window); 0 = per frame")
    ap.add_argument("--async", dest="async_mode", action="store_true",
                    help="pipelined per-frame schedule "
                         "(System.track_stereo_async; the bench default)")
    ap.add_argument("--viewer", type=int, default=0, metavar="PORT",
                    help="serve the live map/frame viewer on this port "
                         "(the reference Viewer thread, Viewer.py:40)")
    args = ap.parse_args()

    from pyorbslam_jax.config import SlamConfig
    from pyorbslam_jax.io.kitti import iter_stereo, load_image_paths
    from pyorbslam_jax.slam.system import System

    cfg = SlamConfig.from_yaml(args.pathToSettings)

    vocabulary = None
    if args.pathToVocabulary != "auto" and os.path.exists(args.pathToVocabulary):
        from pyorbslam_jax.place.vocabulary import Vocabulary

        print(f"loading vocabulary {args.pathToVocabulary} ...")
        vocabulary = Vocabulary.load_text(args.pathToVocabulary)

    system = System(cfg, vocabulary=vocabulary)

    left_paths, _, times = load_image_paths(args.pathToSequence)
    n = len(left_paths)
    if args.maxFrames:
        n = min(n, args.maxFrames)
    print(f"tracking {n} frames from {args.pathToSequence}")

    viewer = None
    if args.viewer:
        from pyorbslam_jax.viz.live_viewer import LiveViewer

        viewer = LiveViewer(system, port=args.viewer).start()
        print(f"live viewer: http://localhost:{viewer.port}/")

    t_start = time.time()
    if args.window:
        buf = []
        for i, (left, right, ts) in enumerate(iter_stereo(args.pathToSequence)):
            if i >= n:
                break
            buf.append((left, right, ts))
            if len(buf) == args.window:
                system.track_stereo_window(*map(list, zip(*buf)))
                buf = []
                print(f"frame {i + 1}/{n}  state={system.state} "
                      f"kfs={system.map.keyframes.n}")
        for left, right, ts in buf:   # tail shorter than one window
            system.track_stereo(left, right, ts)
    else:
        track = (system.track_stereo_async if args.async_mode
                 else system.track_stereo)
        for i, (left, right, ts) in enumerate(iter_stereo(args.pathToSequence)):
            if i >= n:
                break
            if viewer is not None:
                system._viewer_image = left
            track(left, right, ts)
            if (i + 1) % 50 == 0:
                st = system.stats[-1] if system.stats else {}
                print(f"frame {i + 1}/{n}  state={system.state} "
                      f"inliers={st.get('inliers', '-')} kfs={system.map.keyframes.n}")
        if args.async_mode:
            system.flush_async()
    dt = time.time() - t_start

    system.save_trajectory_kitti(args.output)
    system.shutdown()
    if viewer is not None:
        viewer.stop()
    print(f"done: {n} frames in {dt:.1f}s ({n / max(dt, 1e-9):.2f} fps); "
          f"trajectory -> {args.output}")


if __name__ == "__main__":
    main()
