"""Export a synthetic stereo sequence in KITTI odometry layout so the
reference-parity CLI (stereo_kitti.py) can be driven end-to-end on this
machine (no KITTI data ships here): image_2/, image_3/, times.txt, a
matching settings YAML, and poses.txt ground truth for external ATE.

    python tools/make_kitti_synth.py --out /tmp/synthseq \
        [--frames 60] [--width 640] [--height 192] [--trajectory straight]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--trajectory", default="straight",
                    choices=["straight", "turn", "loop"])
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args()

    import cv2

    from pyorbslam_jax.io.synthetic import generate_sequence

    seq = generate_sequence(
        n_frames=args.frames, width=args.width, height=args.height,
        trajectory=args.trajectory, speed=0.8, seed=args.seed,
    )
    os.makedirs(os.path.join(args.out, "image_2"), exist_ok=True)
    os.makedirs(os.path.join(args.out, "image_3"), exist_ok=True)
    for i in range(args.frames):
        cv2.imwrite(os.path.join(args.out, "image_2", f"{i:06d}.png"),
                    np.clip(seq.left[i], 0, 255).astype(np.uint8))
        cv2.imwrite(os.path.join(args.out, "image_3", f"{i:06d}.png"),
                    np.clip(seq.right[i], 0, 255).astype(np.uint8))
    np.savetxt(os.path.join(args.out, "times.txt"), seq.timestamps, "%.6f")
    # ground truth in KITTI pose format (3x4 row-major Twc)
    with open(os.path.join(args.out, "poses.txt"), "w") as f:
        for T in seq.poses_wc:
            f.write(" ".join(f"{x:.9e}" for x in T[:3].reshape(-1)) + "\n")
    K = seq.K
    yaml = os.path.join(args.out, "settings.yaml")
    with open(yaml, "w") as f:
        f.write(f"""%YAML:1.0
Camera.fx: {K[0, 0]}
Camera.fy: {K[1, 1]}
Camera.cx: {K[0, 2]}
Camera.cy: {K[1, 2]}
Camera.k1: 0.0
Camera.k2: 0.0
Camera.p1: 0.0
Camera.p2: 0.0
Camera.width: {args.width}
Camera.height: {args.height}
Camera.fps: 10.0
Camera.bf: {seq.bf}
Camera.RGB: 1
ThDepth: 40
ORBextractor.nFeatures: 1000
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 8
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
""")
    print(f"wrote {args.frames} frames + times.txt + poses.txt + {yaml}")


if __name__ == "__main__":
    main()
