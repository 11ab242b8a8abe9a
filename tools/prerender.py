"""Pre-render a synthetic eval world into the stream cache.

    python tools/prerender.py --frames 700 --laps 1.15 [--start 0] [--step 1]
        [--backend jax]

Default backend is the numpy ray-caster on CPU.  --backend jax renders
through io/render_jax.py on the default JAX device (the GPU when one
is present) into a separate cache key.
Renders frames start, start+step, ... so processes can split a world.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if "--backend" not in " ".join(sys.argv) or "jax" not in sys.argv:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")   # keep off the GPU


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=700)
    ap.add_argument("--width", type=int, default=1241)
    ap.add_argument("--height", type=int, default=376)
    ap.add_argument("--laps", type=float, default=1.15)
    ap.add_argument("--radius", type=float, default=55.0)
    ap.add_argument("--scene", default="interior")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--step", type=int, default=1)
    ap.add_argument("--backend", default="numpy", choices=["numpy", "jax"])
    args = ap.parse_args()

    from pyorbslam_jax.io.synthetic import SyntheticStream

    stream = SyntheticStream(
        n_frames=args.frames, width=args.width, height=args.height,
        trajectory="loop", loop_radius=args.radius, laps=args.laps,
        scene=args.scene, render_backend=args.backend,
        cache_dir=os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tests", "_data", "stream_cache"))
    t0 = time.time()
    done = 0
    for i in range(args.start, args.frames, args.step):
        stream.frame(i)
        done += 1
        if done % 25 == 0:
            dt = time.time() - t0
            print(f"{done} rendered, {dt:.0f}s ({dt / done:.2f} s/frame)",
                  flush=True)
    print(f"DONE {done} frames in {time.time() - t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
