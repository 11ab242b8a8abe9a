"""Offline vocabulary training: build the shipped ORB vocabulary asset.

Mirrors the reference's offline ORBvoc construction (a k=10 deep tree
trained on a large descriptor corpus with TF-IDF weights,
TemplatedVocabulary.create semantics): descriptors are harvested from
many synthetic worlds (multiple seeds and trajectories), clustered by
recursive k-majority k-means, and leaf idf weights are computed over the
training frames as documents.

    python tools/train_vocab.py [--scenes 24] [--frames 24] [--k 10]
        [--L 5] [--out pyorbslam_jax/assets/orb_vocab.npz]
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _force_cpu():
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scenes", type=int, default=24)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=192)
    ap.add_argument("--features", type=int, default=1500)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--L", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "pyorbslam_jax", "assets", "orb_vocab.npz"))
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (leave the GPU free)")
    args = ap.parse_args()

    if args.cpu:
        _force_cpu()

    import jax.numpy as jnp

    from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
    from pyorbslam_jax.io.synthetic import generate_sequence
    from pyorbslam_jax.place import vocabulary as vocab_mod
    from pyorbslam_jax.slam.frame import build_stereo_frame_jit

    trajectories = ["straight", "loop"]
    docs = []
    t0 = time.time()
    for s in range(args.scenes):
        seq = generate_sequence(
            n_frames=args.frames, width=args.width, height=args.height,
            trajectory=trajectories[s % len(trajectories)], seed=100 + s,
        )
        cfg = SlamConfig(
            camera=CameraConfig(
                fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
                cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
                width=args.width, height=args.height, bf=seq.bf,
                th_depth=40.0),
            orb=OrbConfig(n_features=args.features),
        )
        for i in range(args.frames):
            frame = build_stereo_frame_jit(
                jnp.asarray(seq.left[i], jnp.float32),
                jnp.asarray(seq.right[i], jnp.float32), cfg)
            valid = np.asarray(frame.valid)
            docs.append(np.asarray(frame.desc)[valid])
        print(f"scene {s + 1}/{args.scenes}: "
              f"{sum(len(d) for d in docs)} descriptors "
              f"({time.time() - t0:.0f}s)", flush=True)

    corpus = np.concatenate(docs)
    print(f"training k={args.k} L={args.L} on {len(corpus)} descriptors "
          f"from {len(docs)} documents...", flush=True)
    t1 = time.time()
    voc = vocab_mod.train(corpus, k=args.k, L=args.L, seed=0)
    print(f"trained: {voc.n_words} words, {len(voc.node_desc)} nodes "
          f"({time.time() - t1:.0f}s)", flush=True)
    t2 = time.time()
    vocab_mod.set_idf_weights(voc, docs)
    nz = int((voc.weight[voc.word_id >= 0] > 0).sum())
    print(f"idf: {nz}/{voc.n_words} words seen in corpus "
          f"({time.time() - t2:.0f}s)", flush=True)
    vocab_mod.save_npz(voc, args.out)
    print(f"saved {args.out} ({os.path.getsize(args.out) / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
