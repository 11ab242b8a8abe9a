"""Measure the reference pyOrbSLAM frontend on this machine.

Runs the reference's own per-frame perception — its C++ ORB extractor
(via the thin C API in orb_c_api.cpp) driving its Python Frame
(Frame.compute_stereo_matches etc., imported from /root/reference) — over
a synthetic stereo sequence, and records frames/s.

g2o cannot be built here (no Eigen headers on the machine), so the
reference's g2o pose optimizations are NOT included: the measured number
is the reference's *frontend-only* throughput, an upper bound on its full
tracking fps — using it as the baseline denominator understates our
speedup.  Writes baseline_measured.json at the repo root.
"""

import ctypes
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
LIB = os.path.join(REPO, ".bbuild", "liborb_ref.so")
REF = "/root/reference"


class RefExtractor:
    """ctypes stand-in for the reference's pybind11 extractor object,
    exposing the surface Frame.py consumes."""

    CAP = 12000

    def __init__(self, nfeatures, scale, nlevels, ini_th, min_th):
        self.lib = ctypes.CDLL(LIB)
        self.lib.orb_create.restype = ctypes.c_void_p
        self.lib.orb_extract.restype = ctypes.c_int
        self.h = ctypes.c_void_p(self.lib.orb_create(
            nfeatures, ctypes.c_float(scale), nlevels, ini_th, min_th))
        self.nlevels = nlevels
        self.scale = scale

    def operator_kd(self, image):
        img = np.ascontiguousarray(image, dtype=np.uint8)
        kps = np.zeros((self.CAP, 7), np.float32)
        desc = np.zeros((self.CAP, 32), np.uint8)
        n = self.lib.orb_extract(
            self.h,
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            img.shape[0], img.shape[1],
            kps.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            desc.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            self.CAP,
        )
        keys = [
            (float(r[0]), float(r[1]), float(r[2]), float(r[3]), float(r[4]),
             int(r[5]), int(r[6]))
            for r in kps[:n]
        ]
        self._pyramid = None
        return keys, desc[:n].copy()

    def GetLevels(self):
        return self.nlevels

    def GetScaleFactor(self):
        return self.scale

    def GetScaleFactors(self):
        return [self.scale ** i for i in range(self.nlevels)]

    def GetInverseScaleFactors(self):
        return [1.0 / self.scale ** i for i in range(self.nlevels)]

    def GetScaleSigmaSquares(self):
        return [self.scale ** (2 * i) for i in range(self.nlevels)]

    def GetInverseScaleSigmaSquares(self):
        return [1.0 / self.scale ** (2 * i) for i in range(self.nlevels)]

    def GetImagePyramid(self):
        levels = []
        rows = ctypes.c_int()
        cols = ctypes.c_int()
        for l in range(self.nlevels):
            self.lib.orb_pyramid_level(self.h, l, None, ctypes.byref(rows), ctypes.byref(cols))
            buf = np.zeros((rows.value, cols.value), np.uint8)
            self.lib.orb_pyramid_level(
                self.h, l, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                ctypes.byref(rows), ctypes.byref(cols))
            levels.append(buf)
        return levels


def main():
    sys.path.insert(0, REF)
    sys.path.insert(0, os.path.join(REPO))
    from pyorbslam_jax.io.synthetic import generate_sequence

    from Frame import Frame  # reference module

    n_frames = 10
    width, height = 1241, 376
    seq = generate_sequence(
        n_frames=n_frames, width=width, height=height, trajectory="straight",
        speed=0.8, seed=3, cache_dir=os.path.join(REPO, "tests", "_data"),
    )

    fx, fy = float(seq.K[0, 0]), float(seq.K[1, 1])
    cx, cy = float(seq.K[0, 2]), float(seq.K[1, 2])
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
    dist = np.zeros((1, 5), np.float32)
    bf = seq.bf

    grid_cols, grid_rows = 64, 48
    frame_args = [
        fx, fy, cx, cy, 1.0 / fx, 1.0 / fy,
        grid_cols / width, grid_rows / height,
        0.0, float(width), 0.0, float(height),
        grid_rows, grid_cols,
    ]

    extL = RefExtractor(2000, 1.2, 8, 20, 7)
    extR = RefExtractor(2000, 1.2, 8, 20, 7)

    left0 = seq.left[0].astype(np.uint8)
    right0 = seq.right[0].astype(np.uint8)
    f = Frame(left0, right0, 0.0, extL, extR, None, K, dist, bf, 40.0, frame_args)
    n_stereo = sum(1 for d in f.mvDepth if d > 0)
    print(f"warmup: {f.N} keypoints, {n_stereo} stereo matches")

    t0 = time.time()
    for i in range(n_frames):
        Frame(seq.left[i].astype(np.uint8), seq.right[i].astype(np.uint8),
              0.1 * i, extL, extR, None, K, dist, bf, 40.0, frame_args)
    dt = time.time() - t0
    fps = n_frames / dt
    print(f"reference frontend: {fps:.3f} frames/s ({dt / n_frames * 1000:.0f} ms/frame)")

    out = {
        "reference_fps": fps,
        "scope": "frontend_only (2x C++ ORB extraction + Python stereo matching"
                 " + grid; EXCLUDES g2o pose optimization - upper bound)",
        "hardware": "this machine's CPU",
        "config": "1241x376, 2000 features, 8 levels",
    }
    with open(os.path.join(REPO, "baseline_measured.json"), "w") as fjson:
        json.dump(out, fjson, indent=1)
    print("wrote baseline_measured.json")


if __name__ == "__main__":
    main()
