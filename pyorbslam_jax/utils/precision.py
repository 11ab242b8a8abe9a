"""Matmul-precision control for geometry/optimizer code.

On the GPU, XLA may run float32 matrix products on the tensor cores in
TF32 (10 mantissa bits) unless the product asks for more.  For neural
nets that is free accuracy; for SE3 geometry it is not: world coordinates
grow with distance traveled, so a ~1e-3 relative error on point
transforms (Xw @ R^T) and pose compositions turns into pixel-scale
reprojection error far from the origin — enough to move chi2 gates and
inlier sets away from what the CPU computes.

``f32_matmuls`` scopes ``jax.default_matmul_precision("float32")`` over
a function body so every matmul traced inside runs in full f32.  The
geometry/LM matrices are small; the cost is negligible next to the
Hamming/extraction workloads, whose products are integer (exact in any
mode) and stay at default precision.
"""

from __future__ import annotations

import functools

import jax


def f32_matmuls(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with jax.default_matmul_precision("float32"):
            return fn(*args, **kwargs)
    return wrapped
