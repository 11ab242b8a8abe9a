"""Image pyramid + Gaussian blur as XLA-friendly ops.

Replaces the reference's OpenCV pyramid (ORBextractor.cpp ComputePyramid:
1106-1132): level sizes are ``round(W / s^l)`` computed from the *original*
image, each level bilinearly resized from the previous one; descriptors are
computed on a 7x7 sigma=2 Gaussian-blurred copy (operator_kd, reflect-101
border).  Everything here is static-shape given the input resolution.
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def level_sizes(height: int, width: int, scale_factor: float, n_levels: int
                ) -> List[Tuple[int, int]]:
    """Per-level (H, W): round(dim * invScale^l) of the original image."""
    out = []
    for l in range(n_levels):
        inv = 1.0 / (scale_factor ** l)
        # cvRound rounds half-to-even; shapes only shift by a pixel either
        # way, which the trajectory-level gates absorb.
        out.append((int(round(height * inv)), int(round(width * inv))))
    return out


def resize_bilinear(img: jnp.ndarray, out_hw: Tuple[int, int]) -> jnp.ndarray:
    """Bilinear resize matching cv2.resize INTER_LINEAR pixel-center
    alignment: src = (dst + 0.5) * scale - 0.5, edge-clamped."""
    in_h, in_w = img.shape[-2], img.shape[-1]
    out_h, out_w = out_hw
    scale_y = in_h / out_h
    scale_x = in_w / out_w

    ys = (jnp.arange(out_h, dtype=jnp.float32) + 0.5) * scale_y - 0.5
    xs = (jnp.arange(out_w, dtype=jnp.float32) + 0.5) * scale_x - 0.5
    y0 = jnp.clip(jnp.floor(ys), 0, in_h - 1)
    x0 = jnp.clip(jnp.floor(xs), 0, in_w - 1)
    fy = jnp.clip(ys - y0, 0.0, 1.0)
    fx = jnp.clip(xs - x0, 0.0, 1.0)
    y0i = y0.astype(jnp.int32)
    x0i = x0.astype(jnp.int32)
    y1i = jnp.minimum(y0i + 1, in_h - 1)
    x1i = jnp.minimum(x0i + 1, in_w - 1)

    r0 = img[..., y0i, :]
    r1 = img[..., y1i, :]
    rows = r0 + fy[:, None] * (r1 - r0)          # (out_h, in_w)
    c0 = rows[..., :, x0i]
    c1 = rows[..., :, x1i]
    return c0 + fx[None, :] * (c1 - c0)


def build_pyramid(img: jnp.ndarray, scale_factor: float, n_levels: int
                  ) -> List[jnp.ndarray]:
    """float32 HxW -> list of n_levels float32 images (chained resize)."""
    sizes = level_sizes(img.shape[-2], img.shape[-1], scale_factor, n_levels)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], sizes[l]))
    return levels


def gaussian_kernel_1d(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: jnp.ndarray, ksize: int = 7, sigma: float = 2.0
                  ) -> jnp.ndarray:
    """Separable Gaussian blur with reflect-101 border (cv2 default)."""
    k = jnp.asarray(gaussian_kernel_1d(ksize, sigma))
    half = ksize // 2
    padded = jnp.pad(img, ((half, half), (half, half)), mode="reflect")
    # horizontal then vertical 1-D convolutions via shifted adds: for a
    # 7-tap kernel this is 7 fused multiply-adds per axis, which XLA
    # fuses into one elementwise pass (no conv_general_dilated).
    h, w = img.shape
    acc = jnp.zeros((h + 2 * half, w), img.dtype)
    for i in range(ksize):
        acc = acc + k[i] * jax.lax.dynamic_slice(padded, (0, i), (h + 2 * half, w))
    out = jnp.zeros((h, w), img.dtype)
    for i in range(ksize):
        out = out + k[i] * jax.lax.dynamic_slice(acc, (i, 0), (h, w))
    return out


def reflect_pad(img: jnp.ndarray, border: int) -> jnp.ndarray:
    """Reflect-101 border used before patch gathers (EDGE_THRESHOLD=19)."""
    return jnp.pad(img, ((border, border), (border, border)), mode="reflect")
