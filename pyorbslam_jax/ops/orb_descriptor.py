"""Keypoint orientation (intensity centroid) and rotated-BRIEF descriptors.

Replaces the reference's per-keypoint C++ loops (ORBextractor.cpp
IC_Angle:77-104 and computeOrbDescriptor:108-147) with batched gathers:

  * orientation is a single (N, 961) patch-gather followed by a matmul
    with two static moment-weight vectors;
  * descriptors rotate the 256-pair pattern per keypoint, round to
    integer offsets exactly like the reference's cvRound'd GET_VALUE, and
    gather 512 samples per keypoint from the blurred level image.

The 512-point sampling pattern is the standard OpenCV rBRIEF constant
table (public BSD data; same values as ORBextractor.cpp:150-408), stored
as ``assets/orb_brief_pattern.npy``.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

HALF_PATCH_SIZE = 15
PATCH_SIZE = 31
BORDER = 19  # reflected border budget around each level (EDGE_THRESHOLD)

_ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "assets")


@lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """(512, 2) int32 (x, y) sampling offsets."""
    return np.load(os.path.join(_ASSET_DIR, "orb_brief_pattern.npy"))


@lru_cache(maxsize=1)
def umax_table() -> np.ndarray:
    """Circular-patch row extents, symmetric (ORBextractor.cpp:454-469)."""
    hp = HALF_PATCH_SIZE
    umax = np.zeros(hp + 1, dtype=np.int64)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax


@lru_cache(maxsize=1)
def _moment_weights() -> Tuple[np.ndarray, np.ndarray]:
    """Static (961,) weight vectors so that the centroid moments are
    m10 = patch @ wx and m01 = patch @ wy over the circular mask."""
    umax = umax_table()
    hp = HALF_PATCH_SIZE
    wx = np.zeros((PATCH_SIZE, PATCH_SIZE), np.float32)
    wy = np.zeros((PATCH_SIZE, PATCH_SIZE), np.float32)
    for dv in range(-hp, hp + 1):
        d = umax[abs(dv)]
        for du in range(-d, d + 1):
            wx[dv + hp, du + hp] = du
            wy[dv + hp, du + hp] = dv
    return wx.reshape(-1), wy.reshape(-1)


def gather_patches(
    padded: jnp.ndarray, xy: jnp.ndarray, dy: jnp.ndarray, dx: jnp.ndarray,
    border: int = BORDER,
) -> jnp.ndarray:
    """Gather per-keypoint samples from a reflect-padded level image.

    padded: (H + 2*border, W + 2*border); xy: (N, 2) int32 level coords;
    dy/dx: (P,) or (N, P) int32 offsets.  Returns (N, P) float32.
    """
    wp = padded.shape[-1]
    ys = xy[:, 1:2] + border + (dy if dy.ndim == 2 else dy[None, :])
    xs = xy[:, 0:1] + border + (dx if dx.ndim == 2 else dx[None, :])
    flat_idx = ys * wp + xs
    return jnp.take(padded.reshape(-1), flat_idx, axis=0)


def ic_angle(padded_level: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """Intensity-centroid orientation in degrees [0, 360).

    padded_level is the *unblurred* level image with BORDER reflect pad
    (the reference computes orientation pre-blur: operator_kd order).
    Reference formulation: per-keypoint 31x31 patch gather + moment dot.
    Kept for golden tests; the production extractor uses
    :func:`moment_maps` + :func:`ic_angle_from_maps` (identical math,
    no per-keypoint gathers).
    """
    hp = HALF_PATCH_SIZE
    offs = np.arange(-hp, hp + 1, dtype=np.int32)
    dyg, dxg = np.meshgrid(offs, offs, indexing="ij")
    patches = gather_patches(
        padded_level, xy, jnp.asarray(dyg.reshape(-1)), jnp.asarray(dxg.reshape(-1))
    )  # (N, 961)
    wx, wy = _moment_weights()
    W = jnp.stack([jnp.asarray(wx), jnp.asarray(wy)], axis=1)  # (961, 2)
    m = jnp.dot(patches, W, preferred_element_type=jnp.float32)  # (N, 2)
    ang = jnp.degrees(jnp.arctan2(m[:, 1], m[:, 0]))
    return jnp.where(ang < 0, ang + 360.0, ang)


def moment_maps(padded_level: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Whole-image intensity-centroid moment maps (m10, m01).

    Gather-free reformulation of IC_Angle: per-keypoint patch gathers
    (3.8M gathered pixels/frame) become row-cumulative sums + 31 shifted
    window reads per map — elementwise passes only.  For the
    circular patch, each row dy contributes the interval |dx| <= umax(dy):

      m10(y,x) = sum_dy [ cumJ(y+dy, x+d) - cumJ(y+dy, x-d-1) ]
                 - x * [ cumI(...same window...) ]
      m01(y,x) = sum_dy dy * [ cumI window sum ]

    with cumI = cumsum(I, axis=1), cumJ = cumsum(col * I, axis=1).
    Exact same moments as the reference's circular mask.
    Input is the (H + 2*BORDER, W + 2*BORDER) padded level; outputs have
    the same shape, valid wherever the full patch fits.
    """
    hp = HALF_PATCH_SIZE
    umax = umax_table()
    hpd, wpd = padded_level.shape
    cols = jnp.arange(wpd, dtype=jnp.float32)[None, :]
    I = padded_level
    # prepend a zero column so cum[x] = sum of cols [0, x-1]; window
    # [x-d, x+d] = cum[x+d+1] - cum[x-d]
    cumI = jnp.concatenate(
        [jnp.zeros((hpd, 1), I.dtype), jnp.cumsum(I, axis=1)], axis=1)
    cumJ = jnp.concatenate(
        [jnp.zeros((hpd, 1), I.dtype), jnp.cumsum(cols * I, axis=1)], axis=1)

    xs = jnp.arange(wpd, dtype=jnp.float32)[None, :]
    m10 = jnp.zeros_like(I)
    m01 = jnp.zeros_like(I)
    for dy in range(-hp, hp + 1):
        d = int(umax[abs(dy)])
        # rows shifted by dy: valid only in the interior (border >= hp)
        rowI = jax.lax.dynamic_slice(
            cumI, (hp + dy, 0), (hpd - 2 * hp, wpd + 1))
        rowJ = jax.lax.dynamic_slice(
            cumJ, (hp + dy, 0), (hpd - 2 * hp, wpd + 1))
        # window [x-d, x+d]: starts x-d -> index x-d, end x+d -> x+d+1
        wI = jax.lax.dynamic_slice(rowI, (0, hp + d + 1), (hpd - 2 * hp, wpd - 2 * hp)) \
            - jax.lax.dynamic_slice(rowI, (0, hp - d), (hpd - 2 * hp, wpd - 2 * hp))
        wJ = jax.lax.dynamic_slice(rowJ, (0, hp + d + 1), (hpd - 2 * hp, wpd - 2 * hp)) \
            - jax.lax.dynamic_slice(rowJ, (0, hp - d), (hpd - 2 * hp, wpd - 2 * hp))
        xin = xs[:, hp:wpd - hp]
        m10 = m10.at[hp:hpd - hp, hp:wpd - hp].add(wJ - xin * wI)
        m01 = m01.at[hp:hpd - hp, hp:wpd - hp].add(float(dy) * wI)
    return m10, m01


def ic_angles_at(padded: jnp.ndarray, xy: jnp.ndarray) -> jnp.ndarray:
    """IC orientation evaluated at keypoints only: row cumsums + four
    gathers per (keypoint, patch row) — ~0.5M gathered values instead of
    whole-canvas moment maps (:func:`moment_maps` writes and reads two
    canvas-sized maps per frame, which are then sampled at only a few
    thousand keypoints).  Moments are the exact
    circular-patch sums of the reference's IC_Angle
    (ORBextractor.cpp:93-124): identical umax row widths, identical
    centered column weights."""
    hp = HALF_PATCH_SIZE
    umax = umax_table()
    hpd, wpd = padded.shape
    # center the column weights mid-canvas: cumsum(col*I) would otherwise
    # reach ~2e8 at wide atlas canvases (float32 resolution ~16 there),
    # injecting noise into m10 for keypoints at large x; the centering is
    # compensated exactly in the m10 line below
    c0 = float(wpd // 2)
    cols = (jnp.arange(wpd, dtype=jnp.float32) - c0)[None, :]
    cumI = jnp.concatenate(
        [jnp.zeros((hpd, 1), padded.dtype), jnp.cumsum(padded, axis=1)],
        axis=1)
    cumJ = jnp.concatenate(
        [jnp.zeros((hpd, 1), padded.dtype),
         jnp.cumsum(cols * padded, axis=1)], axis=1)
    W1 = wpd + 1
    x = xy[:, 0].astype(jnp.int32)
    y = xy[:, 1].astype(jnp.int32)
    dys = jnp.arange(-hp, hp + 1, dtype=jnp.int32)            # (31,)
    ds = jnp.asarray(umax[np.abs(np.arange(-hp, hp + 1))], jnp.int32)
    rows = (y[:, None] + dys[None, :]) * W1                   # (N, 31)
    hi = rows + x[:, None] + ds[None, :] + 1
    lo = rows + x[:, None] - ds[None, :]
    cI = cumI.reshape(-1)
    cJ = cumJ.reshape(-1)
    winI = jnp.take(cI, hi) - jnp.take(cI, lo)
    winJ = jnp.take(cJ, hi) - jnp.take(cJ, lo)
    m10 = jnp.sum(winJ, axis=1) - (x.astype(jnp.float32) - c0) * jnp.sum(
        winI, axis=1)
    m01 = jnp.sum(winI * dys[None, :].astype(jnp.float32), axis=1)
    ang = jnp.degrees(jnp.arctan2(m01, m10))
    return jnp.where(ang < 0, ang + 360.0, ang)


def ic_angle_from_maps(
    m10_map: jnp.ndarray, m01_map: jnp.ndarray, xy: jnp.ndarray,
    border: int = BORDER,
) -> jnp.ndarray:
    """Orientation lookup: two gathers per keypoint instead of 961."""
    wp = m10_map.shape[-1]
    idx = (xy[:, 1] + border) * wp + (xy[:, 0] + border)
    m10 = jnp.take(m10_map.reshape(-1), idx, axis=0)
    m01 = jnp.take(m01_map.reshape(-1), idx, axis=0)
    ang = jnp.degrees(jnp.arctan2(m01, m10))
    return jnp.where(ang < 0, ang + 360.0, ang)


def brief_descriptors(
    padded_blurred: jnp.ndarray, xy: jnp.ndarray, angle_deg: jnp.ndarray
) -> jnp.ndarray:
    """Steered 256-bit BRIEF -> packed uint32 (N, 8).

    Bit packing is little-endian over the reference's byte layout: pair
    ``p`` lands in word ``p // 32`` at bit ``p % 32``, which equals the
    reference's 32-byte rows read as 8 little-endian uint32 words
    (computeOrbDescriptor packs pair 8*i+j into byte i bit j).
    """
    pat = jnp.asarray(brief_pattern(), jnp.float32)  # (512, 2) (x, y)
    rad = jnp.radians(angle_deg)
    a = jnp.cos(rad)[:, None]  # (N, 1)
    b = jnp.sin(rad)[:, None]
    px, py = pat[None, :, 0], pat[None, :, 1]
    # reference GET_VALUE: row = round(px*sin + py*cos), col = round(px*cos - py*sin)
    rows = jnp.round(px * b + py * a).astype(jnp.int32)  # (N, 512)
    cols = jnp.round(px * a - py * b).astype(jnp.int32)
    vals = gather_patches(padded_blurred, xy, rows, cols)  # (N, 512)
    bits = (vals[:, 0::2] < vals[:, 1::2]).astype(jnp.uint32)  # (N, 256)
    words = bits.reshape(-1, 8, 32)
    shifts = jnp.arange(32, dtype=jnp.uint32)
    return jnp.sum(words << shifts[None, None, :], axis=-1, dtype=jnp.uint32)
