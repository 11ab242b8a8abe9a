"""Stereo keypoint matching: epipolar-band Hamming + SAD sub-pixel refine.

Replaces the reference's per-keypoint loop (Frame.compute_stereo_matches,
Frame.py:161-279) with one batched program:

  * candidate gating (row band +-2*scaleFactor[octave_R], octave within
    +-1, disparity in [0, bf/b)) becomes boolean masks over the full
    NxN Hamming matrix, which itself is an int8 matmul;
  * the best-match threshold is (TH_HIGH + TH_LOW)/2 (Frame.py:166);
  * sub-pixel refinement slides an 11x11 center-subtracted SAD window
    +-5 px at the keypoint's pyramid level and refines with the same
    parabola fit, all as gathers from a flattened pyramid "atlas";
  * the median-SAD outlier cut from upstream ORB-SLAM2 (dropped by the
    Python port, which collects vDistIdx but never filters) is applied —
    intended-semantics choice per SURVEY.md §6.

Outputs the (u_right, depth) arrays with -1 for unmatched, exactly the
downstream contract of mvuRight/mvDepth.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.ops import hamming as ham

W_SAD = 5    # half window of the SAD patch (11x11)
L_SLIDE = 5  # slide range +-5 px


class PyramidAtlas(NamedTuple):
    """All pyramid levels flattened into one 1-D buffer for mixed-level
    gathers: pixel (x, y) of level l lives at offset[l] + y*width[l] + x."""

    flat: jnp.ndarray      # (sum(H_l * W_l),) float32
    offsets: jnp.ndarray   # (L,) int32
    widths: jnp.ndarray    # (L,) int32
    heights: jnp.ndarray   # (L,) int32


def build_atlas(levels: List[jnp.ndarray]) -> PyramidAtlas:
    offsets = np.cumsum([0] + [int(l.shape[0] * l.shape[1]) for l in levels[:-1]])
    return PyramidAtlas(
        flat=jnp.concatenate([l.reshape(-1) for l in levels]),
        offsets=jnp.asarray(offsets, jnp.int32),
        widths=jnp.asarray([l.shape[1] for l in levels], jnp.int32),
        heights=jnp.asarray([l.shape[0] for l in levels], jnp.int32),
    )


def _atlas_gather(atlas: PyramidAtlas, level: jnp.ndarray,
                  ys: jnp.ndarray, xs: jnp.ndarray) -> jnp.ndarray:
    """Clamped gather: level (N,), ys/xs (N, ...) -> (N, ...) float32."""
    w = atlas.widths[level]
    h = atlas.heights[level]
    extra = (1,) * (ys.ndim - 1)
    wb = w.reshape(w.shape + extra)
    hb = h.reshape(h.shape + extra)
    ob = atlas.offsets[level].reshape(w.shape + extra)
    ysc = jnp.clip(ys, 0, hb - 1)
    xsc = jnp.clip(xs, 0, wb - 1)
    return jnp.take(atlas.flat, ob + ysc * wb + xsc, axis=0)


def match_stereo(
    xy_l: jnp.ndarray, oct_l: jnp.ndarray, desc_l: jnp.ndarray, valid_l: jnp.ndarray,
    xy_r: jnp.ndarray, oct_r: jnp.ndarray, desc_r: jnp.ndarray, valid_r: jnp.ndarray,
    atlas_l: PyramidAtlas, atlas_r: PyramidAtlas,
    scale_factors: jnp.ndarray,   # (L,) float32, 1.2^l
    bf: float,
    max_disparity: float,         # = fx: maxD = bf / minZ with minZ = baseline (Frame.py:181-183)
    min_disparity: float = 0.0,
    th_orb: float = 75.0,         # (TH_HIGH + TH_LOW) / 2
    sad_median_filter: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Returns (u_right, depth), each (N,) float32 with -1 where unmatched."""
    inv_scale = 1.0 / scale_factors

    # ---- candidate gating over the full distance matrix ----
    dist = ham.hamming_matrix(desc_l, desc_r)  # (N, M) int32

    vl_int = jnp.floor(xy_l[:, 1]).astype(jnp.int32)
    r_band = 2.0 * scale_factors[oct_r]                       # (M,)
    row_ok = (
        (vl_int[:, None] >= jnp.floor(xy_r[None, :, 1] - r_band[None, :]))
        & (vl_int[:, None] <= jnp.ceil(xy_r[None, :, 1] + r_band[None, :]))
    )
    oct_ok = jnp.abs(oct_l[:, None] - oct_r[None, :]) <= 1
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    disp_ok = (disp >= min_disparity) & (disp <= max_disparity)

    mask = (
        row_ok & oct_ok & disp_ok
        & valid_l[:, None] & valid_r[None, :]
    )
    dist = jnp.where(mask, dist, 10_000)
    best_idx = jnp.argmin(dist, axis=1)
    best_dist = jnp.take_along_axis(dist, best_idx[:, None], axis=1)[:, 0]
    matched = best_dist < th_orb

    # ---- SAD sub-pixel refinement at the left keypoint's level ----
    sf_l = scale_factors[oct_l]            # (N,)
    inv_l = inv_scale[oct_l]
    u_r0 = xy_r[best_idx, 0]
    su_l = jnp.round(xy_l[:, 0] * inv_l).astype(jnp.int32)
    sv_l = jnp.round(xy_l[:, 1] * inv_l).astype(jnp.int32)
    su_r0 = jnp.round(u_r0 * inv_l).astype(jnp.int32)

    offs = jnp.arange(-W_SAD, W_SAD + 1, dtype=jnp.int32)           # (11,)
    wide = jnp.arange(-W_SAD - L_SLIDE, W_SAD + L_SLIDE + 1, dtype=jnp.int32)  # (21,)

    patch_l = _atlas_gather(
        atlas_l, oct_l,
        sv_l[:, None, None] + offs[None, :, None],
        su_l[:, None, None] + offs[None, None, :],
    )  # (N, 11, 11)
    patch_l = patch_l - patch_l[:, W_SAD, W_SAD][:, None, None]

    strip_r = _atlas_gather(
        atlas_r, oct_l,
        sv_l[:, None, None] + offs[None, :, None],
        su_r0[:, None, None] + wide[None, None, :],
    )  # (N, 11, 21)

    sads = []
    for inc in range(2 * L_SLIDE + 1):
        win = jax.lax.dynamic_slice_in_dim(strip_r, inc, 2 * W_SAD + 1, axis=2)
        win = win - win[:, W_SAD, W_SAD][:, None, None]
        sads.append(jnp.abs(patch_l - win).sum(axis=(1, 2)))
    sad = jnp.stack(sads, axis=1)  # (N, 11), index inc+5 for shift inc

    best_inc_idx = jnp.argmin(sad, axis=1)
    interior = (best_inc_idx > 0) & (best_inc_idx < 2 * L_SLIDE)
    safe_idx = jnp.clip(best_inc_idx, 1, 2 * L_SLIDE - 1)
    d1 = jnp.take_along_axis(sad, safe_idx[:, None] - 1, 1)[:, 0]
    d2 = jnp.take_along_axis(sad, safe_idx[:, None], 1)[:, 0]
    d3 = jnp.take_along_axis(sad, safe_idx[:, None] + 1, 1)[:, 0]
    denom = 2.0 * (d1 + d3 - 2.0 * d2)
    delta = jnp.where(jnp.abs(denom) > 1e-9, (d1 - d3) / denom, 2.0)
    delta_ok = (delta >= -1.0) & (delta <= 1.0)

    # reference bound check: the 21-wide strip must fit in the level
    width_l = atlas_r.widths[oct_l].astype(jnp.int32)
    bounds_ok = (su_r0 + L_SLIDE - W_SAD >= 0) & (
        su_r0 + L_SLIDE + W_SAD + 1 < width_l
    )

    best_u_r = sf_l * (
        su_r0.astype(jnp.float32)
        + (safe_idx.astype(jnp.float32) - L_SLIDE)
        + delta
    )
    disparity = xy_l[:, 0] - best_u_r
    in_range = (disparity >= min_disparity) & (disparity < max_disparity)
    disp_pos = disparity > 0
    disparity = jnp.where(disp_pos, disparity, 0.01)
    best_u_r = jnp.where(disp_pos, best_u_r, xy_l[:, 0] - 0.01)

    ok = matched & interior & delta_ok & bounds_ok & in_range & valid_l
    # upstream ORB-SLAM2 median-SAD cut: drop matches with SAD distance
    # greater than 1.5 * 1.4 * median (port collects but never applies it)
    if sad_median_filter:
        sad_best = d2
        big = jnp.where(ok, sad_best, jnp.nan)
        med = jnp.nanmedian(big)
        ok = ok & (sad_best <= 2.1 * med)

    u_right = jnp.where(ok, best_u_r, -1.0)
    depth = jnp.where(ok, bf / disparity, -1.0)
    return u_right, depth
