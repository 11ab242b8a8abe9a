"""Vectorized FAST-9/16 corner detection with per-cell threshold fallback.

Replaces the reference's per-cell OpenCV FAST calls (ORBextractor.cpp
ComputeKeyPointsOctTree:764-852: 30px cells, threshold 20 falling back to 7
for empty cells).  Instead of looping over cells, the whole level is
evaluated at once as whole-image elementwise passes:

  * the corner *score* map (OpenCV's corner strength: the largest
    threshold at which the pixel remains a FAST-9 corner, i.e. the max
    over 9-long contiguous arcs of the min arc-wise |p_i - p|) is
    threshold-independent, so it is computed once;
  * the high/low thresholds become two masks of the same score map, and
    the per-cell fallback is a block-reduce: a cell that contains no
    high-threshold corner admits its low-threshold corners;
  * 3x3 non-max suppression is a reduce-window max comparison.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

# Bresenham circle of radius 3, OpenCV pixel order (x right, y down).
CIRCLE_OFFSETS = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2),
        (-1, 3),
    ],
    dtype=np.int32,
)  # (dx, dy)

ARC_LEN = 9


def fast_score_map(img: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel FAST-9 corner strength (0 where not a corner at any
    threshold > 0).  img: float32 (H, W) in [0, 255]."""
    h, w = img.shape
    pad = jnp.pad(img, 3, mode="edge")

    # d[i] = p_circle_i - p_center for the 16 circle offsets
    diffs = []
    for dx, dy in CIRCLE_OFFSETS:
        shifted = jax.lax.dynamic_slice(pad, (3 + int(dy), 3 + int(dx)), (h, w))
        diffs.append(shifted - img)
    d = jnp.stack(diffs)  # (16, H, W)

    def arc_strength(vals):
        """max over 16 circular arcs of (min over the 9-long arc)."""
        # rolling min of 3, then min of three 3-mins -> min of 9
        m3 = jnp.minimum(jnp.minimum(vals, jnp.roll(vals, -1, 0)), jnp.roll(vals, -2, 0))
        m9 = jnp.minimum(jnp.minimum(m3, jnp.roll(m3, -3, 0)), jnp.roll(m3, -6, 0))
        return jnp.max(m9, axis=0)

    bright = arc_strength(d)        # > t  => bright corner at threshold t
    dark = arc_strength(-d)
    score = jnp.maximum(bright, dark)
    return jnp.maximum(score, 0.0)


def cell_fallback_mask(
    score: jnp.ndarray, ini_th: float, min_th: float, cell: int
) -> jnp.ndarray:
    """Apply the two-threshold per-cell policy -> masked score map.

    Pixels pass at ini_th everywhere; in cells where *no* pixel passes
    ini_th, pixels pass at min_th (ComputeKeyPointsOctTree fallback
    semantics)."""
    h, w = score.shape
    hc = -(-h // cell)
    wc = -(-w // cell)
    padded = jnp.pad(score, ((0, hc * cell - h), (0, wc * cell - w)))
    blocks = padded.reshape(hc, cell, wc, cell)
    cell_max = blocks.max(axis=(1, 3))                      # (hc, wc)
    has_high = cell_max > ini_th
    has_high_full = jnp.repeat(jnp.repeat(has_high, cell, 0), cell, 1)[:h, :w]
    keep = jnp.where(has_high_full, score > ini_th, score > min_th)
    return jnp.where(keep, score, 0.0)


def nms3x3(score: jnp.ndarray) -> jnp.ndarray:
    """Keep only local maxima over 3x3 neighborhoods.

    A pixel survives only if its score is *strictly* greater than all 8
    neighbors — OpenCV's FAST suppression drops both members of a tied
    plateau, and integer-valued scores tie often.
    """
    h, w = score.shape
    padded = jnp.pad(score, 1, constant_values=-jnp.inf)
    keep = score > 0.0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            neigh = jax.lax.dynamic_slice(padded, (1 + dy, 1 + dx), (h, w))
            keep &= score > neigh
    return jnp.where(keep, score, 0.0)


def border_mask(score: jnp.ndarray, border: int) -> jnp.ndarray:
    """Zero scores within ``border`` px of the level edge (reference
    restricts detection to [EDGE_THRESHOLD-3, dim-EDGE_THRESHOLD+3],
    i.e. a 16 px margin)."""
    h, w = score.shape
    ys = jnp.arange(h)[:, None]
    xs = jnp.arange(w)[None, :]
    inside = (
        (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    )
    return jnp.where(inside, score, 0.0)


def select_keypoints(
    score: jnp.ndarray,
    n_keep: int,
    bucket: int = 16,
    per_bucket_cap: int = 4,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Spatially-spread top-k keypoint selection.

    Array-friendly stand-in for the reference's sequential quadtree
    (ORBextractor.cpp DistributeOctTree:539-762): the image is divided
    into ``bucket`` px buckets, each bucket keeps at most
    ``per_bucket_cap`` strongest responses, then a global top-``n_keep``
    is taken.  Equal spatial-uniformity goal, validated at trajectory
    level (SURVEY.md §7 "hard parts").

    Returns (xy int32 (n_keep, 2) as (x, y), response (n_keep,),
    valid bool (n_keep,)).
    """
    h, w = score.shape
    hc = -(-h // bucket)
    wc = -(-w // bucket)
    padded = jnp.pad(score, ((0, hc * bucket - h), (0, wc * bucket - w)))
    blocks = padded.reshape(hc, bucket, wc, bucket).transpose(0, 2, 1, 3)
    flat_blocks = blocks.reshape(hc * wc, bucket * bucket)
    # threshold = per-bucket cap-th largest value
    kth = jax.lax.top_k(flat_blocks, per_bucket_cap)[0][:, -1]   # (hc*wc,)
    capped = jnp.where(
        flat_blocks >= jnp.maximum(kth, 1e-6)[:, None], flat_blocks, 0.0
    )
    capped_img = (
        capped.reshape(hc, wc, bucket, bucket)
        .transpose(0, 2, 1, 3)
        .reshape(hc * bucket, wc * bucket)[:h, :w]
    )

    vals, idx = jax.lax.top_k(capped_img.reshape(-1), n_keep)
    ys = idx // w
    xs = idx % w
    valid = vals > 0.0
    xy = jnp.stack([xs, ys], axis=-1).astype(jnp.int32)
    return xy, vals, valid
