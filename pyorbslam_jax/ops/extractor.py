"""The full per-level ORB extractor: pyramid -> FAST -> spread -> orient -> rBRIEF.

First-class replacement for the reference's C++ extractor
(pyORBExtractor/ORBextractor.cpp operator_kd:1042-1104), redesigned as a
fixed-shape array program: every level contributes exactly its geometric
feature budget worth of (possibly invalid/padded) slots, so the output
shape is static and the whole extraction jits into one XLA program.
Stereo pairs batch through via vmap (both images share a resolution), so
left+right extraction is a single device dispatch per frame.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.config import OrbConfig
from pyorbslam_jax.ops import fast as fast_ops
from pyorbslam_jax.ops import orb_descriptor as desc_ops
from pyorbslam_jax.ops import pyramid as pyr_ops

DETECT_BORDER = 16  # EDGE_THRESHOLD - 3: min distance of a corner to the level edge


class FrameFeatures(NamedTuple):
    """SoA keypoint store for one image (fixed capacity, padded)."""

    xy: jnp.ndarray        # (N, 2) float32, level-0 pixel coords (x, y)
    response: jnp.ndarray  # (N,) float32 FAST corner strength
    angle: jnp.ndarray     # (N,) float32 degrees [0, 360)
    octave: jnp.ndarray    # (N,) int32 pyramid level
    desc: jnp.ndarray      # (N, 8) uint32 packed 256-bit rBRIEF
    valid: jnp.ndarray     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]


def _pad_axis0(arr: jnp.ndarray, total: int):
    pad = total - arr.shape[0]
    if pad <= 0:
        return arr[:total]
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return jnp.pad(arr, widths)


def extract_features(img: jnp.ndarray, orb: OrbConfig,
                     levels=None) -> FrameFeatures:
    """img: float32 (H, W) in [0, 255] -> FrameFeatures with capacity
    ``orb.max_keypoints``.  Pass prebuilt pyramid ``levels`` to share it
    with downstream consumers (stereo SAD atlas)."""
    if levels is None:
        levels = pyr_ops.build_pyramid(img, orb.scale_factor, orb.n_levels)
    budgets = orb.features_per_level
    scale_factors = orb.scale_factors

    all_xy, all_resp, all_ang, all_oct, all_desc, all_valid = [], [], [], [], [], []
    for l, level_img in enumerate(levels):
        score = fast_ops.fast_score_map(level_img)
        score = fast_ops.border_mask(score, DETECT_BORDER)
        score = fast_ops.cell_fallback_mask(
            score, float(orb.ini_th_fast), float(orb.min_th_fast), orb.cell_size
        )
        score = fast_ops.nms3x3(score)
        xy, resp, valid = fast_ops.select_keypoints(
            score, int(budgets[l]), orb.bucket_size, orb.per_bucket_cap
        )
        padded_raw = pyr_ops.reflect_pad(level_img, desc_ops.BORDER)
        m10_map, m01_map = desc_ops.moment_maps(padded_raw)
        ang = desc_ops.ic_angle_from_maps(m10_map, m01_map, xy)
        blurred = pyr_ops.gaussian_blur(level_img)
        padded_blur = pyr_ops.reflect_pad(blurred, desc_ops.BORDER)
        d = desc_ops.brief_descriptors(padded_blur, xy, ang)

        all_xy.append(xy.astype(jnp.float32) * jnp.float32(scale_factors[l]))
        all_resp.append(resp)
        all_ang.append(ang)
        all_oct.append(jnp.full((xy.shape[0],), l, jnp.int32))
        all_desc.append(d)
        all_valid.append(valid)

    cap = orb.max_keypoints
    xy = _pad_axis0(jnp.concatenate(all_xy), cap)
    resp = _pad_axis0(jnp.concatenate(all_resp), cap)
    ang = _pad_axis0(jnp.concatenate(all_ang), cap)
    oct_ = _pad_axis0(jnp.concatenate(all_oct), cap)
    desc = _pad_axis0(jnp.concatenate(all_desc), cap)
    valid = _pad_axis0(jnp.concatenate(all_valid), cap)
    return FrameFeatures(
        xy=xy, response=resp, angle=ang, octave=oct_, desc=desc, valid=valid
    )


@functools.partial(jax.jit, static_argnums=(1,))
def extract_features_jit(img: jnp.ndarray, orb: OrbConfig) -> FrameFeatures:
    return extract_features(img, orb)


@functools.partial(jax.jit, static_argnums=(2,))
def extract_stereo_jit(
    left: jnp.ndarray, right: jnp.ndarray, orb: OrbConfig
) -> Tuple[FrameFeatures, FrameFeatures]:
    """Batch left+right through one vmapped extraction."""
    both = jnp.stack([left, right])
    feats = jax.vmap(lambda im: extract_features(im, orb))(both)
    left_f = jax.tree_util.tree_map(lambda a: a[0], feats)
    right_f = jax.tree_util.tree_map(lambda a: a[1], feats)
    return left_f, right_f
