"""Per-frame perception: one fused device program per stereo pair.

The reference's ``Frame`` (Frame.py:13-73) runs two C++ ORB extractions,
stereo matching, and grid assignment per frame.  Here the whole thing is a
single jitted XLA dispatch producing a fixed-shape SoA
:class:`StereoFrame`.  The reference's 64x48 feature grid
(Frame.assign_features_to_grid) exists only to make CPU radius queries
O(1); here the projection matchers compute full candidate masks with one
matmul instead, so no grid is materialized.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.config import SlamConfig
from pyorbslam_jax.ops import stereo as stereo_ops
from pyorbslam_jax.ops import pyramid as pyr_ops
from pyorbslam_jax.ops.extractor import FrameFeatures, extract_features
from pyorbslam_jax.ops.hamming import unpack_bits
from pyorbslam_jax.utils.precision import f32_matmuls


class StereoFrame(NamedTuple):
    """Device-side SoA for one tracked stereo frame (capacity N)."""

    xy: jnp.ndarray        # (N, 2) float32 level-0 keypoint coords (left)
    response: jnp.ndarray  # (N,)
    angle: jnp.ndarray     # (N,) degrees
    octave: jnp.ndarray    # (N,) int32
    desc: jnp.ndarray      # (N, 8) uint32
    desc_bits: jnp.ndarray # (N, 256) int8 unpacked (for the matmul matchers)
    valid: jnp.ndarray     # (N,) bool
    u_right: jnp.ndarray   # (N,) float32, -1 if no stereo match
    depth: jnp.ndarray     # (N,) float32, -1 if no stereo match

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    @staticmethod
    def empty(n: int) -> "StereoFrame":
        """A frame of capacity ``n`` with no valid keypoint (the
        "previous frame" of a sequence's first tracked frame)."""
        return StereoFrame(
            xy=jnp.zeros((n, 2)), response=jnp.zeros(n), angle=jnp.zeros(n),
            octave=jnp.zeros(n, jnp.int32),
            desc=jnp.zeros((n, 8), jnp.uint32),
            desc_bits=jnp.zeros((n, 256), jnp.int8), valid=jnp.zeros(n, bool),
            u_right=jnp.full(n, -1.0), depth=jnp.full(n, -1.0))


def build_stereo_frame(
    left: jnp.ndarray, right: jnp.ndarray, cfg: SlamConfig
) -> StereoFrame:
    # images may arrive as uint8 (the deployment shape: KITTI pngs are
    # 8-bit, and a u8 host->device transfer is 4x smaller than f32) —
    # all downstream ops work on f32 in [0, 255]
    if left.dtype != jnp.float32:
        left = left.astype(jnp.float32)
    if right.dtype != jnp.float32:
        right = right.astype(jnp.float32)
    orb = cfg.orb
    # build each pyramid once and share it between extraction and the
    # stereo SAD atlas (sequential extraction beats vmap here: the two
    # images' level shapes are equal but vmapped gathers/top-k lower
    # worse than the unbatched forms)
    levels_l = pyr_ops.build_pyramid(left, orb.scale_factor, orb.n_levels)
    levels_r = pyr_ops.build_pyramid(right, orb.scale_factor, orb.n_levels)
    if orb.use_atlas:
        from pyorbslam_jax.ops.atlas import extract_features_atlas

        lf, rf = extract_features_atlas(
            left, right, orb, levels_l=levels_l, levels_r=levels_r
        )
    else:
        lf: FrameFeatures = extract_features(left, orb, levels=levels_l)
        rf: FrameFeatures = extract_features(right, orb, levels=levels_r)

    atlas_l = stereo_ops.build_atlas(levels_l)
    atlas_r = stereo_ops.build_atlas(levels_r)
    scale_factors = jnp.asarray(orb.scale_factors, jnp.float32)
    u_right, depth = stereo_ops.match_stereo(
        lf.xy, lf.octave, lf.desc, lf.valid,
        rf.xy, rf.octave, rf.desc, rf.valid,
        atlas_l, atlas_r, scale_factors,
        bf=cfg.camera.bf,
        max_disparity=cfg.camera.fx,
        th_orb=(cfg.tracking.th_high + cfg.tracking.th_low) / 2.0,
    )
    return StereoFrame(
        xy=lf.xy, response=lf.response, angle=lf.angle, octave=lf.octave,
        desc=lf.desc, desc_bits=unpack_bits(lf.desc), valid=lf.valid,
        u_right=u_right, depth=depth,
    )


@functools.partial(jax.jit, static_argnums=(2,))
def build_stereo_frame_jit(
    left: jnp.ndarray, right: jnp.ndarray, cfg: SlamConfig
) -> StereoFrame:
    return build_stereo_frame(left, right, cfg)


@jax.jit
def pack_frame(frame: StereoFrame) -> jnp.ndarray:
    """Every per-feature field the host consumes, in ONE int32 buffer, so
    a keyframe snapshot crosses to the host in a single read: [xy bits 2N | angle N | u_right N | depth N |
    response N | octave N | valid N | desc 8N]."""
    def b(a):
        return jax.lax.bitcast_convert_type(a, jnp.int32)

    return jnp.concatenate([
        b(frame.xy).reshape(-1), b(frame.angle), b(frame.u_right),
        b(frame.depth), b(frame.response), frame.octave,
        frame.valid.astype(jnp.int32),
        jax.lax.bitcast_convert_type(frame.desc, jnp.int32).reshape(-1),
    ])


def unpack_frame_np(packed: np.ndarray, n: int) -> dict:
    """Host-side inverse of :func:`pack_frame` (numpy views, no copies
    except octave/valid)."""
    def f(a):
        return a.view(np.float32)

    return dict(
        xy=f(packed[: 2 * n]).reshape(n, 2),
        angle=f(packed[2 * n: 3 * n]),
        u_right=f(packed[3 * n: 4 * n]),
        depth=f(packed[4 * n: 5 * n]),
        response=f(packed[5 * n: 6 * n]),
        octave=packed[6 * n: 7 * n].copy(),
        valid=packed[7 * n: 8 * n].astype(bool),
        desc=packed[8 * n: 16 * n].view(np.uint32).reshape(n, 8),
    )


@f32_matmuls
def unproject(frame: StereoFrame, cfg: SlamConfig, Twc: jnp.ndarray) -> jnp.ndarray:
    """Back-project all stereo-matched keypoints to world coords
    (Frame.unproject_stereo, Frame.py:281-291), vectorized.  Returns
    (N, 3); rows with depth <= 0 are garbage — mask with frame.depth > 0.
    """
    cam = cfg.camera
    z = frame.depth
    x = (frame.xy[:, 0] - cam.cx) * z / cam.fx
    y = (frame.xy[:, 1] - cam.cy) * z / cam.fy
    pc = jnp.stack([x, y, z], axis=-1)
    return pc @ Twc[:3, :3].T + Twc[:3, 3]
