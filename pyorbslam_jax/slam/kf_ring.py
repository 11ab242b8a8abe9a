"""Device-resident ring cache of recent keyframes' feature blocks.

Local mapping (triangulation against covisible neighbors, duplicate fuse)
repeatedly needs the per-feature arrays of RECENT keyframes on device.
The host KeyFrameStore stays authoritative, but re-uploading each
participant's features every keyframe insertion costs ~1.5 MB of
host->device copies per maintenance call.  Since keyframe features
are immutable after extraction, the System inserts every new keyframe's
device frame into this ring once, and maintenance kernels gather
neighbors by ring slot — the feature blocks never cross the boundary
again.  Keyframes that age out of the ring (beyond the last R) fall back
to the host-upload path; the covisible neighborhood of a new keyframe is
almost always inside the ring during normal operation.

This is the device-resident analog of the reference's shared-memory access to
KeyFrame objects from the LocalMapping thread (LocalMapping.py:152-308).
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.slam.frame import StereoFrame


@functools.partial(jax.jit, donate_argnums=(0,))
def _ring_insert(arrays, xy, octave, desc, ur, depth, valid, slot):
    xyA, ocA, deA, urA, dpA, vaA = arrays
    return (
        xyA.at[slot].set(xy), ocA.at[slot].set(octave),
        deA.at[slot].set(desc), urA.at[slot].set(ur),
        dpA.at[slot].set(depth), vaA.at[slot].set(valid),
    )


class DeviceKFRing:
    """Ring of the last R keyframes' feature blocks on device.

    ``arrays`` is a tuple of (R, N, ...) jnp arrays:
    (xy, octave, desc, u_right, depth, valid).
    """

    # 32 slots: at fast-motion keyframe density (~0.5 KF/frame on the
    # 2.3-lap scale run) a 16-slot ring rotated fuse targets out before
    # their maintenance pass ran, forcing ~150 fallbacks to the
    # separate-step path; 32 covers the deepest covisible target set
    # (1 + 4 tri neighbors + 8 fuse targets) with headroom.  Memory:
    # 32 x N x ~53 B ≈ 3.5 MB device-resident.
    def __init__(self, capacity: int = 32):
        self.R = capacity
        self.arrays = None
        self.slot_of: Dict[int, int] = {}
        self._kf_at = [-1] * capacity
        self._next = 0

    def reset(self):
        self.arrays = None
        self.slot_of.clear()
        self._kf_at = [-1] * self.R
        self._next = 0

    def insert(self, kf: int, frame: StereoFrame):
        n = frame.capacity
        if self.arrays is None:
            R = self.R
            self.arrays = (
                jnp.zeros((R, n, 2), jnp.float32),
                jnp.zeros((R, n), jnp.int32),
                jnp.zeros((R, n, 8), jnp.uint32),
                jnp.full((R, n), -1.0, jnp.float32),
                jnp.full((R, n), -1.0, jnp.float32),
                jnp.zeros((R, n), bool),
            )
        slot = self._next
        self._next = (self._next + 1) % self.R
        if self._kf_at[slot] >= 0:
            self.slot_of.pop(self._kf_at[slot], None)
        self.arrays = _ring_insert(
            self.arrays, frame.xy, frame.octave, frame.desc,
            frame.u_right, frame.depth, frame.valid, jnp.int32(slot),
        )
        self.slot_of[kf] = slot
        self._kf_at[slot] = kf

    def slots_for(self, kfs: List[int]) -> Optional[np.ndarray]:
        """Ring slots for the given keyframes, or None if any is absent."""
        try:
            return np.asarray([self.slot_of[k] for k in kfs], np.int32)
        except KeyError:
            return None
