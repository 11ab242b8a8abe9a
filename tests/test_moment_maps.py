"""Moment-map orientation must equal the reference patch-gather form."""

import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.io.synthetic import make_texture
from pyorbslam_jax.ops import orb_descriptor as dsc
from pyorbslam_jax.ops import pyramid as pyr


class TestMomentMaps:
    def test_matches_patch_gather_form(self):
        img = jnp.asarray(make_texture(512, seed=9)[:240, :320], jnp.float32)
        padded = pyr.reflect_pad(img, dsc.BORDER)
        rng = np.random.default_rng(0)
        xy = np.stack([
            rng.integers(20, 300, 200), rng.integers(20, 220, 200)
        ], 1).astype(np.int32)

        ang_ref = np.asarray(dsc.ic_angle(padded, jnp.asarray(xy)))
        m10, m01 = dsc.moment_maps(padded)
        ang_fast = np.asarray(dsc.ic_angle_from_maps(m10, m01, jnp.asarray(xy)))

        d = np.abs(((ang_fast - ang_ref) + 180) % 360 - 180)
        assert d.max() < 0.1, f"max angle diff {d.max()} deg"

    def test_ic_angles_at_full_canvas_width(self):
        """ic_angles_at (row-cumsum form) vs the reference patch-gather
        form at atlas-canvas widths, where cumsum(col*I) magnitude
        stresses float32 resolution — keypoints at large x are the
        worst case (orb_descriptor.py ic_angles_at)."""
        rng = np.random.default_rng(3)
        img = jnp.asarray(rng.integers(0, 256, (200, 2500)), jnp.float32)
        padded = pyr.reflect_pad(img, dsc.BORDER)
        xy = np.stack([
            np.concatenate([rng.integers(16, 2480, 300),
                            rng.integers(2300, 2480, 100)]),
            np.concatenate([rng.integers(16, 180, 300),
                            rng.integers(16, 180, 100)]),
        ], 1).astype(np.int32)

        ang_ref = np.asarray(dsc.ic_angle(padded, jnp.asarray(xy)))
        # ic_angles_at addresses the padded canvas directly
        ang_at = np.asarray(dsc.ic_angles_at(
            padded, jnp.asarray(xy + dsc.BORDER)))

        d = np.abs(((ang_at - ang_ref) + 180) % 360 - 180)
        # random-noise patches are the worst case (near-zero centroids);
        # centered column weights hold max error ~0.5-0.8 deg vs ~4 deg
        # uncentered — far below the 12-deg BRIEF rotation quantum
        assert d.max() < 1.0, f"max angle diff {d.max()} deg"
        assert np.median(d) < 0.05, f"median angle diff {np.median(d)} deg"
