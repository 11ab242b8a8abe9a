"""Statistical parity of the JAX renderer (io/render_jax.py) against the
numpy ray-caster it ports.  Pixel-exact equality is not required (f32 vs
f64 ray math); the worlds are interchangeable for SLAM when almost every
pixel agrees to the u8 quantization step."""

import numpy as np

from pyorbslam_jax.io import synthetic
from pyorbslam_jax.io.render_jax import JaxRenderer


def test_render_jax_matches_numpy_interior():
    W, H = 320, 96
    tex = synthetic.make_texture(1024, seed=0)
    planes = synthetic.interior_loop_scene(30.0, tex_px_per_m=8.0, seed=0)
    K = np.array([[0.58 * W, 0, W / 2.0],
                  [0, 0.58 * W, H / 2.0 - 4.0],
                  [0, 0, 1.0]])
    poses = synthetic.loop_trajectory(40, radius=30.0, laps=1.0)
    r = JaxRenderer(planes, tex)
    fracs, medians = [], []
    for i in (0, 13, 27):
        Twc = poses[i]
        ref = synthetic._to_u8(synthetic.render_view(
            Twc, K, W, H, planes, tex))
        got = r.render(Twc, K, W, H)
        assert got.shape == ref.shape and got.dtype == np.uint8
        d = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        medians.append(np.median(d))
        fracs.append((d > 2).mean())
    # almost all pixels within the quantization step; the tiny residual
    # is borderline hits / mip-level flips at plane edges
    assert max(medians) <= 1.0, medians
    assert max(fracs) < 0.02, fracs
