"""pyorbslam_jax — a stereo visual SLAM engine in JAX.

A from-scratch JAX/XLA re-design of the capabilities of stereo
ORB-SLAM2 (reference: M2219/pyOrbSLAM): ORB pyramid feature extraction,
epipolar-band stereo matching, descriptor matching, DBoW-style place
recognition, PnP/Sim3 relocalization, and motion-only/local/global bundle
adjustment plus Sim3 pose-graph optimization — all expressed as batched,
fixed-shape array programs that XLA compiles for the accelerator, with
multi-device scale-out via `jax.sharding` + `shard_map` collectives.

Design stance (see SURVEY.md §7):
  * Arrays, not objects: SoA stores with validity masks everywhere.
  * Batched hypotheses, not sequential RANSAC.
  * One batched Levenberg-Marquardt engine instead of a graph library,
    with Schur-complement landmark marginalization done as dense/CG
    linear algebra on device.
  * Host keeps only pointer-chasing bookkeeping (covisibility graph,
    inverted file); all dense numeric work runs on the device.
"""

__version__ = "0.1.0"

import os as _os


def compile_cache_dir() -> str:
    """Where JAX's persistent compilation cache lives:
    ``$JAX_COMPILATION_CACHE_DIR`` if set, else ``<checkout>/.jax_cache``
    (a fixed path, so every process of one checkout hits the same cache)."""
    return _os.environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache")


import jax as _jax  # noqa: E402

_jax.config.update("jax_compilation_cache_dir", compile_cache_dir())

from pyorbslam_jax.config import SlamConfig, load_settings  # noqa: E402,F401
