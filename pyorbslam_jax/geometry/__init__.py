from pyorbslam_jax.geometry import se3, sim3  # noqa: F401
