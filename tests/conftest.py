"""Test configuration: JAX on the CPU with 8 virtual devices, so the
sharding tests exercise multi-device paths without a GPU mesh.

``JAX_PLATFORMS`` defaults to ``cpu`` here; tests marked ``gpu`` compare
the card with the host CPU and run only when it is set to include the
GPU (``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/ -n 0``).  Whether
a card is present is decided inside the ``gpu_device`` fixture, never at
import time: every xdist worker must collect the same tests.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


@pytest.fixture
def gpu_device():
    """JAX's default device if it is a GPU; skip the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (default device platform: {dev.platform})")
    return dev


@pytest.fixture(scope="session")
def data_cache_dir():
    path = os.path.join(os.path.dirname(__file__), "_data")
    os.makedirs(path, exist_ok=True)
    return path


@pytest.fixture(scope="session")
def synth_seq(data_cache_dir):
    """A short synthetic stereo sequence shared across integration tests."""
    from pyorbslam_jax.io.synthetic import generate_sequence

    return generate_sequence(
        n_frames=60, width=512, height=160, trajectory="straight",
        speed=0.8, seed=3, cache_dir=data_cache_dir,
    )


@pytest.fixture(scope="session")
def full_loop_run(data_cache_dir):
    """One full-circle System run shared by the turning and loop-closure
    integration tests (the most expensive fixture in the suite)."""
    from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
    from pyorbslam_jax.io.synthetic import generate_sequence
    from pyorbslam_jax.slam.system import System

    # laps > 1: the revisit dwells past the start so loop closure has
    # several strong same-place keyframe pairs to work with (a 1.0-lap
    # sequence ends the moment the loop becomes closable)
    seq = generate_sequence(
        n_frames=92, width=512, height=160, trajectory="loop",
        seed=11, laps=1.15, cache_dir=data_cache_dir,
    )
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=512, height=160, bf=seq.bf, th_depth=40.0,
        ),
        orb=OrbConfig(n_features=1000),
    )
    sysm = System(cfg)
    for i in range(seq.left.shape[0]):
        sysm.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
    return sysm, seq
