"""Multi-host (multi-process) runtime for the multi-host deployment shape.

SURVEY §2.3 / BASELINE config 5: keyframe + landmark blocks are
partitioned per host; local/global BA and the Sim3 pose graph run as
batched solves with ``psum``/``all_gather`` collectives over the
devices of a host and the network between hosts.  The single-process engines
(parallel/dist_ba.py, parallel/dist_pose_graph.py) run UNCHANGED over a
multi-process global mesh — XLA inserts cross-host collectives wherever
the mesh spans processes — so the multi-host story is an initialization
concern, not a second code path.

Multi-host behavior is testable without accelerators (SURVEY §4): multi-process CPU JAX
forms a global mesh from N local processes.  ``tools/multihost_dryrun.py``
drives the distributed BA + pose-graph engines across real process
boundaries that way and records the agreement against the single-process
result.

Reference parity note: the reference has NO distributed story (its
concurrency is a 4-thread shared-memory pipeline, Map.py:7 mutex
discipline); this module is the multi-device scale-out the north star
requires (1 chip / 1 host / N>=2 hosts).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def initialize(coordinator_address: str, num_processes: int,
               process_id: int,
               local_device_ids: Optional[Sequence[int]] = None) -> None:
    """``jax.distributed.initialize`` with the arguments every backend
    needs.  Must run BEFORE any other jax call in the process.

    On a GPU cluster each host calls this with the coordinator address,
    the process count and its own process id; on CPU, set ``JAX_PLATFORMS=cpu`` and optionally
    ``XLA_FLAGS=--xla_force_host_platform_device_count=K`` before import
    to model K chips per host.
    """
    import jax

    # On CPU the host-platform device-count flag is only honored when
    # the platform choice is ALSO pinned through jax.config (observed on
    # jax 0.9: env JAX_PLATFORMS alone leaves the forced device count
    # ignored under jax.distributed).
    if os.environ.get("JAX_PLATFORMS", "") == "cpu":
        jax.config.update("jax_platforms", "cpu")

    kwargs = dict(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    if local_device_ids is not None:
        kwargs["local_device_ids"] = list(local_device_ids)
    jax.distributed.initialize(**kwargs)


def is_multiprocess() -> bool:
    import jax

    return jax.process_count() > 1


def global_mesh(axis: str = "map"):
    """1-D mesh over every device in the job (all hosts).  Device order
    is process-major, so contiguous shards land on the same host and the
    per-iteration ``psum`` tree reduces within hosts before crossing
    hosts."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), axis_names=(axis,))


def dryrun_env(n_local_devices: int) -> dict:
    """Environment for a CPU worker process modeling one host with
    ``n_local_devices`` chips (set before the interpreter imports jax)."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = env.get("XLA_FLAGS", "")
    flags = " ".join(f for f in flags.split()
                     if "host_platform_device_count" not in f)
    env["XLA_FLAGS"] = (
        f"{flags} --xla_force_host_platform_device_count={n_local_devices}"
    ).strip()
    return env
