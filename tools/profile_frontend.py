"""Device time of the ORB frontend stages at full width, from a trace.

Traces ``build_stereo_frame`` (1241x376, 2000 features, 8 levels: both
images' extraction plus stereo matching) on the GPU and attributes every
device kernel to the named scopes of ``ops/atlas.py`` through the
compiled HLO's ``op_name`` metadata: ``fast_score`` (FAST-9/16 score map)
and ``brief`` (steered rBRIEF sampling).  Prints one JSON line with the
per-frame device time of each, the whole frame's kernel time, its wall
time, and the card's name and power limit.

    python tools/profile_frontend.py [--iters 20] [--trace-dir DIR]
"""

import argparse
import collections
import dataclasses
import functools
import glob
import json
import os
import re
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SCOPES = ("fast_score", "brief")


def kernel_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> set of named scopes (from ``SCOPES``) found
    in its own ``op_name`` metadata or in that of any instruction of the
    computation it calls (a fusion's body)."""
    comp_scopes = collections.defaultdict(set)
    inst_scopes = {}
    calls = {}
    comp = None
    for line in hlo_text.splitlines():
        m = re.match(r"\s*(?:ENTRY\s+)?%?([\w.\-]+)\s.*\{\s*$", line)
        if m and "=" not in line.split("{")[0]:
            comp = m.group(1)
            continue
        m = re.match(r"\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=", line)
        if not m:
            continue
        name = m.group(1)
        found = set()
        op = re.search(r'op_name="([^"]*)"', line)
        if op:
            found = {s for s in SCOPES if f"/{s}/" in op.group(1) + "/"}
        inst_scopes[name] = found
        if comp is not None:
            comp_scopes[comp] |= found
        c = re.search(r"calls=%?([\w.\-]+)", line)
        if c:
            calls[name] = c.group(1)
    # kernel names are the HLO names with '.' and '-' made '_'
    return {re.sub(r"[.\-]", "_", n): s | comp_scopes.get(calls.get(n, ""),
                                                         set())
            for n, s in inst_scopes.items()}


def scope_of(kernel: str, scopes: dict):
    """Scopes of a device kernel: its own HLO name, else the name with
    trailing ``_<n>`` suffixes stripped (one HLO op can launch several
    kernels: ``sort_8_1__2`` belongs to ``sort.8``); None if unknown."""
    key = kernel
    while key not in scopes:
        m = re.match(r"(.*?)_{1,2}\d+$", key)
        if m is None:
            return None
        key = m.group(1)
    return scopes[key]


def device_events(trace_dir: str):
    """(kernel name, duration_ns) of every event on a GPU plane."""
    import jax

    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        raise RuntimeError(f"no trace under {trace_dir}")
    prof = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    out = []
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                out.append((ev.name, ev.duration_ns))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from pyorbslam_jax.config import SlamConfig
    from pyorbslam_jax.io.synthetic import generate_sequence
    from pyorbslam_jax.slam.frame import build_stereo_frame
    from pyorbslam_jax.utils import parity

    dev = parity.require_gpu()
    card = parity.card_name_and_power().splitlines()[0]
    cfg = SlamConfig.from_yaml(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "KITTI00-02.yaml"))
    w, h = cfg.camera.width, cfg.camera.height
    seq = generate_sequence(n_frames=1, width=w, height=h,
                            baseline=cfg.camera.bf / (0.58 * w),
                            trajectory="straight", speed=0.8, seed=3)
    K = seq.K
    cfg = dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, fx=float(K[0, 0]), fy=float(K[1, 1]),
        cx=float(K[0, 2]), cy=float(K[1, 2])))
    left, right = jnp.asarray(seq.left[0]), jnp.asarray(seq.right[0])

    compiled = jax.jit(functools.partial(build_stereo_frame, cfg=cfg)).lower(
        left, right).compile()
    scopes = kernel_scopes(compiled.as_text())
    jax.block_until_ready(compiled(left, right))

    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = compiled(left, right)
    jax.block_until_ready(out)
    wall = (time.perf_counter() - t0) / args.iters

    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="frontend_trace_")
    with jax.profiler.trace(trace_dir):
        for _ in range(args.iters):
            out = compiled(left, right)
        jax.block_until_ready(out)
    events = device_events(trace_dir)

    per_scope = collections.Counter()
    per_kernel = collections.Counter()
    unmatched = 0
    total = 0
    for name, dur in events:
        total += dur
        sc = scope_of(name, scopes)
        if sc is None:
            sc = set()
            unmatched += 1
        for s in sc:
            per_scope[s] += dur
        per_kernel[(name, ",".join(sorted(sc)))] += dur
    n = args.iters
    print(json.dumps({
        "what": "build_stereo_frame device time per frame",
        "device": {"platform": dev.platform, "kind": dev.device_kind},
        "card": card,
        "config": f"{w}x{h}, {cfg.orb.n_features} features, "
                  f"{cfg.orb.n_levels} levels",
        "iters": n,
        "wall_ms_per_frame": wall * 1e3,
        "kernel_ms_per_frame": total / n / 1e6,
        "fast_score_ms_per_frame": per_scope["fast_score"] / n / 1e6,
        "brief_ms_per_frame": per_scope["brief"] / n / 1e6,
        "n_device_events": len(events),
        "n_events_unmatched_to_hlo": unmatched,
        "top_kernels_ms_per_frame": [
            [k[0], k[1], v / n / 1e6] for k, v in per_kernel.most_common(15)],
    }))


if __name__ == "__main__":
    main()
