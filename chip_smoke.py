"""On-card smoke run of the stereo SLAM engine.

Drives the engine's main path once on one NVIDIA GPU through the entry
points a user calls — ``System.track_stereo_async`` (pipelined schedule)
and ``System.track_stereo`` (synchronous schedule) over a rendered
1241x376 stereo sequence with the KITTI 00-02 settings (2000 ORB
features, 8 levels, scale 1.2) — compares the card with the host CPU on
identical inputs, and prints as its last line

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

It exits non-zero, without that line, when JAX's default device is not a
GPU or when any phase fails.

    python chip_smoke.py                # one card, every phase below
    python chip_smoke.py --four-cards   # the 4-card mesh path only

Phases (one card): device, render, compile, parity, pipeline, loop.
Phases (--four-cards): device, dist_ba, dist_pose_graph.
"""

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SETTINGS = os.path.join(HERE, "configs", "KITTI00-02.yaml")


def _env(four_cards: bool) -> None:
    """Before JAX starts: one visible card unless the 4-card path was
    asked for (with several cards visible, SlamMap.global_ba would switch
    engines), and keep the host CPU backend for the parity reference."""
    if not four_cards:
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"


class Run:
    """Phase runner: times each phase, records failures, never swallows
    one into a passing exit."""

    def __init__(self):
        self.card = "?"
        self.failed = []

    def stamp(self, secs: float) -> str:
        return f"{secs:.3f} s [{self.card}]"

    def phase(self, name, fn, *args):
        print(f"== {name}", flush=True)
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception:
            traceback.print_exc()
            self.failed.append(name)
            print(f"== {name} FAILED after "
                  f"{self.stamp(time.perf_counter() - t0)}", flush=True)
            return None
        print(f"== {name} ok in {self.stamp(time.perf_counter() - t0)}",
              flush=True)
        return out


def show(label: str, rep: dict) -> None:
    print(f"{label}: {json.dumps(rep, sort_keys=True)}", flush=True)


def check(kind: str, rep: dict) -> None:
    from pyorbslam_jax.utils import parity

    bad = parity.failures(kind, rep)
    if bad:
        raise AssertionError("; ".join(bad))


# ---------------------------------------------------------------------------


def phase_device(run: Run, four_cards: bool):
    import shutil
    import subprocess

    import jax

    import pyorbslam_jax
    from pyorbslam_jax.utils import parity

    dev = parity.require_gpu()
    devs = jax.devices()
    print(f"platform={dev.platform} device_kind={dev.device_kind} "
          f"count={len(devs)}")
    run.card = parity.card_name_and_power()
    print(run.card)
    run.card = run.card.splitlines()[0]
    print(f"jax {jax.__version__}; compile cache "
          f"{jax.config.jax_compilation_cache_dir} "
          f"(rule: {pyorbslam_jax.compile_cache_dir()})")
    want = 4 if four_cards else 1
    if len(devs) != want:
        raise RuntimeError(f"{len(devs)} devices visible, want {want}")
    cpu = jax.devices("cpu")[0]
    print(f"host reference device: {cpu}")
    if four_cards:
        return dev, cpu

    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found: the native map core cannot build")
    ver = subprocess.run([gxx, "--version"], capture_output=True, text=True)
    print(f"g++: {gxx} ({ver.stdout.splitlines()[0]})")
    from pyorbslam_jax.native import build as native_build
    from pyorbslam_jax.native import mapcore_ffi

    t0 = time.perf_counter()
    native_build.build(verbose=True)
    mapcore_ffi._load()
    print(f"native map core built and loaded: {mapcore_ffi._SO} "
          f"in {time.perf_counter() - t0:.3f} s (host)")
    return dev, cpu


def phase_render(n_frames: int, width: int, height: int, bf: float):
    """The bench's 66-frame straight sequence (seed 3, 0.8 m/frame), with
    the stereo baseline set so that fx * baseline is the settings' bf."""
    from pyorbslam_jax.io.synthetic import generate_sequence

    fx = 0.58 * width       # generate_sequence's intrinsics
    t0 = time.perf_counter()
    seq = generate_sequence(
        n_frames=n_frames, width=width, height=height, baseline=bf / fx,
        trajectory="straight", speed=0.8, seed=3)
    print(f"rendered {n_frames} stereo pairs {width}x{height} with the "
          f"numpy renderer in {time.perf_counter() - t0:.3f} s (host, set-up)")
    return seq


def make_cfg(seq):
    """KITTI 00-02 settings (features, levels, scale, bf, ThDepth); the
    intrinsics are the rendered camera's."""
    from pyorbslam_jax.config import SlamConfig

    cfg = SlamConfig.from_yaml(SETTINGS)
    K = seq.K
    cam = dataclasses.replace(
        cfg.camera, fx=float(K[0, 0]), fy=float(K[1, 1]),
        cx=float(K[0, 2]), cy=float(K[1, 2]),
        width=seq.left.shape[2], height=seq.left.shape[1])
    return dataclasses.replace(cfg, camera=cam)


def phase_compile(run: Run, seq, cfg):
    import functools

    import jax
    import jax.numpy as jnp

    import __graft_entry__
    from pyorbslam_jax.slam.frame import StereoFrame
    from pyorbslam_jax.slam.tracking import vo_track_frame

    n = cfg.orb.max_keypoints
    prev = StereoFrame.empty(n)
    eye = jnp.eye(4, dtype=jnp.float32)
    step = jax.jit(functools.partial(vo_track_frame, cfg=cfg))
    args = (jnp.asarray(seq.left[0]), jnp.asarray(seq.right[0]), prev, eye, eye)
    t0 = time.perf_counter()
    compiled = step.lower(*args).compile()
    print(f"fused per-frame step ({seq.left.shape[2]}x{seq.left.shape[1]}, "
          f"{cfg.orb.n_features} features, capacity {n}) compiled in "
          f"{run.stamp(time.perf_counter() - t0)} (set-up)")
    print(f"memory_analysis: {compiled.memory_analysis()}")
    frame, Tcw, n_in = compiled(*args)
    frame, Tcw, n_in = compiled(jnp.asarray(seq.left[1]),
                                jnp.asarray(seq.right[1]), frame, eye, eye)
    n_kp = int(np.asarray(frame.valid).sum())
    n_st = int((np.asarray(frame.depth) > 0).sum())
    print(f"frame 1: {n_kp} keypoints, {n_st} with stereo depth, "
          f"{int(n_in)} inliers tracking frame 0")
    if not (np.isfinite(np.asarray(Tcw)).all()
            and n_kp > 0.75 * cfg.orb.n_features and n_st > 0.25 * n_kp):
        raise AssertionError("fused step output is not sane")

    fn, eargs = __graft_entry__.entry()
    t0 = time.perf_counter()
    ecomp = jax.jit(fn).lower(*eargs).compile()
    print(f"__graft_entry__.entry() compiled in "
          f"{run.stamp(time.perf_counter() - t0)} (set-up)")
    out = [np.asarray(o) for o in ecomp(*eargs)]
    print(f"entry outputs: {[o.shape for o in out]}")
    if not all(np.isfinite(o).all() for o in out):
        raise AssertionError("entry() output not finite")


def phase_parity(run: Run, seq, cfg, gpu, cpu):
    from pyorbslam_jax.utils import parity

    bad = []
    rep = parity.frame_parity(seq.left[0], seq.right[0], cfg, gpu, cpu)
    show("frame features gpu vs cpu (1241x376 pair 0)", rep)
    bad += parity.failures("frame", rep)
    rep = parity.hamming_parity(gpu, 2048, 2048)
    show("hamming_matrix gpu vs numpy popcount", rep)
    bad += parity.failures("hamming", rep)
    rep = parity.pose_parity(gpu, cpu)
    show("motion-only pose optimisation gpu vs cpu", rep)
    bad += parity.failures("pose", rep)
    rep = parity.local_ba_parity(gpu, cpu)
    show("local BA (grid engine) gpu vs cpu", rep)
    bad += parity.failures("local_ba", rep)

    # TF32 probe: triangulation of frames 0 and 4 with ground-truth poses
    fa = parity.stereo_frame_on(cpu, seq.left[0], seq.right[0], cfg)
    fb = parity.stereo_frame_on(cpu, seq.left[4], seq.right[4], cfg)
    rep = parity.precision_probe(
        fa, fb, np.linalg.inv(seq.poses_wc[0]), np.linalg.inv(seq.poses_wc[4]),
        cfg, gpu, cpu)
    show("triangulation gpu vs cpu, full-f32 scope vs default precision", rep)
    if bad:
        raise AssertionError("; ".join(bad))


def _run_system(cfg, seq, mode: str):
    import jax.numpy as jnp

    from pyorbslam_jax.slam.system import System

    sysm = System(cfg)
    n = seq.left.shape[0]
    t0 = time.perf_counter()
    if mode == "async":
        for i in range(n):
            sysm.track_stereo_async(jnp.asarray(seq.left[i]),
                                    jnp.asarray(seq.right[i]),
                                    seq.timestamps[i])
        sysm.flush_async()
    else:
        for i in range(n):
            sysm.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
    return sysm, time.perf_counter() - t0


def _report(run: Run, label: str, sysm, seq, secs: float) -> float:
    from pyorbslam_jax.utils.metrics import ate_rmse

    est = np.linalg.inv(sysm.corrected_trajectory())
    ate = float(ate_rmse(est, seq.poses_wc[: len(est)]))
    c = sysm.map.counters
    print(f"{label}: frames={len(sysm.trajectory)} "
          f"keyframes={int(sysm.map.keyframes.n)} "
          f"ba_accepted={c['ba.accepted_writebacks']} "
          f"ba_dropped={c['ba.rejected_writebacks']} "
          f"ate_rmse_m={ate} wall={run.stamp(secs)} (compilation included)")
    print(f"{label}: map counters {json.dumps(dict(c), sort_keys=True)}")
    stages = {k: [round(v, 3), sysm.time_counts[k]]
              for k, v in sorted(sysm.times.items(), key=lambda kv: -kv[1])}
    print(f"{label}: host stage seconds [{run.card}] {json.dumps(stages)}")
    if len(sysm.trajectory) != seq.left.shape[0]:
        raise AssertionError(f"{label}: {len(sysm.trajectory)} poses for "
                             f"{seq.left.shape[0]} frames")
    return ate


def phase_pipeline(run: Run, seq, cfg):
    sys_a, t_a = _run_system(cfg, seq, "async")
    ate_a = _report(run, "async (track_stereo_async)", sys_a, seq, t_a)
    sys_s, t_s = _run_system(cfg, seq, "sync")
    ate_s = _report(run, "sync (track_stereo)", sys_s, seq, t_s)
    for sysm in (sys_a, sys_s):
        c = sysm.map.counters
        if c["ba.accepted_writebacks"] < 1:
            raise AssertionError("no local BA solve was accepted")
    if not ate_s < 0.15:
        raise AssertionError(f"sync ATE {ate_s} m >= 0.15 m")
    if not ate_a < max(2.0 * ate_s, 0.15):
        raise AssertionError(f"async ATE {ate_a} m >= max(2 x {ate_s}, 0.15)")


def phase_loop(run: Run):
    from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
    from pyorbslam_jax.io.synthetic import generate_sequence
    from pyorbslam_jax.slam.system import System
    from pyorbslam_jax.utils.metrics import ate_rmse

    seq = generate_sequence(n_frames=92, width=512, height=160,
                            trajectory="loop", seed=11, laps=1.15)
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=512, height=160, bf=seq.bf, th_depth=40.0),
        orb=OrbConfig(n_features=1000))
    sysm = System(cfg)
    t0 = time.perf_counter()
    for i in range(seq.left.shape[0]):
        sysm.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
    secs = time.perf_counter() - t0
    lc = sysm.loop_closer
    c = sysm.map.counters
    est = np.linalg.inv(sysm.corrected_trajectory())
    ate = float(ate_rmse(est, seq.poses_wc[: len(est)]))
    print(f"loop world (92 frames 512x160, laps 1.15, seed 11): "
          f"closed={lc.n_loops_closed} rejected={lc.n_loops_rejected} "
          f"keyframes={int(sysm.map.keyframes.n)} ate_rmse_m={ate} "
          f"wall={run.stamp(secs)} (compilation included)")
    print(f"loop world map counters {json.dumps(dict(c), sort_keys=True)}")
    if lc.n_loops_closed < 1:
        raise AssertionError("no loop closure accepted")
    if sum(v for k, v in c.items() if k.startswith("pose_graph.")) < 1:
        raise AssertionError("the essential-graph solve never ran")
    if sum(v for k, v in c.items() if k.startswith("gba.")) < 1:
        raise AssertionError("global BA never ran")


def phase_dist_ba(run: Run):
    from pyorbslam_jax.parallel import dist_ba
    from pyorbslam_jax.utils import parity

    rep = parity.dist_ba_parity(dist_ba.make_mesh(4))
    show("distributed global BA (4 cards) vs single-device CG", rep)
    check("dist_ba", rep)


def phase_dist_pose_graph(run: Run):
    from pyorbslam_jax.parallel import dist_ba
    from pyorbslam_jax.utils import parity

    rep = parity.dist_pose_graph_parity(dist_ba.make_mesh(4))
    show("distributed essential graph (4 cards) vs single-device CG", rep)
    check("dist_pose_graph", rep)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card mesh path and its references")
    args = ap.parse_args()
    _env(args.four_cards)

    import jax

    run = Run()
    t_all = time.perf_counter()
    devs = run.phase("device", phase_device, run, args.four_cards)
    if devs is None:
        return 1
    gpu, cpu = devs
    if args.four_cards:
        run.phase("dist_ba", phase_dist_ba, run)
        run.phase("dist_pose_graph", phase_dist_pose_graph, run)
    else:
        from pyorbslam_jax.config import SlamConfig

        bf = SlamConfig.from_yaml(SETTINGS).camera.bf
        seq = run.phase("render", phase_render, 66, 1241, 376, bf)
        if seq is None:
            return 1
        cfg = make_cfg(seq)
        run.phase("compile", phase_compile, run, seq, cfg)
        run.phase("parity", phase_parity, run, seq, cfg, gpu, cpu)
        run.phase("pipeline", phase_pipeline, run, seq, cfg)
        run.phase("loop", phase_loop, run)
    for mod in ("cv2", "matplotlib"):
        if mod in sys.modules:
            print(f"{mod} was imported on this path")
            run.failed.append(f"import:{mod}")
    print(f"total {run.stamp(time.perf_counter() - t_all)}")
    if run.failed:
        print(f"FAILED phases: {run.failed}")
        return 1
    d = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": d[0].platform, "kind": d[0].device_kind,
        "count": len(d)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
