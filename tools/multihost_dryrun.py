"""Multi-HOST dryrun: the distributed BA + Sim3 pose-graph engines across
real process boundaries (multi-process CPU JAX), validating the
multi-host deployment shape without accelerators (SURVEY §4, BASELINE
config 5).

The parent spawns N worker processes, each modeling one host with K
virtual chips (``--xla_force_host_platform_device_count``).  Workers form
one global mesh via ``jax.distributed`` (pyorbslam_jax.parallel.multihost)
and run the SAME engines the single-process System uses —
``parallel/dist_ba.distributed_bundle_adjust_cg`` and
``parallel/dist_pose_graph.distributed_pose_graph`` — with their
collectives now crossing process boundaries (the network stand-in).  Worker 0
compares against single-device solves and the parent records
MULTIHOST_DRYRUN.json at the repo root.

    python tools/multihost_dryrun.py [--procs 4] [--local-devices 2]
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def worker(args):
    from pyorbslam_jax.parallel import multihost

    multihost.initialize(f"127.0.0.1:{args.port}", args.procs, args.worker)

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.experimental import multihost_utils

    from pyorbslam_jax.optim import ba, ba_cg
    from pyorbslam_jax.optim.pose_graph import optimize_pose_graph_cg
    from pyorbslam_jax.parallel import dist_ba, dist_pose_graph
    from tests.test_ba import make_ba_problem

    mesh = multihost.global_mesh()
    n_shards = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    assert jax.process_count() == args.procs

    # ---------------- distributed BA across hosts ----------------
    rng = np.random.default_rng(7)
    prob, T_true, pts = make_ba_problem(
        rng, n_cam=8, n_pnt=512 - 8, noise_px=0.3, pad_pnt=8)
    n_pnt = int(prob.pnt_pos.shape[0])
    assert n_pnt % n_shards == 0
    new_pnt, (oc, ouvr, oisig), active = (
        dist_ba.group_observations_by_point_shard(
            np.asarray(prob.obs_pnt), n_pnt, n_shards,
            (np.asarray(prob.obs_cam), np.asarray(prob.obs_uvr),
             np.asarray(prob.obs_inv_sigma2))))
    prob2 = prob._replace(
        obs_pnt=jnp.asarray(new_pnt), obs_cam=jnp.asarray(oc),
        obs_uvr=jnp.asarray(ouvr), obs_inv_sigma2=jnp.asarray(oisig),
        obs_active=jnp.asarray(active))
    sharded = dist_ba.shard_problem(prob2, mesh)
    t0 = time.time()
    cam_out, pnt_out, _ = dist_ba.distributed_bundle_adjust_cg(
        sharded, mesh, n_cam=int(prob.cam_Tcw.shape[0]))
    cam_np = multihost_utils.process_allgather(cam_out, tiled=True)
    ba_s = time.time() - t0

    # ---------------- distributed pose graph across hosts ----------------
    from pyorbslam_jax.geometry import se3

    C = 24
    gt, est = [], []
    for i in range(C):
        ang = 2 * np.pi * i / C
        Rwc = np.asarray(se3.exp_so3(jnp.asarray(
            np.array([0, ang, 0], np.float32))))
        Twc = np.eye(4, dtype=np.float32)
        Twc[:3, :3] = Rwc
        Twc[:3, 3] = [8 * np.sin(ang), 0, 8 * (1 - np.cos(ang))]
        gt.append(np.linalg.inv(Twc).astype(np.float32))
    est = [gt[0]]
    rng2 = np.random.default_rng(5)
    for i in range(1, C):
        rel = gt[i] @ np.linalg.inv(gt[i - 1])
        xi = np.concatenate([
            rng2.normal(0, 0.008, 3), rng2.normal(0, 0.04, 3)
        ]).astype(np.float32)
        est.append((np.asarray(se3.exp_se3(jnp.asarray(xi))) @ rel
                    @ est[-1]).astype(np.float32))
    gt, est = np.stack(gt), np.stack(est)
    e_i, e_j, mR, mt = [], [], [], []
    for i in range(C - 1):
        Sji = est[i + 1] @ np.linalg.inv(est[i])
        e_i.append(i)
        e_j.append(i + 1)
        mR.append(Sji[:3, :3])
        mt.append(Sji[:3, 3])
    loop = gt[0] @ np.linalg.inv(gt[C - 1])
    e_i.append(C - 1)
    e_j.append(0)
    mR.append(loop[:3, :3])
    mt.append(loop[:3, 3])
    fixed = np.zeros(C, bool)
    fixed[0] = True
    e_i = np.array(e_i, np.int32)
    e_j = np.array(e_j, np.int32)
    mR = np.stack(mR).astype(np.float32)
    mt = np.stack(mt).astype(np.float32)
    ms = np.ones(len(e_i), np.float32)
    act = np.ones(len(e_i), bool)
    pe = dist_pose_graph.pad_edges(n_shards, e_i, e_j, mR, mt, ms, act)
    reps, shds = dist_pose_graph.place_pose_graph(
        mesh,
        [est[:, :3, :3], est[:, :3, 3], np.ones(C, np.float32), fixed],
        list(pe))
    t0 = time.time()
    res = dist_pose_graph.distributed_pose_graph(
        mesh, *reps, *shds, cg_iters=128)
    pg_R = multihost_utils.process_allgather(res.R, tiled=True)
    pg_t = multihost_utils.process_allgather(res.t, tiled=True)
    pg_s = time.time() - t0

    if args.worker != 0:
        return

    # single-device references (local compute on this host)
    res_1 = ba_cg.bundle_adjust_cg(prob)
    cam_1 = np.asarray(res_1.cam_Tcw)
    ref = optimize_pose_graph_cg(
        jnp.asarray(est[:, :3, :3]), jnp.asarray(est[:, :3, 3]),
        jnp.ones(C, jnp.float32), jnp.asarray(fixed),
        jnp.asarray(e_i), jnp.asarray(e_j), jnp.asarray(mR),
        jnp.asarray(mt), jnp.asarray(ms), jnp.asarray(act), cg_iters=128)

    cam_err_dist = float(np.linalg.norm(
        cam_np[:8, :3, 3] - T_true[:, :3, 3], axis=1).max())
    cam_err_1dev = float(np.linalg.norm(
        cam_1[:8, :3, 3] - T_true[:, :3, 3], axis=1).max())

    def centers(Rm, tm):
        return -np.einsum("cij,cj->ci", np.transpose(Rm, (0, 2, 1)), tm)

    c_gt = centers(gt[:, :3, :3], gt[:, :3, 3])
    pg_err_dist = float(np.linalg.norm(
        centers(pg_R, pg_t) - c_gt, axis=1).max())
    pg_err_1dev = float(np.linalg.norm(
        centers(np.asarray(ref.R), np.asarray(ref.t)) - c_gt, axis=1).max())

    out = dict(
        ok=bool(cam_err_dist < 2.0 * cam_err_1dev + 1e-3
                and pg_err_dist < max(1.5 * pg_err_1dev, 0.25)),
        processes=args.procs,
        local_devices_per_process=int(len(jax.local_devices())),
        global_devices=int(jax.device_count()),
        ba_cam_err_dist=cam_err_dist,
        ba_cam_err_1dev=cam_err_1dev,
        ba_wall_s=round(ba_s, 2),
        pose_graph_center_err_dist=pg_err_dist,
        pose_graph_center_err_1dev=pg_err_1dev,
        pose_graph_wall_s=round(pg_s, 2),
    )
    with open(args.result, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--procs", type=int, default=4)
    ap.add_argument("--local-devices", type=int, default=2)
    ap.add_argument("--port", type=int, default=29711)
    ap.add_argument("--worker", type=int, default=-1)
    ap.add_argument("--result", default="/tmp/multihost_dryrun_result.json")
    ap.add_argument("--out", default=os.path.join(REPO,
                                                  "MULTIHOST_DRYRUN.json"))
    args = ap.parse_args()

    if args.worker >= 0:
        worker(args)
        return

    from pyorbslam_jax.parallel import multihost

    env = multihost.dryrun_env(args.local_devices)
    if os.path.exists(args.result):
        os.remove(args.result)
    procs = []
    t0 = time.time()
    for i in range(args.procs):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--worker", str(i), "--procs", str(args.procs),
             "--local-devices", str(args.local_devices),
             "--port", str(args.port), "--result", args.result],
            env=env))
    rcs = [p.wait(timeout=540) for p in procs]
    assert all(rc == 0 for rc in rcs), f"worker exit codes {rcs}"
    with open(args.result) as f:
        res = json.load(f)
    res["wall_s"] = round(time.time() - t0, 1)
    res["config"] = (f"{args.procs} processes x {args.local_devices} "
                     "virtual CPU devices (1 process = 1 modeled host)")
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"wrote {args.out}: ok={res['ok']}")


if __name__ == "__main__":
    main()
