"""Scaling report: distributed global BA + essential-graph solve at 1/2/4/8
virtual devices (CPU mesh), plus the single-chip numbers on whatever real
accelerator is present.

The report measures the System's OWN distributed path (SlamMap._run_ba
engine="dist" over parallel/dist_ba.py) on one fixed synthetic problem:
same map, growing mesh.  Writes one JSON line per configuration.

    python tools/scaling_report.py [--devices 1 2 4 8] [--cams 128]
        [--points 32768] [--obs-per-cam 1024]

Must run on CPU with XLA_FLAGS=--xla_force_host_platform_device_count=8
to get a virtual mesh; the tool sets this up itself when --cpu is given.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--cams", type=int, default=128)
    ap.add_argument("--points", type=int, default=32768)
    ap.add_argument("--obs-per-cam", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count="
                f"{max(args.devices)}").strip()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from pyorbslam_jax.optim.ba import BAProblem
    from pyorbslam_jax.parallel import dist_ba

    rng = np.random.default_rng(0)
    C, Pn = args.cams, args.points
    fx, cx, cy, bf = 718.0, 607.0, 185.0, 386.0
    pts = np.stack([
        rng.uniform(-20, 20, Pn), rng.uniform(-3, 3, Pn),
        rng.uniform(4, 60, Pn)], 1).astype(np.float32)
    cams = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    cams[:, 0, 3] = -0.4 * np.arange(C)

    obs_cam, obs_pnt = [], []
    for c in range(C):
        ids = rng.choice(Pn, args.obs_per_cam, replace=False)
        obs_cam.append(np.full(args.obs_per_cam, c, np.int32))
        obs_pnt.append(ids.astype(np.int32))
    obs_cam = np.concatenate(obs_cam)
    obs_pnt = np.concatenate(obs_pnt)
    Pc = np.einsum("oij,oj->oi", cams[obs_cam, :3, :3], pts[obs_pnt]) \
        + cams[obs_cam, :3, 3]
    z = np.maximum(Pc[:, 2], 0.5)
    u = fx * Pc[:, 0] / z + cx
    v = fx * Pc[:, 1] / z + cy
    obs_uvr = np.stack([u, v, u - bf / z], 1).astype(np.float32)

    noisy = pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)

    for nd in args.devices:
        if nd > len(jax.devices()):
            print(json.dumps({"metric": "dist_ba_step_time_s",
                              "devices": nd, "skipped": "not enough devices"}))
            continue
        mesh = dist_ba.make_mesh(nd)
        new_pnt, (oc, ouvr), active = \
            dist_ba.group_observations_by_point_shard(
                obs_pnt, Pn, nd, (obs_cam, obs_uvr))
        prob = BAProblem(
            cam_Tcw=jnp.asarray(cams),
            cam_fixed=jnp.asarray(np.arange(C) == 0),
            pnt_pos=jnp.asarray(noisy),
            pnt_active=jnp.ones(Pn, bool),
            obs_cam=jnp.asarray(oc),
            obs_pnt=jnp.asarray(new_pnt),
            obs_uvr=jnp.asarray(ouvr),
            obs_inv_sigma2=jnp.ones(len(oc), jnp.float32),
            obs_active=jnp.asarray(active),
            cam=jnp.asarray([fx, fx, cx, cy, bf], jnp.float32),
        )
        sharded = dist_ba.shard_problem(prob, mesh)
        run = lambda: dist_ba.distributed_bundle_adjust(
            sharded, mesh, n_cam=C, iters1=args.iters // 2,
            iters2=args.iters - args.iters // 2)
        out = run()
        out[0].block_until_ready()          # compile + warm
        t0 = time.time()
        out = run()
        out[0].block_until_ready()
        dt = time.time() - t0
        err = float(np.abs(np.asarray(out[1]) - pts).mean())
        print(json.dumps({
            "metric": "dist_ba_step_time_s", "devices": nd,
            "value": round(dt, 4), "cams": C, "points": Pn,
            "obs": len(oc), "iters": args.iters,
            "mean_point_err": round(err, 4),
            "backend": jax.devices()[0].platform,
        }), flush=True)


if __name__ == "__main__":
    main()
