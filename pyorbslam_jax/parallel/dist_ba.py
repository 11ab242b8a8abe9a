"""Distributed Schur bundle adjustment over a device mesh.

The multi-chip redesign of the reference's single-process optimizer
(SURVEY.md §2.3 "accelerator-native equivalent"): landmarks and their observations
are partitioned across devices along a 1-D ``map`` mesh axis so each
point's entire observation set lives on its owner shard.  One LM
iteration is then:

  * per shard: residuals/Jacobians for local observations; local
    landmark blocks Hpp (3x3) inverted in place; local contribution to
    the reduced camera system S = Hcc - W Hpp^-1 W^T and its rhs;
  * one ``psum`` of the (6C x 6C) reduced system across devices — the only
    communication, a few hundred KB per iteration;
  * a replicated dense solve for the camera update, then fully local
    landmark back-substitution.

Poses are replicated (C is thousands at most); this matches the
"psum of reduced camera contributions + replicated pose solve"
recipe and scales with the landmark count, which is the map's true
scaling dimension (SURVEY.md §5 long-context analog).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyorbslam_jax.geometry import se3
from pyorbslam_jax.optim import ba as ba_mod
from pyorbslam_jax.optim.ba import BAProblem
from pyorbslam_jax.optim.ba import _bmm, _bmv, _btb, _btv
from pyorbslam_jax.utils.precision import f32_matmuls

shard_map = jax.shard_map


def make_mesh(n_devices: int = 0) -> Mesh:
    devs = jax.devices()
    if n_devices:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("map",))


def shard_problem(prob: BAProblem, mesh: Mesh) -> BAProblem:
    """Place observation/point arrays sharded along ``map``; cameras
    replicated.  P and O must divide the mesh size (pad first)."""
    sh = lambda spec: NamedSharding(mesh, spec)
    return BAProblem(
        cam_Tcw=jax.device_put(prob.cam_Tcw, sh(P())),
        cam_fixed=jax.device_put(prob.cam_fixed, sh(P())),
        pnt_pos=jax.device_put(prob.pnt_pos, sh(P("map"))),
        pnt_active=jax.device_put(prob.pnt_active, sh(P("map"))),
        obs_cam=jax.device_put(prob.obs_cam, sh(P("map"))),
        obs_pnt=jax.device_put(prob.obs_pnt, sh(P("map"))),
        obs_uvr=jax.device_put(prob.obs_uvr, sh(P("map"))),
        obs_inv_sigma2=jax.device_put(prob.obs_inv_sigma2, sh(P("map"))),
        obs_active=jax.device_put(prob.obs_active, sh(P("map"))),
        cam=jax.device_put(prob.cam, sh(P())),
    )


def group_observations_by_point_shard(
    obs_pnt: np.ndarray, n_pnt: int, n_shards: int, arrays: Tuple[np.ndarray, ...],
) -> Tuple[np.ndarray, Tuple[np.ndarray, ...], np.ndarray]:
    """Reorder observations so each one lands on its point's owner shard.

    Points are block-partitioned (pnt_shard = pnt // (n_pnt // n_shards));
    observations are bucketed per shard and padded to equal length.
    Returns (new_obs_pnt, reordered arrays, active mask).
    """
    per = n_pnt // n_shards
    owner = np.minimum(obs_pnt // per, n_shards - 1)
    counts = np.bincount(owner, minlength=n_shards)
    cap = int(-(-counts.max() // 128) * 128)
    O = cap * n_shards
    new_pnt = np.zeros(O, obs_pnt.dtype)
    outs = [np.zeros((O,) + a.shape[1:], a.dtype) for a in arrays]
    active = np.zeros(O, bool)
    for s in range(n_shards):
        sel = np.nonzero(owner == s)[0]
        dst = slice(s * cap, s * cap + len(sel))
        new_pnt[dst] = obs_pnt[sel]
        for o, a in zip(outs, arrays):
            o[dst] = a[sel]
        active[dst] = True
    return new_pnt, tuple(outs), active


def _local_schur(prob: BAProblem, cam_Tcw, pnt_pos, active, lam, use_huber,
                 n_cam: int):
    """Per-shard: local blocks + local contribution to the reduced system."""
    n_pnt_local = pnt_pos.shape[0]
    e, Jc, Jp, z = ba_mod._residuals(prob, cam_Tcw, pnt_pos)
    chi2 = jnp.sum(e * e, axis=-1) * prob.obs_inv_sigma2
    w = ba_mod._huber_w(chi2, ba_mod.HUBER_DELTA) if use_huber else jnp.ones_like(chi2)
    w = w * prob.obs_inv_sigma2 * active

    Hcc = jax.ops.segment_sum(
        w[:, None, None] * _btb(Jc, Jc),
        prob.obs_cam, num_segments=n_cam)
    bc = jax.ops.segment_sum(
        w[:, None] * _btv(Jc, e), prob.obs_cam, n_cam)
    Hpp = jax.ops.segment_sum(
        w[:, None, None] * _btb(Jp, Jp),
        prob.obs_pnt, num_segments=n_pnt_local)
    bp = jax.ops.segment_sum(
        w[:, None] * _btv(Jp, e), prob.obs_pnt, n_pnt_local)

    eye3 = jnp.eye(3)
    Hpp_d = Hpp + lam * Hpp * eye3 + 1e-8 * eye3
    Hpp_inv = ba_mod._inv3x3(Hpp_d)

    W = w[:, None, None] * _btb(Jc, Jp)       # (O, 6, 3)
    WHinv = _bmm(W, Hpp_inv[prob.obs_pnt])

    A = jnp.zeros((n_cam, 6, n_pnt_local, 3)).at[prob.obs_cam, :, prob.obs_pnt, :].add(W)
    M = jnp.zeros((n_cam, 6, n_pnt_local, 3)).at[prob.obs_cam, :, prob.obs_pnt, :].add(WHinv)
    A2 = A.reshape(n_cam * 6, n_pnt_local * 3)
    M2 = M.reshape(n_cam * 6, n_pnt_local * 3)

    S_sub = jnp.dot(M2, A2.T, preferred_element_type=jnp.float32)
    rhs_sub = M2 @ bp.reshape(-1)
    return Hcc, bc, S_sub, rhs_sub, Hpp_inv, W, bp


@functools.partial(
    jax.jit, static_argnames=("mesh", "iters1", "iters2", "n_cam"))
@f32_matmuls
def distributed_bundle_adjust(
    prob: BAProblem, mesh: Mesh, n_cam: int,
    iters1: int = 5, iters2: int = 10,
):
    """Sharded two-phase Schur LM; returns (cam_Tcw replicated,
    pnt_pos sharded, obs_inlier sharded)."""

    obs_spec = P("map")
    prob_specs = BAProblem(
        cam_Tcw=P(), cam_fixed=P(), pnt_pos=P("map"), pnt_active=P("map"),
        obs_cam=obs_spec, obs_pnt=obs_spec, obs_uvr=obs_spec,
        obs_inv_sigma2=obs_spec, obs_active=obs_spec, cam=P(),
    )

    n_shards = mesh.shape["map"]
    pnt_per_shard = prob.pnt_pos.shape[0] // n_shards

    def shard_fn(p: BAProblem):
        # local observation point ids -> local point indices
        shard_id = jax.lax.axis_index("map")
        local_obs_pnt = p.obs_pnt - shard_id * pnt_per_shard
        in_shard = (local_obs_pnt >= 0) & (local_obs_pnt < pnt_per_shard)
        local = p._replace(
            obs_pnt=jnp.clip(local_obs_pnt, 0, pnt_per_shard - 1),
            obs_active=p.obs_active & in_shard,
        )
        active0 = local.obs_active.astype(jnp.float32)

        def phase(cam_Tcw, pnt_pos, act, iters, use_huber):
            def body(_, st):
                cT, pP, lam = st
                Hcc, bc, S_sub, rhs_sub, Hpp_inv, W, bp = _local_schur(
                    local, cT, pP, act, lam, use_huber, n_cam)
                # reduce the camera system over shards (the only collective)
                Hcc = jax.lax.psum(Hcc, "map")
                bc = jax.lax.psum(bc, "map")
                S_sub = jax.lax.psum(S_sub, "map")
                rhs_sub = jax.lax.psum(rhs_sub, "map")

                eye6 = jnp.eye(6)
                Hcc_d = Hcc + lam * Hcc * eye6 + 1e-8 * eye6
                idx = jnp.arange(n_cam)
                Hbd = jnp.zeros((n_cam, 6, n_cam, 6)).at[idx, :, idx, :].set(Hcc_d)
                S = Hbd.reshape(n_cam * 6, n_cam * 6) - S_sub
                rhs = bc.reshape(-1) - rhs_sub

                free = (~local.cam_fixed).astype(jnp.float32)
                free6 = jnp.repeat(free, 6)
                S = S * free6[:, None] * free6[None, :] + jnp.diag(1.0 - free6)
                rhs = rhs * free6
                dc = -jnp.linalg.solve(S, rhs).reshape(n_cam, 6)

                # local landmark back-substitution
                Wt_dc = _btv(W, dc[local.obs_cam])
                acc = jax.ops.segment_sum(
                    Wt_dc, local.obs_pnt, num_segments=pnt_per_shard)
                dp = -_bmv(Hpp_inv, bp + acc)
                dp = dp * local.pnt_active[:, None]

                cam_new = se3.retract(cT, dc)
                cam_new = jnp.where(local.cam_fixed[:, None, None], cT, cam_new)
                pnt_new = pP + dp

                def cost(cT2, pP2):
                    e2, _, _, _ = ba_mod._residuals(local, cT2, pP2)
                    c2 = jnp.sum(e2 * e2, -1) * local.obs_inv_sigma2
                    rho = ba_mod._robust_cost(c2, ba_mod.HUBER_DELTA, use_huber)
                    return jax.lax.psum(jnp.sum(rho * act), "map")

                better = cost(cam_new, pnt_new) < cost(cT, pP)
                cT = jnp.where(better, cam_new, cT)
                pP = jnp.where(better, pnt_new, pP)
                lam = jnp.where(better, lam * 0.5, lam * 5.0)
                return cT, pP, lam

            cT, pP, _ = jax.lax.fori_loop(
                0, iters, body, (cam_Tcw, pnt_pos, jnp.float32(1e-4)))
            return cT, pP

        cam_Tcw, pnt_pos = phase(
            local.cam_Tcw, local.pnt_pos, active0, iters1, True)
        e, _, _, z = ba_mod._residuals(local, cam_Tcw, pnt_pos)
        chi2 = jnp.sum(e * e, -1) * local.obs_inv_sigma2
        good = (chi2 <= ba_mod.CHI2_STEREO) & (z > 0)
        act2 = active0 * good.astype(jnp.float32)
        cam_Tcw, pnt_pos = phase(cam_Tcw, pnt_pos, act2, iters2, False)

        e, _, _, z = ba_mod._residuals(local, cam_Tcw, pnt_pos)
        chi2 = jnp.sum(e * e, -1) * local.obs_inv_sigma2
        inlier = local.obs_active & (chi2 <= ba_mod.CHI2_STEREO) & (z > 0)
        return cam_Tcw, pnt_pos, inlier

    return shard_map(
        shard_fn, mesh=mesh,
        in_specs=(prob_specs,),
        out_specs=(P(), P("map"), P("map")),
        check_vma=False,
    )(prob)


@functools.partial(
    jax.jit, static_argnames=("mesh", "iters1", "iters2", "cg_iters", "n_cam"))
def distributed_bundle_adjust_cg(
    prob: BAProblem, mesh: Mesh, n_cam: int,
    iters1: int = 5, iters2: int = 10, cg_iters: int = 64,
):
    """Distributed implicit-Schur PCG bundle adjustment — the
    KITTI-00-scale multi-chip engine.

    Unlike :func:`distributed_bundle_adjust` (which materializes the
    dense reduced camera system and its (6C x 3P_local) coupling — right
    for C <= ~128), this never forms S: points/observations are sharded
    along ``map``, cameras replicated, and each CG step's matvec costs
    local segment sums plus ONE (C, 6) psum across devices.  Scales to
    thousands of cameras and millions of observations.  CG state (r, p,
    x) is camera-space and replicated, so the scalar dot products are
    computed identically on every shard with no extra collectives."""
    from pyorbslam_jax.optim import ba_cg

    obs_spec = P("map")
    prob_specs = BAProblem(
        cam_Tcw=P(), cam_fixed=P(), pnt_pos=P("map"), pnt_active=P("map"),
        obs_cam=obs_spec, obs_pnt=obs_spec, obs_uvr=obs_spec,
        obs_inv_sigma2=obs_spec, obs_active=obs_spec, cam=P(),
    )
    n_shards = mesh.shape["map"]
    pnt_per_shard = prob.pnt_pos.shape[0] // n_shards

    def shard_fn(p: BAProblem):
        shard_id = jax.lax.axis_index("map")
        local_obs_pnt = p.obs_pnt - shard_id * pnt_per_shard
        in_shard = (local_obs_pnt >= 0) & (local_obs_pnt < pnt_per_shard)
        local = p._replace(
            obs_pnt=jnp.clip(local_obs_pnt, 0, pnt_per_shard - 1),
            obs_active=p.obs_active & in_shard,
        )
        res = ba_cg._bundle_adjust_cg_core(
            local, iters1, iters2, cg_iters, axis="map")
        return res.cam_Tcw, res.pnt_pos, res.obs_inlier

    return shard_map(
        shard_fn, mesh=mesh,
        in_specs=(prob_specs,),
        out_specs=(P(), P("map"), P("map")),
        check_vma=False,
    )(prob)
