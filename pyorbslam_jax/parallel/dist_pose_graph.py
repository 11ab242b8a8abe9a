"""Distributed Sim3 pose-graph (essential graph) optimization over a mesh.

The multi-host redesign of Optimizer.optimize_essential_graph
(Optimizer.py:485-658) for pod-scale maps (BASELINE config 5): edges —
loop connections, spanning tree, strong covisibles — are partitioned
across devices along a 1-D ``map`` mesh axis, while the Sim3 vertex state
(C keyframes; thousands at most) is replicated.  Each LM step runs the
same matrix-free PCG as :func:`optim.pose_graph.optimize_pose_graph_cg`:

  * per shard: residuals + 7x7 edge normal blocks for local edges;
  * the CG matvec is a local gather / batched block product / scatter
    followed by one ``psum`` across devices — the only per-CG-iteration
    communication, 7C floats;
  * gradient, block-diagonal preconditioner, and acceptance costs are
    psum'd once per LM iteration; the CG state itself stays replicated
    so its dot products need no collectives.

Numerically identical to the single-device CG solver (the psum of
per-shard segment sums is the global segment sum); pinned together in
tests/test_dist_ba.py.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pyorbslam_jax.geometry import sim3 as sim3_mod
from pyorbslam_jax.geometry.sim3 import Sim3
from pyorbslam_jax.optim.ba_cg import _pcg
from pyorbslam_jax.optim.pose_graph import (
    PoseGraphResult,
    _edge_residual,
    _free_mask,
    _residual_and_jac,
)
from pyorbslam_jax.utils.precision import f32_matmuls


def pad_edges(
    n_shards: int,
    e_i: np.ndarray, e_j: np.ndarray,
    m_R: np.ndarray, m_t: np.ndarray, m_s: np.ndarray,
    e_active: np.ndarray,
) -> Tuple[np.ndarray, ...]:
    """Pad the edge list to a multiple of the shard count (inactive
    self-loop edges on vertex 0)."""
    E = len(e_i)
    Ep = -(-max(E, 1) // n_shards) * n_shards
    pad = Ep - E

    def z(a, fill=0):
        return np.concatenate(
            [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) if pad else a

    eye = np.broadcast_to(np.eye(3, dtype=m_R.dtype), (pad, 3, 3))
    m_R2 = np.concatenate([m_R, eye]) if pad else m_R
    return (z(e_i), z(e_j), m_R2, z(m_t), z(m_s, 1),
            np.concatenate([e_active, np.zeros(pad, bool)]) if pad else e_active)


@functools.partial(
    jax.jit, static_argnames=("mesh", "iters", "fix_scale", "cg_iters"))
@f32_matmuls
def distributed_pose_graph(
    mesh: Mesh,
    R: jnp.ndarray, t: jnp.ndarray, s: jnp.ndarray,    # (C,...) replicated
    fixed: jnp.ndarray,                                # (C,) bool
    e_i: jnp.ndarray, e_j: jnp.ndarray,                # (E,) sharded
    m_R: jnp.ndarray, m_t: jnp.ndarray, m_s: jnp.ndarray,
    e_active: jnp.ndarray,
    iters: int = 20, fix_scale: bool = True, cg_iters: int = 96,
) -> PoseGraphResult:
    C = R.shape[0]
    eye7 = jnp.eye(7)

    def shard_fn(R, t, s, fixed, e_i, e_j, m_R, m_t, m_s, e_active):
        meas = Sim3(R=m_R, t=m_t, s=m_s)
        free = _free_mask(fixed, C, fix_scale)

        def total_err(state):
            Si = jax.tree_util.tree_map(lambda a: a[e_i], state)
            Sj = jax.tree_util.tree_map(lambda a: a[e_j], state)
            r = jax.vmap(_edge_residual)(Si, Sj, meas)
            return jax.lax.psum(
                jnp.sum(jnp.sum(r * r, -1) * e_active), "map")

        def body(_, carry):
            state, lam = carry
            r, Ji, Jj = _residual_and_jac(state, e_i, e_j, meas)
            w = e_active.astype(jnp.float32)
            wJi = w[:, None, None] * Ji
            wJj = w[:, None, None] * Jj
            A_ii = jnp.einsum("eij,eik->ejk", wJi, Ji)
            A_jj = jnp.einsum("eij,eik->ejk", wJj, Jj)
            A_ij = jnp.einsum("eij,eik->ejk", wJi, Jj)

            b = jnp.zeros((C, 7))
            b = b.at[e_i].add(jnp.einsum("eij,ei->ej", wJi, r))
            b = b.at[e_j].add(jnp.einsum("eij,ei->ej", wJj, r))
            b = jax.lax.psum(b, "map")
            bf = b * free

            D = (jax.ops.segment_sum(A_ii, e_i, num_segments=C)
                 + jax.ops.segment_sum(A_jj, e_j, num_segments=C))
            D = jax.lax.psum(D, "map")
            D = D * free[:, :, None] * free[:, None, :]
            diag = jnp.diagonal(D, axis1=1, axis2=2)

            def matvec(v):       # v (C, 7) replicated
                vf = v * free
                yi = (jnp.einsum("ejk,ek->ej", A_ii, vf[e_i])
                      + jnp.einsum("ejk,ek->ej", A_ij, vf[e_j]))
                yj = (jnp.einsum("ekj,ek->ej", A_ij, vf[e_i])
                      + jnp.einsum("ejk,ek->ej", A_jj, vf[e_j]))
                y = (jax.ops.segment_sum(yi, e_i, num_segments=C)
                     + jax.ops.segment_sum(yj, e_j, num_segments=C))
                y = jax.lax.psum(y, "map") * free   # the per-CG-step collective
                return y + (1.0 - free) * v + lam * diag * vf + 1e-8 * v

            Dd = (D + lam * diag[:, :, None] * eye7 + 1e-8 * eye7
                  + eye7 * (1.0 - free)[:, :, None])
            Minv = jnp.linalg.inv(Dd)

            dx = -_pcg(matvec, bf, Minv, cg_iters)
            new_state = sim3_mod.retract(state, dx)
            new_state = Sim3(
                R=jnp.where(fixed[:, None, None], state.R, new_state.R),
                t=jnp.where(fixed[:, None], state.t, new_state.t),
                s=jnp.where(fixed, state.s, new_state.s),
            )
            better = total_err(new_state) < total_err(state)
            state = jax.tree_util.tree_map(
                lambda a, c: jnp.where(better, a, c), new_state, state)
            return state, jnp.where(better, lam * 0.5, lam * 5.0)

        state, _ = jax.lax.fori_loop(
            0, iters, body, (Sim3(R=R, t=t, s=s), jnp.float32(1e-8)))
        return state.R, state.t, state.s

    Rn, tn, sn = jax.shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P(), P(),
                  P("map"), P("map"), P("map"), P("map"), P("map"), P("map")),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )(R, t, s, fixed, e_i, e_j, m_R, m_t, m_s, e_active)
    return PoseGraphResult(R=Rn, t=tn, s=sn)


def place_pose_graph(mesh: Mesh, arrays, edge_arrays):
    """Device-put replicated vertex arrays and sharded edge arrays."""
    rep = NamedSharding(mesh, P())
    shd = NamedSharding(mesh, P("map"))
    return ([jax.device_put(a, rep) for a in arrays],
            [jax.device_put(a, shd) for a in edge_arrays])
