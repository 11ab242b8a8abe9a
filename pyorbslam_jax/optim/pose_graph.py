"""Sim3 pose-graph (essential graph) optimization.

Replaces Optimizer.optimize_essential_graph (Optimizer.py:485-658): Sim3
vertices for every keyframe, relative-Sim3 edges (loop connections,
spanning tree, previous loop edges, strong covisibles), identity 7x7
information, 20 LM iterations, loop keyframe fixed.

Two interchangeable solvers over the same edge algebra:

* ``optimize_pose_graph`` — per-edge residuals r = log(Sji * Si * Sj^-1)
  and their Jacobians (forward-mode autodiff of the two retractions,
  vmapped over edges) scattered into a dense (7C x 7C) normal matrix,
  one solve per iteration.  Right up to a few hundred keyframes.
* ``optimize_pose_graph_cg`` — the same damped normal equations solved
  matrix-free: H v is two gathers + batched 7x7 block products + two
  segment-sum scatters over the edge list, preconditioned by the exact
  block-diagonal (one more segment sum, batched 7x7 inverses).  Memory
  and per-iteration cost are O(E + C) instead of O(C^2), which is what
  KITTI-00-scale essential graphs (~1.5k KFs, ~10k edges) and the
  distributed pose graph (edges sharded over a device mesh, the scatter
  psum'd) need.

Scale components are frozen for stereo (bFixScale).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from pyorbslam_jax.geometry import sim3 as sim3_mod
from pyorbslam_jax.geometry.sim3 import Sim3

from pyorbslam_jax.utils.precision import f32_matmuls


class PoseGraphResult(NamedTuple):
    R: jnp.ndarray    # (C, 3, 3) corrected Siw rotations
    t: jnp.ndarray    # (C, 3)
    s: jnp.ndarray    # (C,)


def _edge_residual(Si: Sim3, Sj: Sim3, Sji: Sim3) -> jnp.ndarray:
    """r = log(Sji * Si * Sj^-1): zero iff Sj = Sji * Si ... i.e. the
    relative transform matches the measurement (EdgeSim3 semantics)."""
    return sim3_mod.log(
        sim3_mod.compose(Sji, sim3_mod.compose(Si, sim3_mod.inverse(Sj)))
    )


def _residual_and_jac(state: Sim3, e_i, e_j, meas: Sim3):
    """Per-edge residual (E, 7) and Jacobians (E, 7, 7) wrt the two
    endpoint tangent perturbations, at the current state."""
    Si = jax.tree_util.tree_map(lambda a: a[e_i], state)
    Sj = jax.tree_util.tree_map(lambda a: a[e_j], state)

    def res(xi_i, xi_j, SiE, SjE, SjiE):
        return _edge_residual(
            sim3_mod.retract(SiE, xi_i), sim3_mod.retract(SjE, xi_j), SjiE
        )

    zero = jnp.zeros(7, jnp.float32)
    r = jax.vmap(res, in_axes=(None, None, 0, 0, 0))(zero, zero, Si, Sj, meas)
    Ji = jax.vmap(
        lambda SiE, SjE, SjiE: jax.jacfwd(res, argnums=0)(zero, zero, SiE, SjE, SjiE)
    )(Si, Sj, meas)   # (E, 7, 7)
    Jj = jax.vmap(
        lambda SiE, SjE, SjiE: jax.jacfwd(res, argnums=1)(zero, zero, SiE, SjE, SjiE)
    )(Si, Sj, meas)
    return r, Ji, Jj


def _total_err(state: Sim3, e_i, e_j, meas: Sim3, e_active):
    Si = jax.tree_util.tree_map(lambda a: a[e_i], state)
    Sj = jax.tree_util.tree_map(lambda a: a[e_j], state)
    r = jax.vmap(_edge_residual)(Si, Sj, meas)
    return jnp.sum(jnp.sum(r * r, -1) * e_active)


def _free_mask(fixed, C: int, fix_scale: bool):
    free = (~fixed).astype(jnp.float32)[:, None].repeat(7, 1)
    if fix_scale:
        free = free.at[:, 6].set(0.0)
    return free   # (C, 7)


def _accept_step(state, dx, fixed, e_i, e_j, meas, e_active, lam):
    new_state = sim3_mod.retract(state, dx)
    new_state = Sim3(
        R=jnp.where(fixed[:, None, None], state.R, new_state.R),
        t=jnp.where(fixed[:, None], state.t, new_state.t),
        s=jnp.where(fixed, state.s, new_state.s),
    )
    better = (_total_err(new_state, e_i, e_j, meas, e_active)
              < _total_err(state, e_i, e_j, meas, e_active))
    state = jax.tree_util.tree_map(
        lambda a, c: jnp.where(better, a, c), new_state, state
    )
    return state, jnp.where(better, lam * 0.5, lam * 5.0)


@functools.partial(jax.jit, static_argnames=("iters", "fix_scale"))
@f32_matmuls
def optimize_pose_graph(
    R: jnp.ndarray,          # (C, 3, 3) initial Siw
    t: jnp.ndarray,          # (C, 3)
    s: jnp.ndarray,          # (C,)
    fixed: jnp.ndarray,      # (C,) bool (loop KF + padding)
    e_i: jnp.ndarray,        # (E,) int32 vertex i per edge
    e_j: jnp.ndarray,        # (E,) int32 vertex j
    m_R: jnp.ndarray,        # (E, 3, 3) measured Sji
    m_t: jnp.ndarray,        # (E, 3)
    m_s: jnp.ndarray,        # (E,)
    e_active: jnp.ndarray,   # (E,) bool
    iters: int = 20,
    fix_scale: bool = True,
) -> PoseGraphResult:
    C = R.shape[0]
    meas = Sim3(R=m_R, t=m_t, s=m_s)
    free = _free_mask(fixed, C, fix_scale)

    def body(_, carry):
        state, lam = carry
        r, Ji, Jj = _residual_and_jac(state, e_i, e_j, meas)
        w = e_active.astype(jnp.float32)

        H = jnp.zeros((C, 7, C, 7))
        b = jnp.zeros((C, 7))
        wJi = w[:, None, None] * Ji
        wJj = w[:, None, None] * Jj
        H = H.at[e_i, :, e_i, :].add(jnp.einsum("eij,eik->ejk", wJi, Ji))
        H = H.at[e_j, :, e_j, :].add(jnp.einsum("eij,eik->ejk", wJj, Jj))
        H = H.at[e_i, :, e_j, :].add(jnp.einsum("eij,eik->ejk", wJi, Jj))
        H = H.at[e_j, :, e_i, :].add(jnp.einsum("eij,eik->ejk", wJj, Ji))
        b = b.at[e_i].add(jnp.einsum("eij,ei->ej", wJi, r))
        b = b.at[e_j].add(jnp.einsum("eij,ei->ej", wJj, r))

        free_f = free.reshape(-1)
        Hf = H.reshape(7 * C, 7 * C)
        Hf = Hf * free_f[:, None] * free_f[None, :]
        Hf = Hf + jnp.diag(1.0 - free_f) + lam * jnp.diag(jnp.diag(Hf)) + 1e-8 * jnp.eye(7 * C)
        bf = b.reshape(-1) * free_f

        dx = -jnp.linalg.solve(Hf, bf).reshape(C, 7)
        return _accept_step(state, dx, fixed, e_i, e_j, meas, e_active, lam)

    state0 = Sim3(R=R, t=t, s=s)
    state, _ = jax.lax.fori_loop(0, iters, body, (state0, jnp.float32(1e-8)))
    return PoseGraphResult(R=state.R, t=state.t, s=state.s)


@functools.partial(jax.jit, static_argnames=("iters", "fix_scale", "cg_iters"))
@f32_matmuls
def optimize_pose_graph_cg(
    R: jnp.ndarray, t: jnp.ndarray, s: jnp.ndarray, fixed: jnp.ndarray,
    e_i: jnp.ndarray, e_j: jnp.ndarray,
    m_R: jnp.ndarray, m_t: jnp.ndarray, m_s: jnp.ndarray,
    e_active: jnp.ndarray,
    iters: int = 20, fix_scale: bool = True, cg_iters: int = 96,
) -> PoseGraphResult:
    """Matrix-free variant of :func:`optimize_pose_graph` (same arguments,
    same damping/acceptance), solving each LM step by block-Jacobi
    preconditioned CG over the edge list — O(E + C) memory, no (7C)^2
    normal matrix.  `tests/test_sim3.py` pins it to the dense solver."""
    from pyorbslam_jax.optim.ba_cg import _pcg

    C = R.shape[0]
    meas = Sim3(R=m_R, t=m_t, s=m_s)
    free = _free_mask(fixed, C, fix_scale)
    eye7 = jnp.eye(7)

    def body(_, carry):
        state, lam = carry
        r, Ji, Jj = _residual_and_jac(state, e_i, e_j, meas)
        w = e_active.astype(jnp.float32)
        wJi = w[:, None, None] * Ji
        wJj = w[:, None, None] * Jj
        # per-edge normal blocks (E, 7, 7): H[i,i] += A_ii, H[i,j] += A_ij...
        A_ii = jnp.einsum("eij,eik->ejk", wJi, Ji)
        A_jj = jnp.einsum("eij,eik->ejk", wJj, Jj)
        A_ij = jnp.einsum("eij,eik->ejk", wJi, Jj)
        b = jnp.zeros((C, 7))
        b = b.at[e_i].add(jnp.einsum("eij,ei->ej", wJi, r))
        b = b.at[e_j].add(jnp.einsum("eij,ei->ej", wJj, r))
        bf = b * free

        # block diagonal of H (masked), shared by damping and preconditioner
        D = (jax.ops.segment_sum(A_ii, e_i, num_segments=C)
             + jax.ops.segment_sum(A_jj, e_j, num_segments=C))
        D = D * free[:, :, None] * free[:, None, :]
        diag = jnp.diagonal(D, axis1=1, axis2=2)          # (C, 7) masked

        def matvec(v):                                     # v: (C, 7)
            vf = v * free
            yi = (jnp.einsum("ejk,ek->ej", A_ii, vf[e_i])
                  + jnp.einsum("ejk,ek->ej", A_ij, vf[e_j]))
            yj = (jnp.einsum("ekj,ek->ej", A_ij, vf[e_i])
                  + jnp.einsum("ejk,ek->ej", A_jj, vf[e_j]))
            y = (jax.ops.segment_sum(yi, e_i, num_segments=C)
                 + jax.ops.segment_sum(yj, e_j, num_segments=C)) * free
            # damping/identity terms match the dense solver exactly
            return y + (1.0 - free) * v + lam * diag * vf + 1e-8 * v

        Dd = (D + lam * diag[:, :, None] * eye7 + 1e-8 * eye7
              + eye7 * (1.0 - free)[:, :, None])
        Minv = jnp.linalg.inv(Dd)

        dx = -_pcg(matvec, bf, Minv, cg_iters)
        return _accept_step(state, dx, fixed, e_i, e_j, meas, e_active, lam)

    state0 = Sim3(R=R, t=t, s=s)
    state, _ = jax.lax.fori_loop(0, iters, body, (state0, jnp.float32(1e-8)))
    return PoseGraphResult(R=state.R, t=state.t, s=state.s)
