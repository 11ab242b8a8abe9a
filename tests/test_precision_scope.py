"""Every float32 matrix product of the device solvers is lowered at
HIGHEST precision (``utils.precision.f32_matmuls``).  On the GPU a product
left at default precision may run in TF32, which the CPU never does, so
this is checked on the lowered program rather than by comparing results
here."""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyorbslam_jax.optim import ba, ba_cg, pose_opt
from pyorbslam_jax.optim.pose_graph import optimize_pose_graph_cg
from pyorbslam_jax.parallel import dist_ba, dist_pose_graph
from pyorbslam_jax.utils import parity


def _f32_dots(lowered_text: str):
    """(all f32 dot_general lines, those without HIGHEST precision)."""
    dots = [d for d in re.findall(r"dot_general.*", lowered_text)
            if re.search(r"xf32>\)? ->", d) or "xf32> ->" in d]
    return dots, [d for d in dots if "HIGHEST" not in d]


def _pose_graph():
    return optimize_pose_graph_cg.lower(*parity.pose_graph_problem(12))


def _dist_pose_graph():
    mesh = dist_ba.make_mesh(4)
    R, t, s, fixed, e_i, e_j, mR, mt, ms, act = parity.pose_graph_problem(12)
    pe = dist_pose_graph.pad_edges(4, e_i, e_j, mR, mt, ms, act)
    reps, shds = dist_pose_graph.place_pose_graph(mesh, [R, t, s, fixed],
                                                  list(pe))
    return dist_pose_graph.distributed_pose_graph.lower(mesh, *reps, *shds)


def _dist_ba_cg():
    mesh = dist_ba.make_mesh(4)
    prob = parity.global_ba_problem(8, 256, 64)
    new_pnt, (oc, ouvr, oisig), act = dist_ba.group_observations_by_point_shard(
        prob.obs_pnt, 256, 4, (prob.obs_cam, prob.obs_uvr,
                               prob.obs_inv_sigma2))
    prob = prob._replace(obs_cam=oc, obs_pnt=new_pnt, obs_uvr=ouvr,
                         obs_inv_sigma2=oisig, obs_active=act)
    sharded = dist_ba.shard_problem(prob, mesh)
    return dist_ba.distributed_bundle_adjust_cg.lower(sharded, mesh, n_cam=8)


def _ba_cg():
    prob = parity.global_ba_problem(8, 256, 64)
    return jax.jit(functools.partial(ba_cg.bundle_adjust_cg, iters1=1,
                                     iters2=1)).lower(prob)


def _local_ba():
    return ba.bundle_adjust_grid_packed.lower(
        *parity.local_ba_problem(n_cam=4, n_pnt=200), iters1=1, iters2=1)


def _pose_opt():
    return pose_opt.pose_optimization.lower(*parity.pose_problem(n=64))


def _triangulation():
    from pyorbslam_jax.ops import triangulation as tri

    n = 128
    rng = np.random.default_rng(0)
    feats = (rng.uniform(0, 500, (n, 2)).astype(np.float32),
             np.zeros(n, np.int32),
             rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32),
             np.full(n, -1.0, np.float32), np.full(n, -1.0, np.float32),
             np.ones(n, bool))
    eye = np.eye(4, dtype=np.float32)
    sf = (1.2 ** np.arange(8)).astype(np.float32)
    return tri.triangulate_pair.lower(
        *feats, *feats, eye, eye, parity._CAM, np.float32(0.54), sf, sf * sf)


@pytest.mark.parametrize("lower", [
    _pose_graph, _dist_pose_graph, _dist_ba_cg, _ba_cg, _local_ba,
    _pose_opt, _triangulation,
], ids=lambda f: f.__name__.strip("_"))
def test_f32_products_lower_at_highest_precision(lower):
    dots, loose = _f32_dots(lower().as_text())
    assert dots, "no float32 products found: the check would be vacuous"
    assert not loose, loose[:3]


def test_the_check_sees_a_default_precision_product():
    text = jax.jit(lambda a, b: a @ b).lower(
        jnp.ones((3, 3)), jnp.ones((3, 3))).as_text()
    dots, loose = _f32_dots(text)
    assert len(dots) == 1 and len(loose) == 1
