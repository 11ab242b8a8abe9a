"""Loop closing: detection, Sim3 computation, loop correction.

Replaces LoopClosing.py as a synchronous stage invoked per keyframe:

  * :meth:`detect`  — BoW candidates below the covisible-score floor,
    filtered by 3-consecutive consistency groups (LoopClosing.py:80-144);
  * :meth:`compute_sim3` — per candidate: BoW matching >= 20, parallel
    Horn Sim3 RANSAC (scale fixed for stereo), relative Sim3 refinement
    >= 20 inliers, then projection of the loop-region point cloud with
    the corrected pose requiring >= 40 total matches
    (LoopClosing.py:146-247 — note this build *uses* the solver result,
    fixing the reference's unp unpacked-tuple bug at LoopClosing.py:187);
  * :meth:`correct` — propagate the corrected Sim3 to the current KF's
    covisible group, remap their landmarks, fuse loop duplicates,
    optimize the essential graph with the loop KF fixed, add loop edges,
    and run global BA (LoopClosing.py:249-436, synchronous instead of
    the reference's threads).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from collections import defaultdict, deque
from typing import Dict, List, Optional, Set, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.config import SlamConfig
from pyorbslam_jax.geometry import se3 as se3_np  # used via numpy arrays
from pyorbslam_jax.ops import matching as match_ops
from pyorbslam_jax.ops.hamming import popcount, unpack_bits
from pyorbslam_jax.optim import ba
from pyorbslam_jax.optim.horn import sim3_ransac
from pyorbslam_jax.optim.pose_graph import (
    optimize_pose_graph,
    optimize_pose_graph_cg,
)
from pyorbslam_jax.optim.sim3_opt import optimize_sim3
from pyorbslam_jax.place.keyframe_db import KeyFrameDatabase
from pyorbslam_jax.place.vocabulary import Vocabulary
from pyorbslam_jax.slam.slam_map import SlamMap


_sim3_mutual_match_jit = functools.partial(
    jax.jit, static_argnames=("log_scale_factor", "n_levels", "th")
)(match_ops.sim3_mutual_match)


def _sim3_from_T(T: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    return T[:3, :3].copy(), T[:3, 3].copy(), 1.0


def _sim3_mul(a, b):
    """(R, t, s) composition a*b."""
    Ra, ta, sa = a
    Rb, tb, sb = b
    return Ra @ Rb, sa * (Ra @ tb) + ta, sa * sb


def _sim3_inv(a):
    R, t, s = a
    return R.T, -(R.T @ t) / s, 1.0 / s


def _sim3_map(a, P):
    R, t, s = a
    return s * (P @ R.T) + t


@dataclasses.dataclass
class LoopCloser:
    cfg: SlamConfig
    map: SlamMap
    voc: Vocabulary
    kfdb: KeyFrameDatabase
    consistency_th: int = 3

    def __post_init__(self):
        self.prev_groups: List[Tuple[Set[int], int]] = []  # (group, count)
        self.last_loop_kf: int = -10 ** 9
        self.n_loops_closed: int = 0
        self.n_loops_rejected: int = 0
        self.n_loops_fused: int = 0   # rejected-geometry, kept-topology
        # sim3-ladder diagnostics; bounded so multi-thousand-KF runs
        # don't grow host memory without limit
        self.events: deque = deque(maxlen=4096)
        self.times = defaultdict(float)   # per-stage wall clock
        # Sim3-failure cooldown: candidate covisibility groups that just
        # failed geometric verification are skipped for a few keyframes.
        # On visually-aliased worlds the SAME region re-enters the
        # consistency window every keyframe; without the cooldown each
        # doomed region costs the full RANSAC+refine ladder per KF (the
        # dominant loop-stage cost at scale).  The reference pays ~0 for
        # a failed attempt (cheap CPU RANSAC); here it is device round
        # trips.  A genuine loop is delayed at most SIM3_FAIL_COOLDOWN
        # keyframes — the same order as the 3-consecutive consistency
        # window it already waits for.
        self._sim3_fail: deque = deque(maxlen=32)   # (group:Set[int], kf)

    SIM3_FAIL_COOLDOWN = 3   # keyframes

    # ------------------------------ detection ------------------------------

    def detect(self, kf: int, bow: Dict[int, float]) -> List[int]:
        if kf < self.last_loop_kf + 10 or self.map.keyframes.n < 10:
            self.prev_groups = []
            return []
        neighbors = self.map.covisible_neighbors(kf)
        if not neighbors:
            return []
        min_score = min(
            Vocabulary.score(bow, self.kfdb.bow.get(n, {})) for n in neighbors
        )
        cands = self.kfdb.detect_loop_candidates(
            kf, bow, min_score, set(neighbors), self.map.covisible_neighbors
        )
        if not cands:
            self.prev_groups = []
            return []

        # consistency groups over consecutive detections
        consistent: List[int] = []
        new_groups: List[Tuple[Set[int], int]] = []
        for cand in cands:
            group = set(self.map.covisible_neighbors(cand)) | {cand}
            count = 0
            for prev, prev_count in self.prev_groups:
                if group & prev:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count >= self.consistency_th:
                consistent.append(cand)
        self.prev_groups = new_groups
        return consistent

    # ------------------------------ Sim3 ------------------------------

    # Sim3 verification budget per keyframe: each candidate costs several
    # device round trips (BoW match + Horn RANSAC + guided rescue);
    # visual-aliasing storms otherwise stall the tracker behind dozens of
    # doomed attempts.  The reference's consecutive-consistency window
    # (LoopClosing.py:116-170) rarely yields more than 2-3 candidates on
    # a genuine revisit.
    MAX_SIM3_CANDIDATES = 3

    @staticmethod
    @jax.jit
    def _match_bow_batch(cur_desc, cur_node, cur_ok,
                         cand_desc, cand_node, cand_ok):
        """All candidates' exhaustive BoW matching as ONE jitted dispatch
        and one packed read — called eagerly this was dozens of per-op
        round trips per candidate."""
        cur_bits = unpack_bits(cur_desc)
        cur_pop = popcount(cur_desc)

        def one(cd, cn, co):
            idx, dist, matched = match_ops.match_by_bow(
                cur_bits, cur_pop, cur_node, cur_ok,
                unpack_bits(cd), popcount(cd), cn, co,
                ratio=0.75, node_gate=False,
            )
            return idx, matched

        return jax.vmap(one)(cand_desc, cand_node, cand_ok)

    def _cooldown_filter(self, kf: int, candidates: List[int]) -> List[int]:
        """Drop candidates whose covisibility group failed geometric
        verification within the last SIM3_FAIL_COOLDOWN keyframes
        (see __post_init__)."""
        if not self._sim3_fail:
            return candidates
        kept = []
        for cand in candidates:
            group = set(self.map.covisible_neighbors(cand)) | {cand}
            if any(kf - k0 <= self.SIM3_FAIL_COOLDOWN and (group & g)
                   for g, k0 in self._sim3_fail):
                self.events.append((kf, cand, "cooldown", 0))
            else:
                kept.append(cand)
        return kept

    def compute_sim3(self, kf: int, candidates: List[int]):
        """Returns (loop_kf, Scw=(R,t,s), matched landmark map feat->lm) or None."""
        candidates = self._cooldown_filter(kf, candidates)
        if not candidates:
            return None
        candidates = candidates[: self.MAX_SIM3_CANDIDATES]
        attempted: List[int] = []   # candidates that reached geometry
        ks = self.map.keyframes
        lm = self.map.landmarks
        cam = self.cfg.camera
        cam4 = jnp.asarray([cam.fx, cam.fy, cam.cx, cam.cy], jnp.float32)
        sigma2 = np.asarray(self.cfg.orb.level_sigma2)

        cur_lm = lm.resolve(ks.obs_lm[kf])
        # search_by_BoW_kf_kf (ORBMatcher.py:120-213): match features
        # that carry LIVE LANDMARKS on both sides; the Sim3 geometry
        # uses the landmark positions mapped into each camera
        # (Sim3Solver.__init__, Sim3Solver.py:27-56) — multi-view
        # refined points, not raw single-view stereo depths.
        # ALL candidates match in ONE jitted dispatch + one read
        # (exhaustive, node_gate=False: the loop stage needs every
        # available correspondence and the full Hamming matrix is one
        # int8 matmul)
        cur_ok = ks.kp_valid[kf] & (cur_lm >= 0) \
            & lm.alive[np.maximum(cur_lm, 0)]
        CANDS = self.MAX_SIM3_CANDIDATES
        sel = np.asarray((candidates + [candidates[0]] * CANDS)[:CANDS])
        cand_lms = [lm.resolve(ks.obs_lm[c]) for c in sel]
        cand_ok = np.stack([
            ks.kp_valid[c] & (clm >= 0) & lm.alive[np.maximum(clm, 0)]
            for c, clm in zip(sel, cand_lms)])
        t_bow = time.perf_counter()
        idx_b, matched_b = (np.asarray(a) for a in self._match_bow_batch(
            jnp.asarray(ks.kp_desc[kf]), jnp.asarray(ks.kp_node[kf]),
            jnp.asarray(cur_ok),
            jnp.asarray(ks.kp_desc[sel]), jnp.asarray(ks.kp_node[sel]),
            jnp.asarray(cand_ok),
        ))
        self.times["loop.sim3_bow"] += time.perf_counter() - t_bow

        for ci, cand in enumerate(candidates):
            cand_lm = cand_lms[ci]
            idx, matched = idx_b[ci], matched_b[ci]
            qi = np.nonzero(matched)[0]
            fi = idx[qi]
            self.events.append((kf, cand, "bow_pairs", len(qi)))
            if len(qi) < 20:
                continue
            attempted.append(cand)
            # RANSAC shapes come from a 2-size ladder (128 / 512): every
            # distinct correspondence count would otherwise compile a
            # fresh program; past 512 pairs the minimal-set solver gains
            # nothing from more — subsample deterministically
            if len(qi) > 512:
                rs = np.random.default_rng(kf * 1315423911 + cand)
                keep = np.sort(rs.choice(len(qi), 512, replace=False))
                qi, fi = qi[keep], fi[keep]

            T1, T2 = ks.Tcw[kf], ks.Tcw[cand]
            L1 = cur_lm[qi]
            L2 = cand_lm[fi]
            X1c = (lm.pos[L1] @ T1[:3, :3].T + T1[:3, 3]).astype(np.float32)
            X2c = (lm.pos[L2] @ T2[:3, :3].T + T2[:3, 3]).astype(np.float32)
            lm2 = L2
            uv1 = ks.kp_xy[kf, qi]
            uv2 = ks.kp_xy[cand, fi]
            s2_1 = sigma2[ks.kp_octave[kf, qi]]
            s2_2 = sigma2[ks.kp_octave[cand, fi]]
            n = len(qi)

            B = 128 if n <= 128 else 512
            pad = B - n

            def _p(a, fill=0.0):
                return np.concatenate(
                    [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) \
                    if pad else a

            t_sub = time.perf_counter()
            res = sim3_ransac(
                jnp.asarray(_p(X1c)), jnp.asarray(_p(X2c)),
                jnp.asarray(_p(uv1)), jnp.asarray(_p(uv2)),
                jnp.asarray(_p(s2_1, 1.0)), jnp.asarray(_p(s2_2, 1.0)),
                jnp.asarray(np.arange(B) < n), cam4,
                jax.random.PRNGKey(kf),
                with_scale=False,
            )
            res_ok = bool(res.ok)
            self.times["loop.sim3_ransac"] += time.perf_counter() - t_sub
            self.events.append((
                kf, cand, "ransac",
                int(np.asarray(res.inliers).sum()) if res_ok else -1))
            if not res_ok:
                continue

            # grow correspondences by MUTUAL Sim3 projection between the
            # two keyframes (ORBMatcher.search_by_sim3, th=7.5) seeded
            # with the RANSAC estimate, then refine the Sim3 over the
            # combined set (LoopClosing.py:203-210)
            inl = np.asarray(res.inliers)[:n]
            seed_q = qi[inl]
            seed_f = fi[inl]
            t_sub = time.perf_counter()
            grown12 = self._search_by_sim3(
                kf, cand, np.asarray(res.R), np.asarray(res.t),
                float(res.s), seed_q, seed_f)
            self.times["loop.sim3_grow"] += time.perf_counter() - t_sub

            N = ks.obs_lm.shape[1]
            pair_f = np.full(N, -1, np.int32)
            active = np.zeros(N, bool)
            X1 = np.zeros((N, 3), np.float32)
            X2 = np.zeros((N, 3), np.float32)
            uv1f = np.zeros((N, 2), np.float32)
            uv2f = np.zeros((N, 2), np.float32)
            isig1 = np.ones(N, np.float32)
            isig2 = np.ones(N, np.float32)
            # RANSAC-inlier BoW pairs keep their stereo-depth geometry
            active[seed_q] = True
            pair_f[seed_q] = seed_f
            X1[seed_q] = X1c[inl]
            X2[seed_q] = X2c[inl]
            uv1f[seed_q] = uv1[inl]
            uv2f[seed_q] = uv2[inl]
            isig1[seed_q] = 1.0 / s2_1[inl]
            isig2[seed_q] = 1.0 / s2_2[inl]
            # mutually-grown pairs use their landmark positions mapped
            # into each camera (Optimizer.optimize_sim3 edge geometry)
            g1 = np.nonzero(grown12 >= 0)[0]
            if len(g1):
                g2 = grown12[g1]
                L1 = lm.resolve(ks.obs_lm[kf])[g1]
                L2 = lm.resolve(ks.obs_lm[cand])[g2]
                T1, T2 = ks.Tcw[kf], ks.Tcw[cand]
                active[g1] = True
                pair_f[g1] = g2
                X1[g1] = lm.pos[L1] @ T1[:3, :3].T + T1[:3, 3]
                X2[g1] = lm.pos[L2] @ T2[:3, :3].T + T2[:3, 3]
                uv1f[g1] = ks.kp_xy[kf, g1]
                uv2f[g1] = ks.kp_xy[cand, g2]
                isig1[g1] = 1.0 / sigma2[ks.kp_octave[kf, g1]]
                isig2[g1] = 1.0 / sigma2[ks.kp_octave[cand, g2]]

            t_sub = time.perf_counter()
            opt = optimize_sim3(
                res.R, res.t, res.s,
                jnp.asarray(X1), jnp.asarray(X2),
                jnp.asarray(uv1f), jnp.asarray(uv2f),
                jnp.asarray(isig1), jnp.asarray(isig2),
                jnp.asarray(active), cam4, th2=10.0, fix_scale=True,
            )
            n_opt_inl = int(opt.n_inliers)
            self.times["loop.sim3_opt"] += time.perf_counter() - t_sub
            self.events.append((kf, cand, "sim3_opt", n_opt_inl))
            if n_opt_inl < 20:
                continue

            # Scm maps candidate-camera coords into current-camera coords
            Scm = (np.asarray(opt.R), np.asarray(opt.t), float(opt.s))
            Smw = _sim3_from_T(ks.Tcw[cand])
            Scw = _sim3_mul(Scm, Smw)

            # surviving pairs whose candidate feature carries a live
            # landmark become loop-landmark bindings
            opt_inl = np.asarray(opt.inliers)
            match_map = {}
            for q in np.nonzero(opt_inl & (pair_f >= 0))[0]:
                l2 = int(cand_lm[pair_f[q]])
                if l2 >= 0 and lm.alive[l2]:
                    match_map[int(q)] = l2

            # second projection pass (LoopClosing.py:236-247): project the
            # loop-region point cloud into the current KF with Scw
            # (search_by_projection_ckf_scw_mp, th=10, TH_LOW) and count
            # total MATCHES — the reference accepts at >= 40 matches
            t_sub = time.perf_counter()
            n_total = len(match_map) + self._project_loop_points(
                kf, cand, Scw, match_map)
            self.times["loop.sim3_proj"] += time.perf_counter() - t_sub
            self.events.append((kf, cand, "total_matches", n_total))
            if n_total >= 40:
                return cand, Scw, match_map
        # every geometric attempt failed: cool their regions down so the
        # next few keyframes don't re-run the same doomed ladder
        for cand in attempted:
            self._sim3_fail.append(
                (set(self.map.covisible_neighbors(cand)) | {cand}, kf))
        return None

    def _search_by_sim3(self, kf: int, cand: int, R12, t12, s12,
                        seed_q: np.ndarray, seed_f: np.ndarray) -> np.ndarray:
        """Mutual Sim3 projection matching between two keyframes
        (ORBMatcher.search_by_sim3:713-848).  Returns per-current-feature
        candidate-feature index (-1 = no mutual match)."""
        ks = self.map.keyframes
        lm = self.map.landmarks
        cam = self.cfg.camera
        cam4 = jnp.asarray([cam.fx, cam.fy, cam.cx, cam.cy], jnp.float32)
        bounds = jnp.asarray(
            [0.0, cam.width - 1.0, 0.0, cam.height - 1.0], jnp.float32)

        def side(k):
            ids = lm.resolve(ks.obs_lm[k])
            has = (ids >= 0) & lm.alive[np.maximum(ids, 0)]
            safe = np.maximum(ids, 0)
            desc = jnp.asarray(lm.desc[safe])
            return dict(
                p_pos=jnp.asarray(lm.pos[safe]),
                p_bits=unpack_bits(desc), p_pop=popcount(desc),
                p_has=jnp.asarray(has),
                p_dmin=jnp.asarray(lm.dmin[safe]),
                p_dmax=jnp.asarray(lm.dmax[safe]),
                f_xy=jnp.asarray(ks.kp_xy[k]),
                f_oct=jnp.asarray(ks.kp_octave[k]),
                f_bits=unpack_bits(jnp.asarray(ks.kp_desc[k])),
                f_pop=popcount(jnp.asarray(ks.kp_desc[k])),
                f_valid=jnp.asarray(ks.kp_valid[k]),
            )

        s1, s2 = side(kf), side(cand)
        N = ks.obs_lm.shape[1]
        already1 = np.zeros(N, bool)
        already1[seed_q] = True
        already2 = np.zeros(N, bool)
        already2[seed_f] = True

        out = _sim3_mutual_match_jit(
            s1["p_pos"], s1["p_bits"], s1["p_pop"], s1["p_has"],
            s1["p_dmin"], s1["p_dmax"], jnp.asarray(already1),
            s1["f_xy"], s1["f_oct"], s1["f_bits"], s1["f_pop"], s1["f_valid"],
            s2["p_pos"], s2["p_bits"], s2["p_pop"], s2["p_has"],
            s2["p_dmin"], s2["p_dmax"], jnp.asarray(already2),
            s2["f_xy"], s2["f_oct"], s2["f_bits"], s2["f_pop"], s2["f_valid"],
            jnp.asarray(ks.Tcw[kf]), jnp.asarray(ks.Tcw[cand]),
            jnp.asarray(R12, jnp.float32), jnp.asarray(t12, jnp.float32),
            jnp.asarray(np.float32(s12)),
            cam4, bounds,
            jnp.asarray(self.cfg.orb.scale_factors, jnp.float32),
            log_scale_factor=float(np.log(self.cfg.orb.scale_factor)),
            n_levels=self.cfg.orb.n_levels,
        )
        return np.asarray(out)

    def _project_loop_points(self, kf: int, cand: int, Scw,
                             match_map: Dict[int, int]) -> int:
        """search_by_projection_ckf_scw_mp (ORBMatcher.py:850-923): project
        the loop-region landmarks into the current keyframe with Scw
        (th=10, TH_LOW, level window [pred-1, pred]) and bind new matches
        into ``match_map`` (mutated).  Returns the number added."""
        from pyorbslam_jax.slam.local_mapping import fuse_match_step

        m = self.map
        ks = m.keyframes
        lm = m.landmarks
        region = [cand] + m.covisible_neighbors(cand, 10)
        pts: Set[int] = set()
        for k2 in region:
            ids = lm.resolve(ks.obs_lm[k2])
            pts.update(int(i) for i in ids[ids >= 0] if lm.alive[i])
        pts -= set(match_map.values())
        if not pts:
            return 0
        loop_ids = np.fromiter(pts, np.int32)
        cap = 1024
        while cap < len(loop_ids) and cap < self.cfg.tracking.max_local_points:
            cap *= 2
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: min(len(loop_ids), cap)] = loop_ids[:cap]
        safe = np.maximum(p_ids, 0)

        R, t, s = Scw
        Tcw_eq = np.eye(4, dtype=np.float32)   # Scw as SE3 [R | t/s]
        Tcw_eq[:3, :3] = R
        Tcw_eq[:3, 3] = t / s
        f_free = ks.kp_valid[kf].copy()
        f_free[list(match_map)] = False
        match = np.asarray(fuse_match_step(
            jnp.asarray(lm.pos[safe]), jnp.asarray(lm.desc[safe]),
            jnp.asarray(lm.normal[safe]), jnp.asarray(lm.dmin[safe]),
            jnp.asarray(lm.dmax[safe]), jnp.asarray(p_ids >= 0),
            jnp.asarray(ks.kp_xy[kf]), jnp.asarray(ks.kp_octave[kf]),
            jnp.asarray(ks.kp_angle[kf]), jnp.asarray(ks.kp_desc[kf]),
            jnp.asarray(f_free), jnp.asarray(ks.u_right[kf]),
            jnp.asarray(Tcw_eq), self.cfg, radius_mult=10.0,
            level_hi=0, stereo_gate=False,
        ))
        n_added = 0
        for slot in np.nonzero(match >= 0)[0]:
            feat = int(match[slot])
            if feat in match_map:
                continue
            match_map[feat] = int(p_ids[slot])
            n_added += 1
        return n_added

    # ------------------------------ correction ------------------------------

    def correct(self, kf: int, loop_kf: int, Scw, match_map: Dict[int, int]):
        ks = self.map.keyframes
        lm = self.map.landmarks
        m = self.map

        # geometry snapshot for the accept/rollback A/B at the end: a
        # mis-measured Sim3 must never be allowed to make a
        # well-conditioned map worse (round-4 evidence: one tail-end
        # loop doubled the ATE of a 1.15-lap run).  Topology changes
        # (landmark merges, new observations) are kept either way; only
        # the GEOMETRY (poses + positions) is arbitrated, by the map's
        # own reprojection chi2 on the post-fuse topology.
        snap_Tcw = ks.Tcw[: ks.n].copy()
        snap_pos = lm.pos[: lm.n].copy()

        cur_group = [kf] + m.covisible_neighbors(kf)
        Twc = np.linalg.inv(ks.Tcw[kf]).astype(np.float32)

        corrected: Dict[int, Tuple] = {}
        non_corrected: Dict[int, Tuple] = {}
        for ki in cur_group:
            Tiw = ks.Tcw[ki]
            non_corrected[ki] = _sim3_from_T(Tiw)
            Tic = Tiw @ Twc
            Sic = _sim3_from_T(Tic)
            corrected[ki] = _sim3_mul(Sic, Scw)

        # remap landmarks of the current group and update poses
        done: Set[int] = set()
        for ki in cur_group:
            Siw_old = non_corrected[ki]
            Swi_corr = _sim3_inv(corrected[ki])
            ids = lm.resolve(ks.obs_lm[ki])
            ids = np.unique(ids[ids >= 0])
            ids = ids[lm.alive[ids]]
            for p in ids:
                p = int(p)
                if p in done:
                    continue
                done.add(p)
                lm.pos[p] = _sim3_map(
                    Swi_corr, _sim3_map(Siw_old, lm.pos[p][None])
                )[0]
            lm.mark_dirty(ids)
            R, t, s = corrected[ki]
            Tcorr = np.eye(4, dtype=np.float32)
            Tcorr[:3, :3] = R
            Tcorr[:3, 3] = t / s
            ks.Tcw[ki] = Tcorr

        # replace current-KF landmarks by their matched loop landmarks
        for feat, loop_lm in match_map.items():
            cur_lm = int(ks.obs_lm[kf, feat])
            if cur_lm >= 0 and cur_lm != loop_lm and lm.alive[loop_lm]:
                m.replace_landmark(cur_lm, loop_lm)
            elif cur_lm < 0 and lm.alive[loop_lm]:
                m.core.add_observation(loop_lm, kf, feat)

        # SearchAndFuse (LoopClosing.py:352-367): project the loop-region
        # landmarks into every corrected keyframe with a 4*scale radius and
        # merge duplicates — the loop landmark always wins (the reference
        # replaces toward mvpLoopMapPoints)
        prev_neighbors = {ki: set(m.covisible_neighbors(ki))
                          for ki in cur_group}
        n_fused = self._search_and_fuse(cur_group, loop_kf) or 0

        # refresh covisibility for the corrected group
        for ki in cur_group:
            m.update_connections(ki)

        # loop connections acquired through fusion (LoopClosing.py:329-337):
        # fresh cross-loop covisibility edges feed the essential graph
        loop_connections: Dict[int, Set[int]] = {}
        group_set = set(cur_group)
        for ki in cur_group:
            fresh = set(m.covisible_neighbors(ki)) - prev_neighbors[ki] \
                - group_set
            if fresh:
                loop_connections[ki] = fresh

        # ---------------- essential graph ----------------
        C = ks.n
        # vertex count bucket-padded for the same compile-reuse reason
        # as the edges below: padded vertices are FIXED identity poses
        # with no incident edges — inert in the solve
        Cb = 64
        while Cb < C:
            Cb <<= 1
        Rs = np.tile(np.eye(3, dtype=np.float32), (Cb, 1, 1))
        Rs[:C] = ks.Tcw[:C, :3, :3].astype(np.float32)
        tss = np.zeros((Cb, 3), np.float32)
        tss[:C] = ks.Tcw[:C, :3, 3].astype(np.float32)
        ss = np.ones(Cb, np.float32)
        fixed = np.zeros(Cb, bool)
        fixed[loop_kf] = True
        fixed[C:] = True

        e_i, e_j, mR, mt, msc = [], [], [], [], []
        seen_edges: Set[Tuple[int, int]] = set()

        def add_edge(i, j, Siw_i=None, Sjw_j=None):
            key = (min(i, j), max(i, j))
            if key in seen_edges or i == j:
                return
            seen_edges.add(key)
            Si = Siw_i if Siw_i is not None else _sim3_from_T(ks.Tcw[i])
            Sj = Sjw_j if Sjw_j is not None else _sim3_from_T(ks.Tcw[j])
            Sji = _sim3_mul(Sj, _sim3_inv(Si))
            e_i.append(i)
            e_j.append(j)
            mR.append(Sji[0])
            mt.append(Sji[1])
            msc.append(Sji[2])

        # loop edge between current and loop KF (measured with corrected
        # pose on the current side)
        add_edge(kf, loop_kf)
        # loop connections from fusion (corrected measurements; the
        # minFeat=100 strength cut is applied by the covisibility weight)
        for ki, partners in loop_connections.items():
            for kj in partners:
                if m.covis_weight(ki, kj) >= 100 or kj == loop_kf:
                    add_edge(ki, kj)
        # spanning tree edges with pre-correction measurements
        for ki in range(1, C):
            parent = m.parent.get(ki)
            if parent is not None:
                Si = non_corrected.get(ki, _sim3_from_T(ks.Tcw[ki]))
                Sj = non_corrected.get(parent, _sim3_from_T(ks.Tcw[parent]))
                add_edge(ki, parent, Si, Sj)
        # strong covisibles (weight >= 100) with pre-correction measurements
        ca, cb, cw = m.core.covis_edges()
        for ki, kj in zip(cb[cw >= 100].tolist(), ca[cw >= 100].tolist()):
            Si = non_corrected.get(ki, _sim3_from_T(ks.Tcw[ki]))
            Sj = non_corrected.get(kj, _sim3_from_T(ks.Tcw[kj]))
            add_edge(ki, kj, Si, Sj)
        # previous loop edges
        for ki, partners in m.loop_edges.items():
            for kj in partners:
                add_edge(ki, kj)

        if len(e_i) >= 2:
            # solver ladder: dense normal-matrix solve for small graphs;
            # above the CG threshold, the multi-device engine when a mesh
            # is available (edges sharded, psum'd CG matvec,
            # parallel/dist_pose_graph.py), else single-device
            # matrix-free PCG (O(E+C) memory).
            # Edge count is bucket-padded (valid-masked) so successive
            # loop events reuse the compiled solver instead of paying a
            # fresh compile per edge-list size.
            E = len(e_i)
            Eb = 256
            while Eb < E:
                Eb <<= 1
            padE = Eb - E
            e_i_np = np.concatenate(
                [np.array(e_i, np.int32), np.zeros(padE, np.int32)])
            e_j_np = np.concatenate(
                [np.array(e_j, np.int32), np.zeros(padE, np.int32)])
            mR_np = np.concatenate([
                np.stack(mR).astype(np.float32),
                np.tile(np.eye(3, dtype=np.float32), (padE, 1, 1))])
            mt_np = np.concatenate(
                [np.stack(mt).astype(np.float32),
                 np.zeros((padE, 3), np.float32)])
            ms_np = np.concatenate(
                [np.array(msc, np.float32), np.ones(padE, np.float32)])
            e_valid = np.arange(Eb) < E
            big = C > self.cfg.ba.pose_graph_cg_threshold
            engine = ("dist" if big and len(jax.devices()) > 1
                      else "cg" if big else "dense")
            m.counters[f"pose_graph.{engine}"] += 1
            if engine == "dist":
                from pyorbslam_jax.parallel import dist_pose_graph
                from pyorbslam_jax.parallel.dist_ba import make_mesh

                mesh = make_mesh()
                pe = dist_pose_graph.pad_edges(
                    mesh.shape["map"], e_i_np, e_j_np, mR_np, mt_np,
                    ms_np, e_valid)
                reps, shds = dist_pose_graph.place_pose_graph(
                    mesh, [Rs, tss, ss, fixed], list(pe))
                res = dist_pose_graph.distributed_pose_graph(
                    mesh, *reps, *shds,
                    iters=self.cfg.ba.pose_graph_iters,
                    cg_iters=self.cfg.ba.pose_graph_cg_iters)
            else:
                if engine == "cg":
                    solver = functools.partial(
                        optimize_pose_graph_cg,
                        cg_iters=self.cfg.ba.pose_graph_cg_iters,
                    )
                else:
                    solver = optimize_pose_graph
                res = solver(
                    jnp.asarray(Rs), jnp.asarray(tss), jnp.asarray(ss),
                    jnp.asarray(fixed),
                    jnp.asarray(e_i_np), jnp.asarray(e_j_np),
                    jnp.asarray(mR_np), jnp.asarray(mt_np),
                    jnp.asarray(ms_np),
                    jnp.asarray(e_valid),
                    iters=self.cfg.ba.pose_graph_iters,
                )
            newR = np.asarray(res.R)
            newt = np.asarray(res.t)
            news = np.asarray(res.s)

            # landmark correction through reference keyframes
            # (Optimizer.py:643-658), vectorized: map each landmark into
            # its first observer's OLD camera frame, then out through the
            # corrected inverse Sim3
            ids = m.core.observed_landmarks(lm.n)
            if len(ids):
                ref, _ = m.core.first_observers(ids)
                ok = ref >= 0
                ids, ref = ids[ok], ref[ok]
                P = lm.pos[ids]
                R_old = ks.Tcw[ref, :3, :3]
                t_old = ks.Tcw[ref, :3, 3]
                Pc = np.einsum("mij,mj->mi", R_old, P) + t_old
                Rc = newR[ref]
                tc = newt[ref]
                sc = news[ref][:, None]
                lm.pos[ids] = (np.einsum("mji,mj->mi", Rc, Pc - tc) / sc
                               ).astype(np.float32)
                lm.mark_dirty(ids)
            for ki in range(C):
                T = np.eye(4, dtype=np.float32)
                T[:3, :3] = newR[ki]
                T[:3, 3] = newt[ki] / news[ki]
                ks.Tcw[ki] = T

        # ---------------- accept / rollback A/B ----------------
        # Evaluate corrected vs snapshot geometry on the SAME (current,
        # post-fuse) topology; keep whichever the map's reprojection
        # chi2 prefers.  The margin biases toward acceptance: a genuine
        # loop closure briefly raises local chi2 until GBA polishes, so
        # only a clearly-worse correction is rolled back.
        t0 = time.perf_counter()
        e_corr = m.reprojection_chi2()
        corr_Tcw = ks.Tcw[: ks.n].copy()
        corr_pos = lm.pos[: lm.n].copy()
        ks.Tcw[: ks.n] = snap_Tcw
        lm.pos[: lm.n] = snap_pos
        e_snap = m.reprojection_chi2()
        self.times["loop.accept_check"] += time.perf_counter() - t0
        self.events.append(
            f"loop:accept_check chi2_corr={e_corr:.2f} chi2_snap={e_snap:.2f}")
        # margin calibration (observed events, v10/v11 worlds): harmful
        # corrections score chi2_corr/chi2_snap >= 2.8 (worst cases 25-55);
        # genuine loops score <= 1.7 (great ones << 1).  2.5x splits the
        # gap — biased toward acceptance because a genuine loop also buys
        # the loop EDGE the essential graph needs later
        if e_corr <= 2.5 * e_snap + 0.5:
            ks.Tcw[: ks.n] = corr_Tcw
            lm.pos[: lm.n] = corr_pos
            accepted = True
        else:
            # geometry stays at the snapshot; merged topology remains
            # (BA's chi2 gating erases any merge the old geometry
            # disagrees with)
            accepted = False
            self.n_loops_rejected += 1
            # the cross-lap fuse TOPOLOGY is kept either way; a heavily
            # fused rejection still closes the loop functionally (local
            # BA over the merged observations re-aligns the laps —
            # measured 9.7x ATE repair with every rigid jump rejected)
            if n_fused >= 40:
                self.n_loops_fused += 1
        lm.mark_dirty(np.arange(lm.n, dtype=np.int32))

        if not accepted:
            self.last_loop_kf = kf   # detection cooldown applies either way
            return

        m.loop_edges.setdefault(kf, set()).add(loop_kf)
        m.loop_edges.setdefault(loop_kf, set()).add(kf)
        self.last_loop_kf = kf
        self.n_loops_closed += 1

        # ---------------- global BA (bounded slices) ----------------
        # The reference runs GBA on its own thread and aborts it when a
        # new loop arrives (mbStopGBA, LoopClosing.py:342-436).  Here the
        # iteration budget is amortized: one fixed-size slice now (the
        # essential graph already placed every pose; GBA polishes), the
        # rest interleaved one slice per subsequent keyframe via
        # :meth:`run_gba_slice` — a new loop closure resets the pending
        # budget, which IS the abort semantics.
        self._gba_remaining = self.cfg.ba.gba_iters
        self.run_gba_slice()

    GBA_SLICE = 2   # LM iterations per slice (fixed: one compiled program)

    def run_gba_slice(self) -> bool:
        """Run one bounded global-BA slice if budget remains; returns
        True if a slice ran.  Each slice re-linearizes, so interleaving
        slices with tracking is safe — the map just converges over the
        next few keyframes instead of stalling tracking for the full
        10-iteration solve."""
        remaining = getattr(self, "_gba_remaining", 0)
        if remaining <= 0:
            return False
        info = self.map.global_ba(iters=self.GBA_SLICE)
        if not info.get("ran"):
            # a no-op slice (map momentarily too small) must not consume
            # the budget, or the post-loop polish could silently vanish
            return False
        self._gba_remaining = remaining - self.GBA_SLICE
        return True

    def _search_and_fuse(self, cur_group: List[int], loop_kf: int):
        """Project the loop-region point cloud into each corrected
        keyframe and fuse duplicates (ORBMatcher.fuse_kf_scw_mp semantics:
        radius 4*scale, TH_LOW; the loop landmark replaces the local one)."""
        from pyorbslam_jax.slam.local_mapping import fuse_match_batch

        m = self.map
        ks = m.keyframes
        lm = m.landmarks

        region = [loop_kf] + m.covisible_neighbors(loop_kf, 10)
        pts: Set[int] = set()
        for k2 in region:
            ids = lm.resolve(ks.obs_lm[k2])
            pts.update(int(i) for i in ids[ids >= 0] if lm.alive[i])
        if not pts:
            return 0
        n_fused = 0
        loop_ids = np.fromiter(pts, np.int32)

        cap = 1024
        while cap < len(loop_ids) and cap < self.cfg.tracking.max_local_points:
            cap *= 2
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: min(len(loop_ids), cap)] = loop_ids[:cap]
        safe = np.maximum(p_ids, 0)

        T = 8
        for c0 in range(0, len(cur_group), T):
            chunk = cur_group[c0:c0 + T]
            tgt = (chunk + [chunk[0]] * T)[:T]
            sel = np.asarray(tgt)
            matches = np.asarray(fuse_match_batch(
                jnp.asarray(lm.pos[safe]), jnp.asarray(lm.desc[safe]),
                jnp.asarray(lm.normal[safe]), jnp.asarray(lm.dmin[safe]),
                jnp.asarray(lm.dmax[safe]), jnp.asarray(p_ids >= 0),
                jnp.asarray(ks.kp_xy[sel]), jnp.asarray(ks.kp_octave[sel]),
                jnp.asarray(ks.kp_angle[sel]), jnp.asarray(ks.kp_desc[sel]),
                jnp.asarray(ks.kp_valid[sel]), jnp.asarray(ks.u_right[sel]),
                jnp.asarray(ks.Tcw[sel]), self.cfg, radius_mult=4.0,
            ))
            for ti, target_kf in enumerate(chunk):
                match = matches[ti]
                for slot in np.nonzero(match >= 0)[0]:
                    p = int(p_ids[slot])
                    if p < 0 or not lm.alive[p]:
                        continue
                    p = int(lm.resolve(np.asarray([p]))[0])
                    if p < 0 or not lm.alive[p]:
                        continue
                    feat = int(match[slot])
                    q = int(ks.obs_lm[target_kf, feat])
                    if q == p:
                        continue
                    if q >= 0 and lm.alive[q]:
                        m.replace_landmark(q, p)   # loop point wins
                    else:
                        m.core.add_observation(p, target_kf, feat)
                    n_fused += 1
        return n_fused

    def on_keyframe(self, kf: int, bow: Dict[int, float]) -> bool:
        """Run the full loop-closing pipeline; returns True if a loop was
        closed (LoopClosing.run single iteration).  Stage wall-clock
        lands in ``self.times`` (surfaced by the scale profiler)."""
        t0 = time.perf_counter()
        cands = self.detect(kf, bow)
        self.times["loop.detect"] += time.perf_counter() - t0
        if not cands:
            return False
        t0 = time.perf_counter()
        hit = self.compute_sim3(kf, cands)
        self.times["loop.sim3"] += time.perf_counter() - t0
        if hit is None:
            return False
        loop_kf, Scw, match_map = hit
        t0 = time.perf_counter()
        self.correct(kf, loop_kf, Scw, match_map)
        self.times["loop.correct"] += time.perf_counter() - t0
        return True
