"""SlamMap: keyframes + landmarks + observations + covisibility + local BA.

The host-side map backend (the array redesign of Map.py / KeyFrame.py /
MapPoint.py bookkeeping) plus the device-side Schur BA invocation.  The
pointer-chasing structures — the landmark->observer inverse index and the
covisibility weights — live in the NATIVE map core (native/mapcore.cpp),
which attaches directly to the numpy stores (obs_lm, u_right, n_obs,
alive, ...) so there is exactly one owner of observation state.  This is
the array-program analog of the reference's C++ runtime layer
(pyORBExtractor / g2o); Python keeps only the tiny spanning-tree /
loop-edge dicts, and the BA problem is assembled natively into bucketed
fixed-shape arrays dispatched to the batched Schur LM engine.

Reference semantics preserved:
  * covisibility edges at weight >= 15, ordered descending
    (KeyFrame.update_connections:145-203 — note the reference's
    update_best_covisibles ascending-sort bug is deliberately fixed,
    SURVEY.md §6);
  * local BA neighborhood: the KF + its covisibles free, second-ring
    observers fixed, KF 0 always fixed (Optimizer.py:210-260);
  * observation erasure after BA outlier gating (Optimizer.py:336-353),
    landmarks dying when support collapses (MapPoint.erase_observation);
  * map-point culling by found/visible ratio < 0.25 or weak early
    support (LocalMapping.map_point_culling:125-150);
  * normal/depth refresh after BA (MapPoint.update_normal_and_depth).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.config import SlamConfig
from pyorbslam_jax.native.mapcore_ffi import MapCore
from pyorbslam_jax.optim import ba
from pyorbslam_jax.slam.mapstore import KeyFrameStore, LandmarkStore

COVIS_TH = 15


@jax.jit
def _pack_ba_result(cam_Tcw, pnt_pos, inlier):
    """BA write-back in one int32 buffer (one device->host read instead
    of three): [cam_Tcw bits 16C | pnt_pos bits 3P | inlier bits O/32]
    — the inlier mask is bitpacked (a 256k-observation bucket otherwise
    reads back 1 MB of booleans)."""
    bits = inlier.astype(jnp.uint32).reshape(-1, 32)
    words = (bits << jnp.arange(32, dtype=jnp.uint32)[None, :]).sum(
        axis=1, dtype=jnp.uint32)
    return jnp.concatenate([
        jax.lax.bitcast_convert_type(cam_Tcw, jnp.int32).reshape(-1),
        jax.lax.bitcast_convert_type(pnt_pos, jnp.int32).reshape(-1),
        jax.lax.bitcast_convert_type(words, jnp.int32),
    ])


def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


@dataclasses.dataclass
class SlamMap:
    cfg: SlamConfig
    landmark_capacity: int = 1 << 18
    keyframe_capacity: int = 4096

    def __post_init__(self):
        self.landmarks = LandmarkStore(self.landmark_capacity)
        self.keyframes = KeyFrameStore(
            self.keyframe_capacity, self.cfg.orb.max_keypoints
        )
        self.times = defaultdict(float)   # BA-stage wall clock (seconds)
        self.counters = defaultdict(int)  # BA-stage event counts
        self.core = self._make_core()
        # spanning tree (parent = strongest covisible at insertion)
        self.parent: Dict[int, int] = {}
        self.children: Dict[int, set] = {}
        self.loop_edges: Dict[int, set] = {}
        # culled keyframes: kf -> (live-parent-at-cull, Tcp) where
        # Tcp = Tcw_kf @ inv(Tcw_parent) frozen at cull time — the
        # reference's KeyFrame.mTcp (KeyFrame.py:411), chained by
        # System.save_trajectory_kitti through dead ancestors
        # (System.py:124-145) so frame export survives keyframe culling
        self.dead_anchor: Dict[int, Tuple[int, np.ndarray]] = {}

    def _make_core(self) -> MapCore:
        ks, lm = self.keyframes, self.landmarks
        return MapCore(ks.obs_lm, ks.u_right, ks.kp_octave, lm.n_obs,
                       lm.alive, lm.replaced_by, lm.found, lm.visible)

    def rebuild_core(self):
        """Rebuild the native index from the dense obs_lm table (used by
        checkpoint restore).  n_obs is recounted from scratch."""
        self.landmarks.n_obs[:] = 0
        self.core = self._make_core()
        for kf in range(self.keyframes.n):
            if self.keyframes.alive[kf]:
                self.core.add_keyframe(kf)
        for kf in range(self.keyframes.n):
            if self.keyframes.alive[kf]:
                self.update_connections(kf)

    def resolve_ref(self, kf: int, Tcr: np.ndarray):
        """Chain a frame's (ref-KF, Tcr) through culled ancestors to the
        nearest LIVE keyframe (System.py:124-145 while-is-bad loop).
        Returns (live_kf, Tcr') with Tcr' @ Tcw[live_kf] == frame pose."""
        while kf in self.dead_anchor:
            parent, Tcp = self.dead_anchor[kf]
            if parent == kf:    # orphan cull (KF 0): nothing to chain to
                break
            Tcr = Tcr @ Tcp
            kf = parent
        return kf, Tcr

    # ------------- keyframe insertion -------------

    def add_keyframe(self, frame_np: dict, Tcw: np.ndarray, assign: np.ndarray,
                     frame_id: int, timestamp: float,
                     kp_node: Optional[np.ndarray] = None) -> int:
        """frame_np: dict of numpy arrays (xy, octave, angle, desc, valid,
        u_right, depth); assign: (N,) landmark id per feature (-1 = none)."""
        kf = self.keyframes.add(
            Tcw=Tcw, frame_id=frame_id, timestamp=timestamp,
            kp_xy=frame_np["xy"], kp_octave=frame_np["octave"],
            kp_angle=frame_np["angle"], kp_desc=frame_np["desc"],
            kp_valid=frame_np["valid"], u_right=frame_np["u_right"],
            depth=frame_np["depth"], obs_lm=assign.astype(np.int32),
            kp_node=kp_node,
        )
        self.core.add_keyframe(kf)
        self.update_connections(kf)
        return kf

    def update_connections(self, kf: int):
        """Recount shared-landmark weights for ``kf`` (KeyFrame.py:145-203)
        in the native core; maintain the spanning tree here."""
        _, _, strongest = self.core.update_connections(kf, COVIS_TH)
        if strongest >= 0 and kf not in self.parent and kf != 0:
            self.parent[kf] = strongest
            self.children.setdefault(strongest, set()).add(kf)

    def covisible_neighbors(self, kf: int, n: Optional[int] = None) -> List[int]:
        """Neighbors ordered by weight DESC (intended semantics; the
        reference's incremental update sorts ascending by mistake)."""
        ids, _ = self.core.neighbors(kf, cap=(n if n is not None else 4096))
        return ids.tolist()

    def covis_weight(self, a: int, b: int) -> int:
        return self.core.covis_weight(a, b)

    # ------------- observation management -------------

    def erase_observation(self, lm: int, kf: int):
        self.core.erase_observation(lm, kf)

    def kill_landmark(self, lm: int):
        self.core.kill_landmark(lm)

    def replace_landmark(self, lm: int, by: int):
        """MapPoint.replace (MapPoint.py:157-182): forward all observations."""
        self.core.replace_landmark(lm, by)

    # ------------- maintenance -------------

    def cull_map_points(self, recent_ids: np.ndarray, current_kf: int,
                        created_kf: np.ndarray):
        """LocalMapping.map_point_culling: kill points with found/visible
        < 0.25, or with <= 3 stereo-equivalent observations 2-3 KFs after
        creation."""
        lm = self.landmarks
        recent_ids = np.asarray(recent_ids, np.int64)
        if len(recent_ids) == 0:
            return
        alive = lm.alive[recent_ids]
        ratio = lm.found[recent_ids] / np.maximum(lm.visible[recent_ids], 1)
        age = current_kf - created_kf[recent_ids]
        kill = alive & ((ratio < 0.25) | ((age >= 2) & (lm.n_obs[recent_ids] <= 3)))
        for p in recent_ids[kill]:
            self.core.kill_landmark(int(p))

    def update_landmark_geometry(self, lm_ids: np.ndarray):
        """MapPoint.update_normal_and_depth for a batch of landmarks,
        vectorized over a native CSR observer dump."""
        lm = self.landmarks
        lm_ids = np.asarray(lm_ids, np.int32)
        lm_ids = lm_ids[lm.alive[lm_ids]]
        if len(lm_ids) == 0:
            return
        off, pair_k, pair_f = self.core.observers_csr(lm_ids)
        counts = np.diff(off)
        has = counts > 0
        ids = lm_ids[has]
        if len(ids) == 0:
            return
        pair_l = np.repeat(np.arange(len(lm_ids), dtype=np.int32), counts)
        sel = has[pair_l]
        # re-index pair_l into the filtered id list
        remap = np.cumsum(has) - 1
        pair_l = remap[pair_l[sel]].astype(np.int32)
        pair_k = pair_k[sel]
        pos = lm.pos[ids]

        Tcw = self.keyframes.Tcw[pair_k]
        Ow = -np.einsum("mji,mj->mi", Tcw[:, :3, :3], Tcw[:, :3, 3])
        d = pos[pair_l] - Ow
        n = np.linalg.norm(d, axis=1)
        ok = n > 1e-6
        dn = np.where(ok[:, None], d / np.maximum(n, 1e-12)[:, None], 0.0)
        sums = np.zeros((len(ids), 3), np.float64)
        np.add.at(sums, pair_l, dn)
        nn = np.linalg.norm(sums, axis=1)   # mean dir ∝ sum dir
        upd = nn > 1e-6
        lm.normal[ids[upd]] = (sums[upd] / nn[upd, None]).astype(np.float32)

        # depth band from the reference (first) observation
        ref_kf = pair_k[off[:len(lm_ids)][has]]
        ref_feat = pair_f[off[:len(lm_ids)][has]]
        Tr = self.keyframes.Tcw[ref_kf]
        Owr = -np.einsum("mji,mj->mi", Tr[:, :3, :3], Tr[:, :3, 3])
        dist = np.linalg.norm(pos - Owr, axis=1)
        level = self.keyframes.kp_octave[ref_kf, ref_feat]
        sf = self.cfg.orb.scale_factor
        max_dist = dist * sf ** level
        min_dist = max_dist / (sf ** (self.cfg.orb.n_levels - 1))
        lm.dmax[ids] = 1.2 * max_dist
        lm.dmin[ids] = 0.8 * min_dist
        lm.mark_dirty(ids)

    # ------------- global bundle adjustment -------------

    def global_ba(self, iters: Optional[int] = None) -> dict:
        """Optimizer.bundle_adjustment (Optimizer.py:21-121): all KFs and
        landmarks, KF 0 fixed, gba_iters (10) LM iterations — run after
        loop closure.  ``iters`` overrides the iteration count for
        BOUNDED SLICES: the loop closer amortizes the full budget across
        subsequent keyframes (the reference's backgrounded, abortable GBA
        thread, LoopClosing.py:342-436, redesigned as interleaved slices
        — each slice re-linearizes, so splitting is safe)."""
        C_live = [k for k in range(self.keyframes.n) if self.keyframes.alive[k]]
        pnt_ids = self.core.observed_landmarks(self.landmarks.n)
        if len(C_live) < 2 or len(pnt_ids) < 50:
            return dict(ran=False)
        # engine ladder: dense reduced system in the small-map regime;
        # the multi-device sharded Schur engine when more than one device
        # is visible (landmarks/observations sharded, reduced camera
        # system psum'd, parallel/dist_ba.py); otherwise single-device
        # implicit-Schur CG, which scales to the full KITTI-00 map
        if len(C_live) <= 96:
            engine = "dense"
        elif len(jax.devices()) > 1:
            engine = "dist"
        else:
            engine = "cg"
        # the reference's GBA is a single robust phase of gba_iters (10)
        # LM iterations (Optimizer.bundle_adjustment, Optimizer.py:21-121
        # with bRobust=True and no re-gated second phase)
        info = self._run_ba(
            cams=C_live, n_free=len(C_live), pnt_ids=pnt_ids,
            iters1=(self.cfg.ba.gba_iters if iters is None else iters),
            iters2=0,
            erase_outliers=False, engine=engine,
        )
        if info.get("ran"):
            self.counters[f"gba.{engine}"] += 1
        return info

    # ------------- local bundle adjustment -------------

    def reprojection_chi2(self, huber_delta: float = 2.7955) -> float:
        """Mean Huberized stereo-reprojection chi2 over every live
        observation — the map's own quality metric, used by the loop
        corrector's accept/rollback A/B (a correction that raises this
        on identical topology made the map worse).  delta^2 = 7.815,
        the reference's stereo chi2 gate."""
        ks, lm = self.keyframes, self.landmarks
        n_kf = ks.n
        if n_kf == 0:
            return 0.0
        obs = ks.obs_lm[:n_kf]
        kf_alive = ks.alive[:n_kf, None]
        mask = (obs >= 0) & kf_alive
        safe = np.maximum(obs, 0)
        mask &= lm.alive[safe]
        ki, fi = np.nonzero(mask)
        if len(ki) == 0:
            return 0.0
        ids = obs[ki, fi]
        P = lm.pos[ids]
        T = ks.Tcw[ki]
        Pc = np.einsum("mij,mj->mi", T[:, :3, :3], P) + T[:, :3, 3]
        z = np.maximum(Pc[:, 2], 1e-6)
        c = self.cfg.camera
        u = c.fx * Pc[:, 0] / z + c.cx
        v = c.fy * Pc[:, 1] / z + c.cy
        du = u - ks.kp_xy[ki, fi, 0]
        dv = v - ks.kp_xy[ki, fi, 1]
        ur_obs = ks.u_right[ki, fi]
        dur = np.where(ur_obs > 0, (u - c.bf / z) - ur_obs, 0.0)
        inv_s2 = np.asarray(self.cfg.orb.inv_level_sigma2)[
            ks.kp_octave[ki, fi]]
        chi2 = (du * du + dv * dv + dur * dur) * inv_s2
        # Huber: quadratic below delta^2, linear above — one gross
        # outlier must not dominate the map-level mean
        d2 = huber_delta * huber_delta
        e = np.sqrt(np.maximum(chi2, 1e-12))
        rho = np.where(chi2 <= d2, chi2, 2.0 * huber_delta * e - d2)
        # behind-camera observations are maximally wrong
        rho = np.where(Pc[:, 2] <= 0, 2.0 * huber_delta * 50.0, rho)
        return float(rho.mean())

    def local_ba(self, kf: int, split: bool = False) -> dict:
        """Assemble + run the Schur BA over the covisible neighborhood of
        ``kf``; write back poses/points and erase outlier observations.
        With ``split=True`` the solve is only DISPATCHED: the result dict
        carries ``pending`` for a later :meth:`local_ba_apply` — the
        pipelined schedule reads the solution one frame later, under the
        chip's next tracking step."""
        bacfg = self.cfg.ba
        cams, n_free, pnt_ids = self.core.local_ba_gather(
            kf, bacfg.max_local_kfs, bacfg.max_local_points,
            2 * bacfg.max_local_kfs)
        return self._run_ba(
            cams=cams, n_free=n_free, pnt_ids=pnt_ids,
            iters1=bacfg.local_ba_iters1, iters2=bacfg.local_ba_iters2,
            erase_outliers=True, split=split,
            max_move=bacfg.local_ba_max_move_m,
        )

    @contextlib.contextmanager
    def _t(self, label: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[label] += time.perf_counter() - t0

    def _run_ba(self, cams, n_free: int, pnt_ids,
                iters1: int, iters2: int, erase_outliers: bool,
                engine: str = "dense", split: bool = False,
                max_move: Optional[float] = None) -> dict:
        """Assemble bucketed fixed-shape arrays (native observation
        gather), dispatch the Schur BA (dense reduced system, or
        implicit-Schur CG for global scale), write back, optionally erase
        outlier observations."""
        if engine in ("cg", "dist"):
            # dist uses the implicit-Schur CG engine sharded over the
            # mesh, so it takes the same full-scale buckets — a KITTI-00
            # global map must never be truncated to the dense caps
            cam_buckets = [128, 256, 512, 1024, 2048, 4096]
            pnt_buckets = [16384, 32768, 65536, 131072, 262144]
            obs_buckets = [65536, 131072, 262144, 524288, 1048576]
        else:
            cam_buckets = [8, 16, 32, 64, 128, 256]
            pnt_buckets = [1024, 2048, 4096, 8192, 16384, 32768, 65536]
            obs_buckets = [4096, 8192, 16384, 32768, 65536, 131072, 262144]
        cams = np.asarray(cams, np.int32)
        pnt_ids = np.asarray(pnt_ids, np.int32)
        C = _bucket(len(cams), cam_buckets)
        P = _bucket(len(pnt_ids), pnt_buckets)
        cams = cams[:C]
        n_free = min(n_free, C)
        pnt_ids = pnt_ids[:P]

        ks = self.keyframes
        with self._t("ba.assemble"):
            oc, op, okf, oft = self.core.assemble_obs(
                cams, pnt_ids, cap=obs_buckets[-1])
        n_obs = len(oc)
        if n_obs < 20 or len(pnt_ids) < 10:
            return dict(ran=False)
        O = _bucket(n_obs, obs_buckets)
        n_obs = min(n_obs, O)
        oc, op, okf, oft = oc[:n_obs], op[:n_obs], okf[:n_obs], oft[:n_obs]
        inv_sigma2 = np.asarray(self.cfg.orb.inv_level_sigma2)

        cam_Tcw = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
        cam_Tcw[: len(cams)] = ks.Tcw[cams]
        cam_fixed = np.ones(C, bool)
        for i, k in enumerate(cams):
            cam_fixed[i] = (i >= n_free) or (k == 0)

        # sort by point id (the BA grid layout groups observations per
        # point); within a point, FREE cameras first — when a
        # heavily-observed point exceeds the grid width K, the slots
        # dropped are fixed-camera ones, which only constrain the
        # (already over-determined) point, not the poses being solved
        order = np.lexsort((cam_fixed[oc], op))
        oc, op, okf, oft = oc[order], op[order], okf[order], oft[order]
        pnt_pos = np.zeros((P, 3), np.float32)
        pnt_pos[: len(pnt_ids)] = self.landmarks.pos[pnt_ids]
        pnt_active = np.zeros(P, bool)
        pnt_active[: len(pnt_ids)] = True

        ocp = np.zeros(O, np.int32)
        # padding rows carry the LAST point id so the sorted order holds
        # through the pad tail (they are inert: obs_active False)
        opp = np.full(O, P - 1, np.int32)
        ouvr = np.zeros((O, 3), np.float32)
        oisig = np.zeros(O, np.float32)
        oact = np.zeros(O, bool)
        ocp[:n_obs] = oc
        opp[:n_obs] = op
        ouvr[:n_obs, 0] = ks.kp_xy[okf, oft, 0]
        ouvr[:n_obs, 1] = ks.kp_xy[okf, oft, 1]
        ouvr[:n_obs, 2] = ks.u_right[okf, oft]
        oisig[:n_obs] = inv_sigma2[ks.kp_octave[okf, oft]]
        oact[:n_obs] = True

        c = self.cfg.camera
        cam5 = jnp.asarray([c.fx, c.fy, c.cx, c.cy, c.bf], jnp.float32)
        if engine == "dist":
            # multi-device sharded Schur engine (parallel/dist_ba.py):
            # observations regrouped so each lands on its point's owner
            # shard; one psum of the reduced camera system per iteration
            from pyorbslam_jax.parallel import dist_ba

            mesh = dist_ba.make_mesh()
            n_shards = mesh.shape["map"]
            if P % n_shards:
                P = (P // n_shards + 1) * n_shards
                pnt_pos = np.zeros((P, 3), np.float32)
                pnt_pos[: len(pnt_ids)] = self.landmarks.pos[pnt_ids]
                pnt_active = np.zeros(P, bool)
                pnt_active[: len(pnt_ids)] = True
            new_pnt, (g_oc, g_uvr, g_isig), g_act = \
                dist_ba.group_observations_by_point_shard(
                    opp[:n_obs], P, n_shards,
                    (ocp[:n_obs], ouvr[:n_obs], oisig[:n_obs]))
            prob = ba.BAProblem(
                cam_Tcw=jnp.asarray(cam_Tcw),
                cam_fixed=jnp.asarray(cam_fixed),
                pnt_pos=jnp.asarray(pnt_pos),
                pnt_active=jnp.asarray(pnt_active),
                obs_cam=jnp.asarray(g_oc),
                obs_pnt=jnp.asarray(new_pnt),
                obs_uvr=jnp.asarray(g_uvr),
                obs_inv_sigma2=jnp.asarray(g_isig),
                obs_active=jnp.asarray(g_act),
                cam=cam5,
            )
            sharded = dist_ba.shard_problem(prob, mesh)
            d_cam, d_pnt, _ = dist_ba.distributed_bundle_adjust_cg(
                sharded, mesh, n_cam=C, iters1=iters1, iters2=iters2)
            new_Tcw = np.asarray(d_cam)
            new_pos = np.asarray(d_pnt)
            inlier = None
        elif engine == "cg":
            prob = ba.BAProblem(
                cam_Tcw=jnp.asarray(cam_Tcw),
                cam_fixed=jnp.asarray(cam_fixed),
                pnt_pos=jnp.asarray(pnt_pos),
                pnt_active=jnp.asarray(pnt_active),
                obs_cam=jnp.asarray(ocp),
                obs_pnt=jnp.asarray(opp),
                obs_uvr=jnp.asarray(ouvr),
                obs_inv_sigma2=jnp.asarray(oisig),
                obs_active=jnp.asarray(oact),
                cam=cam5,
            )
            with self._t("ba.solve"):
                from pyorbslam_jax.optim import ba_cg

                res = ba_cg.bundle_adjust_cg(prob, iters1=iters1,
                                             iters2=iters2)
                out = np.asarray(_pack_ba_result(res.cam_Tcw, res.pnt_pos,
                                                 res.obs_inlier))
            new_Tcw = out[: 16 * C].view(np.float32).reshape(C, 4, 4)
            new_pos = out[16 * C: 16 * C + 3 * P].view(np.float32).reshape(P, 3)
            inlier = np.unpackbits(
                out[16 * C + 3 * P:].view(np.uint8),
                bitorder="little")[:O].astype(bool)
        else:
            # dense engine: the (P, K) observation grid — scatter-free
            # Schur assembly (optim/ba.py:BAGridProblem).  K is chosen
            # adaptively from {8, 16, 32}: the smallest width that drops
            # no FREE-camera observation (grid rows are free-cams-first,
            # so slots beyond K shed fixed-anchor redundancy first).
            # Static K per bucket keeps at most 3 compiled variants;
            # K=8 covers the common case (mean track length 2-3).
            counts = np.bincount(op[:n_obs], minlength=P)
            K = 8
            if counts.max(initial=0) > 8:
                free_counts = np.bincount(
                    op[:n_obs][~cam_fixed[oc[:n_obs]]], minlength=P)
                mfree = int(free_counts.max(initial=0))
                for k_try in (16, 32):
                    if mfree > K:
                        K = k_try
                dropped_free = int(np.clip(free_counts - K, 0, None).sum())
                if dropped_free:
                    self.counters["ba.grid_dropped_free_obs"] += dropped_free
            # packed upload (grid_pack_from_obs): i16 cam ids, 1/16-px
            # i16 fixed-point (u, v, u_r), u8 octaves with the
            # inv-sigma2 lookup on device — half the bytes per dispatch
            g_cam, g_uvrq, g_oct, g_act, slot, kept, n_drop = \
                ba.grid_pack_from_obs(oc, op, ouvr[:n_obs],
                                      ks.kp_octave[okf, oft], P, K=K)
            if n_drop:
                self.counters["ba.grid_dropped_obs"] += n_drop
            with self._t("ba.solve"):
                res = ba.bundle_adjust_grid_packed(
                    jnp.asarray(cam_Tcw), jnp.asarray(cam_fixed),
                    jnp.asarray(pnt_pos), jnp.asarray(pnt_active),
                    jnp.asarray(g_cam), jnp.asarray(g_uvrq),
                    jnp.asarray(g_oct), jnp.asarray(g_act), cam5,
                    jnp.asarray(inv_sigma2, jnp.float32),
                    iters1=iters1, iters2=iters2)
                handle = _pack_ba_result(res.cam_Tcw, res.pnt_pos,
                                         res.g_inlier.reshape(-1))
                if hasattr(handle, "copy_to_host_async"):
                    handle.copy_to_host_async()
            pend = dict(
                handle=handle, C=C, P=P, O=O, g_shape=g_act.shape,
                op=op, okf=okf, slot=slot, kept=kept,
                cams=cams, cam_fixed=cam_fixed, n_free=n_free,
                pnt_ids=pnt_ids, n_obs=n_obs,
                erase_outliers=erase_outliers, max_move=max_move,
            )
            if split:
                return dict(ran=True, pending=pend, n_cams=len(cams),
                            n_free=n_free, n_points=len(pnt_ids),
                            n_obs=n_obs)
            return self.local_ba_apply(pend)

        return self._ba_writeback(
            cams, cam_fixed, n_free, pnt_ids, new_Tcw, new_pos, inlier,
            op, okf, n_obs, erase_outliers, max_move=max_move)

    def local_ba_apply(self, pend: dict) -> dict:
        """Consume a split dense-BA dispatch: ONE host read, write back
        poses/points, erase outliers, refresh landmark geometry."""
        C, P, O = pend["C"], pend["P"], pend["O"]
        with self._t("ba.read"):
            out = np.asarray(pend["handle"])
        new_Tcw = out[: 16 * C].view(np.float32).reshape(C, 4, 4)
        new_pos = out[16 * C: 16 * C + 3 * P].view(np.float32).reshape(P, 3)
        g_size = int(np.prod(pend["g_shape"]))
        g_inl = np.unpackbits(
            out[16 * C + 3 * P:].view(np.uint8),
            bitorder="little")[:g_size].astype(bool).reshape(pend["g_shape"])
        op, slot, kept = pend["op"], pend["slot"], pend["kept"]
        inlier = np.ones(O, bool)
        inlier[: pend["n_obs"]][kept] = g_inl[op[kept], slot[kept]]
        return self._ba_writeback(
            pend["cams"], pend["cam_fixed"], pend["n_free"],
            pend["pnt_ids"], new_Tcw, new_pos, inlier,
            op, pend["okf"], pend["n_obs"], pend["erase_outliers"],
            max_move=pend.get("max_move"))

    def _ba_writeback(self, cams, cam_fixed, n_free, pnt_ids,
                      new_Tcw, new_pos, inlier, op, okf, n_obs,
                      erase_outliers, max_move=None) -> dict:
        ks = self.keyframes
        if max_move is not None:
            # local-BA sanity guard: a nominal refinement never moves a
            # camera meters.  A solve that "prefers" a distant optimum is
            # feeding on corrupted geometry (e.g. coherently mis-matched
            # landmarks) — dropping the write-back keeps the healthy
            # odometry poses and lets observation gating clean up
            # instead.  Reference parity note: g2o local BA has no such
            # guard, but it also runs f64 with strictly-local windows;
            # large legitimate corrections arrive via the pose graph /
            # GBA (uncapped).
            moves = []
            for i in range(n_free):
                if cam_fixed[i]:
                    continue
                Tn, To = new_Tcw[i], ks.Tcw[cams[i]]
                Cn = -Tn[:3, :3].T @ Tn[:3, 3]
                Co = -To[:3, :3].T @ To[:3, 3]
                moves.append(float(np.linalg.norm(Cn - Co)))
            if moves and max(moves) > max_move:
                self.counters["ba.rejected_writebacks"] += 1
                return dict(ran=True, rejected=True, n_cams=len(cams),
                            n_free=n_free, n_points=len(pnt_ids),
                            n_obs=n_obs, n_erased=0,
                            max_move=max(moves))
        self.counters["ba.accepted_writebacks"] += 1
        for i in range(n_free):
            if not cam_fixed[i]:
                ks.Tcw[cams[i]] = new_Tcw[i]
        self.landmarks.pos[pnt_ids] = new_pos[: len(pnt_ids)]
        self.landmarks.mark_dirty(pnt_ids)

        n_erased = 0
        if erase_outliers and inlier is not None:
            alive = self.landmarks.alive
            for o in np.nonzero(~inlier[:n_obs])[0]:
                lm = int(pnt_ids[op[o]])
                # apply-time guard (pipelined schedule): an interleaved
                # fuse may have replaced/killed this landmark since the
                # BA dispatch — the reference's equivalent erase on a
                # replaced MapPoint is a no-op, so skip
                if not alive[lm]:
                    continue
                self.core.erase_observation(lm, int(okf[o]))
                n_erased += 1

        with self._t("ba.geometry"):
            self.update_landmark_geometry(pnt_ids)
        return dict(
            ran=True, n_cams=len(cams), n_free=n_free,
            n_points=len(pnt_ids), n_obs=n_obs, n_erased=n_erased,
        )
