"""Local mapping: triangulation of new points, neighbor fuse, KF culling.

The remaining LocalMapping.py responsibilities beyond what System already
runs inline (process-new-keyframe bookkeeping, point culling, local BA):

  * :meth:`create_new_points` — LocalMapping.create_new_map_points
    (LocalMapping.py:152-308): for the 10 best covisible neighbors with
    baseline > b, run the batched epipolar triangulation kernel and
    register the surviving points with observations in both keyframes;
  * :meth:`fuse_neighbors` — LocalMapping.search_in_neighbors
    (LocalMapping.py:333-383): project the current KF's landmarks into
    first/second-ring neighbors and vice versa, merging duplicates by
    observation count (ORBMatcher.fuse_pkf_mp semantics; the chi2
    reprojection gates become the tight 3*scale search radius + TH_LOW);
  * :meth:`cull_keyframes` — LocalMapping.key_frame_culling
    (LocalMapping.py:385-427): drop covisible KFs whose tracked points
    are >= 90% redundant (seen by >= 3 other KFs at same-or-finer scale).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.config import SlamConfig
from pyorbslam_jax.ops import matching as match_ops
from pyorbslam_jax.ops import triangulation as tri_ops
from pyorbslam_jax.ops.hamming import popcount, unpack_bits
from pyorbslam_jax.slam.slam_map import SlamMap

from pyorbslam_jax.utils.precision import f32_matmuls

TRI_CAP = 512   # triangulation survivors read back per neighbor pair
TRI_Q = 1024    # free-feature compaction width for the epipolar match


@f32_matmuls
def _fuse_match_one(
    p_pos, p_desc, p_normal, p_dmin, p_dmax, p_active,
    f_xy, f_octave, f_angle, f_desc, f_valid, f_u_right,
    Tcw, cfg: SlamConfig, radius_mult: float = 3.0,
    level_hi: int = 1, stereo_gate: bool = True,
):
    """Project candidate landmarks into a keyframe and find the feature
    each one fuses with (radius radius_mult*scale[predicted level], TH_LOW;
    3.0 for neighbor fuse per fuse_pkf_mp, 4.0 for loop fuse per
    fuse_kf_scw_mp, ORBMatcher.py:395,482).  With level_hi=0 and
    stereo_gate=False this is search_by_projection_ckf_scw_mp
    (ORBMatcher.py:850-923, th=10): the loop-points-into-current-KF
    growth pass counted toward the >= 40 acceptance."""
    cam = jnp.asarray([cfg.camera.fx, cfg.camera.fy, cfg.camera.cx,
                       cfg.camera.cy, cfg.camera.bf], jnp.float32)
    bounds = jnp.asarray([0.0, cfg.camera.width - 1.0, 0.0,
                          cfg.camera.height - 1.0], jnp.float32)
    scale_factors = jnp.asarray(cfg.orb.scale_factors, jnp.float32)

    proj = match_ops.project_points(Tcw, p_pos, cam, bounds)
    Ow = match_ops.se3_center(Tcw)
    in_frustum = match_ops.frustum_gate(
        proj, p_normal, p_dmin, p_dmax, p_pos, Ow, viewing_cos_limit=0.5)
    active = p_active & in_frustum
    pred = match_ops.predict_scale(
        proj.dist, p_dmax / 1.2, float(np.log(cfg.orb.scale_factor)),
        cfg.orb.n_levels)
    radius = radius_mult * scale_factors[pred]

    idx, dist, matched = match_ops.match_by_projection(
        proj.u, proj.v, proj.ur,
        unpack_bits(p_desc), popcount(p_desc), radius,
        pred - 1, pred + level_hi, active,
        f_xy, f_octave, f_u_right, unpack_bits(f_desc), popcount(f_desc),
        f_valid, max_dist_th=match_ops.TH_LOW, ratio=None,
        stereo_gate=stereo_gate,
    )
    return jnp.where(matched, idx, -1)


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "radius_mult", "level_hi", "stereo_gate"))
def fuse_match_step(
    p_pos, p_desc, p_normal, p_dmin, p_dmax, p_active,
    f_xy, f_octave, f_angle, f_desc, f_valid, f_u_right,
    Tcw, cfg: SlamConfig, radius_mult: float = 3.0,
    level_hi: int = 1, stereo_gate: bool = True,
):
    return _fuse_match_one(
        p_pos, p_desc, p_normal, p_dmin, p_dmax, p_active,
        f_xy, f_octave, f_angle, f_desc, f_valid, f_u_right, Tcw, cfg,
        radius_mult, level_hi, stereo_gate)


@functools.partial(jax.jit, static_argnames=("scale_factor",))
def triangulate_ring_packed(
    ring,                       # DeviceKFRing.arrays (R, N, ...) tuple
    slot1, nb_slots,            # ring slot of the new KF, (B,) neighbors
    free1, nb_free,             # (N,), (B, N) bool: valid & unbound
    T1, nb_T,                   # (4,4), (B,4,4)
    cam5, baseline, scale_factors, level_sigma2,
    scale_factor: float = 1.2,
) -> jnp.ndarray:
    """:func:`ops.triangulation.triangulate_batch_packed` with every
    feature block gathered from the device keyframe ring — the only
    H2D payload per call is the free masks and poses (~10 KB)."""
    xyA, ocA, deA, urA, dpA, _ = ring
    r = tri_ops.triangulate_batch(
        xyA[slot1], ocA[slot1], deA[slot1], urA[slot1], dpA[slot1], free1,
        xyA[nb_slots], ocA[nb_slots], deA[nb_slots], urA[nb_slots],
        dpA[nb_slots], nb_free, nb_T,
        T1, cam5, baseline, scale_factors, level_sigma2, scale_factor)
    return jnp.concatenate([
        r.idx1, r.idx2, r.valid.astype(jnp.int32),
        jax.lax.bitcast_convert_type(r.pos_w, jnp.int32).reshape(
            r.pos_w.shape[0], -1),
    ], axis=1)


@functools.partial(jax.jit, static_argnames=("cfg", "radius_mult"))
def fuse_ring_batch(
    m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive,   # landmark mirror
    p_ids,                      # (cap,) landmark ids (-1 pad)
    ring, tgt_slots, tgt_Tcw,   # ring + (T,) target slots + (T,4,4)
    cfg: SlamConfig, radius_mult: float = 3.0,
):
    """:func:`fuse_match_batch` with candidate landmarks gathered from
    the device mirror and target keyframes from the ring."""
    xyA, ocA, deA, urA, _, vaA = ring
    safe = jnp.maximum(p_ids, 0)
    p_active = (p_ids >= 0) & m_alive[safe]
    return jax.vmap(
        lambda slot, T: _fuse_match_one(
            m_pos[safe], m_desc[safe], m_normal[safe],
            m_dmin[safe], m_dmax[safe], p_active,
            xyA[slot], ocA[slot], None, deA[slot], vaA[slot], urA[slot],
            T, cfg, radius_mult)
    )(tgt_slots, tgt_Tcw)


@functools.partial(jax.jit, static_argnames=("cfg", "radius_mult"))
def fuse_match_batch(
    p_pos, p_desc, p_normal, p_dmin, p_dmax, p_active,
    # per-target keyframe arrays, leading axis T:
    f_xy, f_octave, f_angle, f_desc, f_valid, f_u_right, Tcw,
    cfg: SlamConfig, radius_mult: float = 3.0,
):
    """Fuse one landmark set into T keyframes in a single dispatch
    (vmapped over targets) — one device call per KF instead of one per
    neighbor."""
    return jax.vmap(
        lambda xy, oc, an, de, va, ur, T: _fuse_match_one(
            p_pos, p_desc, p_normal, p_dmin, p_dmax, p_active,
            xy, oc, an, de, va, ur, T, cfg, radius_mult)
    )(f_xy, f_octave, f_angle, f_desc, f_valid, f_u_right, Tcw)


@functools.partial(
    jax.jit, static_argnames=("cfg", "scale_factor"))
def maintenance_ring_step(
    m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive,   # landmark mirror
    ring,                       # DeviceKFRing.arrays
    slot1, nb_slots, free1, nb_free, T1, nb_T,          # triangulation
    fuse_ids, tgt_slots, tgt_Tcw,                       # fuse: kf pts -> targets
    rev_ids,                                            # fuse: nb pts -> kf
    cam5, baseline, scale_factors, level_sigma2,
    cfg: SlamConfig, scale_factor: float = 1.2,
) -> jnp.ndarray:
    """The whole per-keyframe mapping pass as ONE device program and ONE
    packed read: epipolar triangulation over the ring neighbors
    (LocalMapping.create_new_map_points, LocalMapping.py:152-308), the
    current KF's landmarks fused into first/second-ring targets, and the
    neighbors' landmarks fused into the current KF
    (LocalMapping.search_in_neighbors, LocalMapping.py:333-383).  The
    three stages are data-independent given the dispatch-time map state,
    so XLA schedules them as one fused program; the host pays a single
    round trip instead of three.  Layout:
      [tri B*6N | fuse T*cap | rev cap2]  (int32)."""
    xyA, ocA, deA, urA, dpA, vaA = ring
    # compact both sides to their FREE features first (typically half
    # the budget): the epipolar Hamming matrix and every mask shrink 4x
    Q = min(TRI_Q, int(free1.shape[0]))
    q1 = jax.lax.top_k(free1.astype(jnp.float32), Q)[1]    # (Q,)
    q2 = jax.lax.top_k(nb_free.astype(jnp.float32), Q)[1]  # (B, Q)
    x1, o1, d1, u1, z1 = (a[slot1] for a in (xyA, ocA, deA, urA, dpA))
    tri = tri_ops.triangulate_batch(
        x1[q1], o1[q1], d1[q1], u1[q1], z1[q1], free1[q1],
        jnp.take_along_axis(xyA[nb_slots], q2[..., None], axis=1),
        jnp.take_along_axis(ocA[nb_slots], q2, axis=1),
        jnp.take_along_axis(deA[nb_slots], q2[..., None], axis=1),
        jnp.take_along_axis(urA[nb_slots], q2, axis=1),
        jnp.take_along_axis(dpA[nb_slots], q2, axis=1),
        jnp.take_along_axis(nb_free, q2, axis=1), nb_T,
        T1, cam5, baseline, scale_factors, level_sigma2, scale_factor)
    # compact survivors to TRI_CAP rows per neighbor before the read:
    # typically a few hundred candidates triangulate, so the read stays
    # small.  Indices map back to
    # frame-feature space through the free-compaction gathers.
    sel = jax.lax.top_k(tri.valid.astype(jnp.float32),
                        min(TRI_CAP, Q))[1]
    g = lambda a: jnp.take_along_axis(a, sel, axis=1)  # noqa: E731
    idx1_full = jnp.where(tri.idx1 >= 0,
                          q1[jnp.maximum(tri.idx1, 0)], -1)
    idx2_full = jnp.where(
        tri.idx2 >= 0,
        jnp.take_along_axis(q2, jnp.maximum(tri.idx2, 0), axis=1), -1)
    tri_packed = jnp.concatenate([
        g(idx1_full), g(idx2_full), g(tri.valid.astype(jnp.int32)),
        jax.lax.bitcast_convert_type(
            jnp.take_along_axis(tri.pos_w, sel[..., None], axis=1),
            jnp.int32).reshape(sel.shape[0], -1),
    ], axis=1)

    safe = jnp.maximum(fuse_ids, 0)
    p_active = (fuse_ids >= 0) & m_alive[safe]
    fuse = jax.vmap(
        lambda slot, T: _fuse_match_one(
            m_pos[safe], m_desc[safe], m_normal[safe],
            m_dmin[safe], m_dmax[safe], p_active,
            xyA[slot], ocA[slot], None, deA[slot], vaA[slot], urA[slot],
            T, cfg, 3.0)
    )(tgt_slots, tgt_Tcw)

    safe2 = jnp.maximum(rev_ids, 0)
    rev_active = (rev_ids >= 0) & m_alive[safe2]
    rev = _fuse_match_one(
        m_pos[safe2], m_desc[safe2], m_normal[safe2],
        m_dmin[safe2], m_dmax[safe2], rev_active,
        xyA[slot1], ocA[slot1], None, deA[slot1], vaA[slot1], urA[slot1],
        T1, cfg, 3.0)

    return jnp.concatenate(
        [tri_packed.ravel(), fuse.ravel(), rev])


@dataclasses.dataclass
class LocalMapper:
    cfg: SlamConfig
    map: SlamMap
    # device keyframe ring + landmark-mirror provider (wired by System):
    # when every participant keyframe is still in the ring, maintenance
    # kernels gather features on device instead of re-uploading them
    ring: Optional[object] = None
    mirror_fn: Optional[object] = None   # callable(force=True) -> mirror

    # ---------------- fused per-keyframe maintenance ----------------

    @staticmethod
    def _bucket(n):
        for b in (1024, 2048, 4096, 8192):
            if n <= b:
                return b
        return 16384

    def _tri_prep(self, kf: int):
        """Neighbor selection for triangulation (baseline > b, enough
        free features) — the host half of create_new_points."""
        m = self.map
        ks = m.keyframes
        cam = self.cfg.camera
        Ow1 = -ks.Tcw[kf, :3, :3].T @ ks.Tcw[kf, :3, 3]
        neighbors = []
        for nb in m.covisible_neighbors(kf, 10):
            Ow2 = -ks.Tcw[nb, :3, :3].T @ ks.Tcw[nb, :3, 3]
            if np.linalg.norm(Ow2 - Ow1) < cam.baseline:
                continue
            if (ks.kp_valid[nb] & (ks.obs_lm[nb] < 0)).sum() >= 10:
                neighbors.append(nb)
        free1 = ks.kp_valid[kf] & (ks.obs_lm[kf] < 0)
        if not neighbors or free1.sum() < 10:
            return None
        return neighbors[:4], free1, Ow1

    def _tri_apply(self, kf: int, neighbors, batch, Ow1) -> int:
        """Register surviving triangulations (the host half of
        create_new_points after the device read)."""
        m = self.map
        ks = m.keyframes
        lm = m.landmarks
        batch_i1, batch_i2, batch_valid, batch_pos = (
            tri_ops.unpack_tri_batch_np(batch))
        claimed = np.zeros(ks.n_features, bool)
        n_new = 0
        for bi, nb in enumerate(neighbors):
            valid = batch_valid[bi] & ~claimed[np.maximum(batch_i1[bi], 0)]
            if not valid.any():
                continue
            i1 = batch_i1[bi][valid]
            i2 = batch_i2[bi][valid]
            pos = batch_pos[bi][valid]
            claimed[i1] = True
            po = pos - Ow1
            dist = np.linalg.norm(po, axis=1)
            keep = dist > 1e-6
            i1, i2, pos, po, dist = (
                i1[keep], i2[keep], pos[keep], po[keep], dist[keep])
            # apply-time guard (pipelined schedule): another in-flight
            # item's fuse may have bound these features since dispatch —
            # binding over them would strand the existing landmark's
            # observation bookkeeping
            free = (ks.obs_lm[kf, i1] < 0) & (ks.obs_lm[nb, i2] < 0)
            i1, i2, pos, po, dist = (
                i1[free], i2[free], pos[free], po[free], dist[free])
            if len(i1) == 0:
                continue
            ids = lm.add(
                pos, ks.kp_desc[kf, i1], po / dist[:, None], dist,
                ks.kp_octave[kf, i1], self.cfg.orb.scale_factor,
                self.cfg.orb.n_levels, ref_kf=kf,
            )
            m.core.add_observations(ids, kf, i1)
            m.core.add_observations(ids, nb, i2)
            n_new += len(ids)
        return n_new

    def maintain(self, kf: int) -> dict:
        """The whole LocalMapping pass for one keyframe in ONE device
        dispatch + ONE packed read: dispatch + apply back-to-back (the
        synchronous schedule's shape; the pipelined schedule splits the
        two around the next frame's tracking dispatch so the read
        overlaps the chip)."""
        pend = self.maintain_dispatch(kf)
        if pend is None:
            n_new = self.create_new_points(kf)
            n_fused = self.fuse_neighbors(kf)
            return dict(new=n_new, fused=n_fused, fallback=True)
        return self.maintain_apply(pend)

    def maintain_dispatch(self, kf: int):
        """Host prep + the ONE maintenance dispatch
        (:func:`maintenance_ring_step`): triangulate over ring neighbors,
        fuse the KF's landmarks into its covisible targets, fuse the
        targets' landmarks back into the KF.  Returns an opaque pending
        record for :meth:`maintain_apply`, or None when the ring rotated
        a participant out (caller falls back to the separate-step path).
        Note one deliberate ordering difference from the reference
        (LocalMapping.run:91-99): points triangulated by this pass join
        the fuse candidate set at the NEXT keyframe, not this one — the
        fuse candidates are gathered at dispatch."""
        m = self.map
        ks = m.keyframes
        lm = m.landmarks

        tri = self._tri_prep(kf)
        ring1 = m.covisible_neighbors(kf, 5)
        targets = list(dict.fromkeys(
            ring1 + [k2 for k in ring1 for k2 in m.covisible_neighbors(k, 2)]))
        targets = [t for t in targets if t != kf and ks.alive[t]]
        targets = targets[: self.FUSE_TARGETS]
        cur_pts = lm.resolve(ks.obs_lm[kf])
        cur_pts = np.unique(cur_pts[cur_pts >= 0])
        cur_pts = cur_pts[lm.alive[cur_pts]]

        participants = [kf] + (tri[0] if tri else []) + targets
        slots = (self.ring.slots_for(participants)
                 if self.ring is not None and self.mirror_fn is not None
                 else None)
        if slots is None or (not targets and tri is None):
            return None
        slot1 = slots[0]
        B = 4
        if tri:
            neighbors, free1, Ow1 = tri
            nb_pad = (neighbors + [neighbors[0]] * B)[:B]
            nb_slots = np.asarray(
                [self.ring.slot_of[n] for n in nb_pad], np.int32)
            nb_free = ks.kp_valid[nb_pad] & (ks.obs_lm[nb_pad] < 0)
            nb_T = ks.Tcw[np.asarray(nb_pad)]
        else:
            neighbors, free1 = [], np.zeros(ks.n_features, bool)
            Ow1 = None
            nb_slots = np.full(B, slot1, np.int32)
            nb_free = np.zeros((B, ks.n_features), bool)
            nb_T = np.broadcast_to(ks.Tcw[kf], (B, 4, 4)).copy()

        T = self.FUSE_TARGETS
        tgt_pad = (targets + [targets[0] if targets else kf] * T)[:T]
        tgt_slots = np.asarray(
            [self.ring.slot_of[t] for t in tgt_pad], np.int32)
        tgt_T = ks.Tcw[np.asarray(tgt_pad)]
        cap = self._bucket(len(cur_pts)) if len(cur_pts) else 1024
        fuse_ids = np.full(cap, -1, np.int32)
        n_fwd = min(len(cur_pts), cap) if targets else 0
        fuse_ids[: n_fwd] = cur_pts[:n_fwd]

        ids = lm.resolve(ks.obs_lm[np.asarray(tgt_pad)].ravel())
        ids = ids[ids >= 0]
        ids = np.unique(ids[lm.alive[ids]])
        nb_pts = ids[~np.isin(ids, cur_pts, assume_unique=False)]
        nb_pts = nb_pts[: self.cfg.tracking.max_local_points]
        cap2 = self._bucket(len(nb_pts)) if len(nb_pts) else 1024
        rev_ids = np.full(cap2, -1, np.int32)
        rev_ids[: len(nb_pts)] = nb_pts

        cam = self.cfg.camera
        cam5 = jnp.asarray(
            [cam.fx, cam.fy, cam.cx, cam.cy, cam.bf], jnp.float32)
        mirror = self.mirror_fn()
        handle = maintenance_ring_step(
            *mirror, self.ring.arrays,
            jnp.int32(slot1), jnp.asarray(nb_slots), jnp.asarray(free1),
            jnp.asarray(nb_free), jnp.asarray(ks.Tcw[kf]), jnp.asarray(nb_T),
            jnp.asarray(fuse_ids), jnp.asarray(tgt_slots),
            jnp.asarray(tgt_T),
            jnp.asarray(rev_ids),
            cam5, jnp.float32(cam.baseline),
            jnp.asarray(self.cfg.orb.scale_factors, jnp.float32),
            jnp.asarray(self.cfg.orb.level_sigma2, jnp.float32),
            self.cfg, scale_factor=self.cfg.orb.scale_factor,
        )
        if hasattr(handle, "copy_to_host_async"):
            handle.copy_to_host_async()
        return dict(kf=kf, handle=handle, neighbors=neighbors, Ow1=Ow1,
                    targets=targets, fuse_ids=fuse_ids, rev_ids=rev_ids,
                    nb_pts=nb_pts, cur_pts=cur_pts, B=B, T=T, cap=cap)

    def maintain_apply(self, pend: dict) -> dict:
        """Consume one maintenance dispatch: ONE host read, then host
        registration (triangulations, fuse bindings, connection /
        geometry refresh)."""
        m = self.map
        kf = pend["kf"]
        B, T, cap = pend["B"], pend["T"], pend["cap"]
        neighbors, targets = pend["neighbors"], pend["targets"]
        packed = np.asarray(pend["handle"])
        nt = 6 * min(TRI_CAP, m.keyframes.n_features)
        tri_flat = packed[: B * nt].reshape(B, nt)
        fuse_m = packed[B * nt: B * nt + T * cap].reshape(T, cap)
        rev_m = packed[B * nt + T * cap:]

        n_new = self._tri_apply(kf, neighbors, tri_flat, pend["Ow1"]) \
            if neighbors else 0
        n_fused = 0
        for ti, target_kf in enumerate(targets):
            n_fused += self._apply_fuse_matches(target_kf, pend["fuse_ids"],
                                                fuse_m[ti])
        if len(pend["nb_pts"]):
            n_fused += self._apply_fuse_matches(kf, pend["rev_ids"], rev_m)
        if n_new or n_fused:
            m.update_connections(kf)
        if n_fused and len(pend["cur_pts"]):
            m.update_landmark_geometry(pend["cur_pts"])
        return dict(new=n_new, fused=n_fused, fallback=False)

    # ---------------- triangulation ----------------

    def create_new_points(self, kf: int, max_neighbors: int = 10) -> int:
        m = self.map
        ks = m.keyframes
        lm = m.landmarks
        cam = self.cfg.camera
        cam5 = jnp.asarray([cam.fx, cam.fy, cam.cx, cam.cy, cam.bf], jnp.float32)
        sf = jnp.asarray(self.cfg.orb.scale_factors, jnp.float32)
        s2 = jnp.asarray(self.cfg.orb.level_sigma2, jnp.float32)

        Ow1 = -ks.Tcw[kf, :3, :3].T @ ks.Tcw[kf, :3, 3]
        n_new = 0
        neighbors = []
        for nb in m.covisible_neighbors(kf, max_neighbors):
            Ow2 = -ks.Tcw[nb, :3, :3].T @ ks.Tcw[nb, :3, 3]
            if np.linalg.norm(Ow2 - Ow1) < cam.baseline:
                continue
            if (ks.kp_valid[nb] & (ks.obs_lm[nb] < 0)).sum() >= 10:
                neighbors.append(nb)
        B = 4  # fixed vmap width: top-B baselined neighbors per dispatch
        neighbors = neighbors[:B]
        free1 = ks.kp_valid[kf] & (ks.obs_lm[kf] < 0)
        if not neighbors or free1.sum() < 10:
            return 0
        padded = (neighbors + [neighbors[0]] * B)[:B]
        realn = len(neighbors)
        sel = np.asarray(padded)
        slots = (self.ring.slots_for([kf] + list(sel))
                 if self.ring is not None else None)
        if slots is not None:
            batch = triangulate_ring_packed(
                self.ring.arrays, jnp.int32(slots[0]), jnp.asarray(slots[1:]),
                jnp.asarray(free1),
                jnp.asarray(ks.kp_valid[sel] & (ks.obs_lm[sel] < 0)),
                jnp.asarray(ks.Tcw[kf]), jnp.asarray(ks.Tcw[sel]),
                cam5, jnp.float32(cam.baseline), sf, s2,
                scale_factor=self.cfg.orb.scale_factor,
            )
        else:
            batch = tri_ops.triangulate_batch_packed_jit(
                jnp.asarray(ks.kp_xy[kf]), jnp.asarray(ks.kp_octave[kf]),
                jnp.asarray(ks.kp_desc[kf]), jnp.asarray(ks.u_right[kf]),
                jnp.asarray(ks.depth[kf]), jnp.asarray(free1),
                jnp.asarray(ks.kp_xy[sel]), jnp.asarray(ks.kp_octave[sel]),
                jnp.asarray(ks.kp_desc[sel]), jnp.asarray(ks.u_right[sel]),
                jnp.asarray(ks.depth[sel]), jnp.asarray(
                    ks.kp_valid[sel] & (ks.obs_lm[sel] < 0)),
                jnp.asarray(ks.Tcw[sel]),
                jnp.asarray(ks.Tcw[kf]),
                cam5, jnp.float32(cam.baseline), sf, s2,
                scale_factor=self.cfg.orb.scale_factor,
            )
        batch_i1, batch_i2, batch_valid, batch_pos = (
            tri_ops.unpack_tri_batch_np(np.asarray(batch))  # ONE host read
        )
        claimed = np.zeros(ks.n_features, bool)  # one new point per feature
        for bi, nb in enumerate(neighbors):
            valid = batch_valid[bi] & ~claimed[np.maximum(batch_i1[bi], 0)]
            if not valid.any():
                continue
            i1 = batch_i1[bi][valid]
            i2 = batch_i2[bi][valid]
            pos = batch_pos[bi][valid]
            claimed[i1] = True
            # register: desc/normal/band from the KF1 observation
            po = pos - Ow1
            dist = np.linalg.norm(po, axis=1)
            keep = dist > 1e-6
            i1, i2, pos, po, dist = i1[keep], i2[keep], pos[keep], po[keep], dist[keep]
            free = (ks.obs_lm[kf, i1] < 0) & (ks.obs_lm[nb, i2] < 0)
            i1, i2, pos, po, dist = (
                i1[free], i2[free], pos[free], po[free], dist[free])
            if len(i1) == 0:
                continue
            ids = lm.add(
                pos, ks.kp_desc[kf, i1], po / dist[:, None], dist,
                ks.kp_octave[kf, i1], self.cfg.orb.scale_factor,
                self.cfg.orb.n_levels, ref_kf=kf,
            )
            m.core.add_observations(ids, kf, i1)
            m.core.add_observations(ids, nb, i2)
            n_new += len(ids)
        if n_new:
            m.update_connections(kf)
        return n_new

    # ---------------- fuse ----------------

    FUSE_TARGETS = 8  # fixed vmap width (ring1 top-5 + 3 second-ring)

    def _apply_fuse_matches(self, target_kf: int, p_ids_slot: np.ndarray,
                            match: np.ndarray) -> int:
        """Apply one target keyframe's fuse matches (ORBMatcher.fuse
        semantics): bind where the feature is free, replace-toward-the-
        better-observed landmark where it's a duplicate.  The common case
        (free feature, one candidate) is fully vectorized; conflicts —
        duplicate observations or two landmarks matching the same feature
        — fall through to the exact sequential path."""
        m = self.map
        ks = m.keyframes
        lm = m.landmarks

        slots = np.nonzero(match >= 0)[0]
        if len(slots) == 0:
            return 0
        p_arr = lm.resolve(p_ids_slot[slots])
        feats = match[slots]
        ok = (p_arr >= 0) & lm.alive[np.maximum(p_arr, 0)]
        p_arr, feats = p_arr[ok], feats[ok]
        if len(p_arr) == 0:
            return 0

        q_arr = ks.obs_lm[target_kf, feats]
        dup = (q_arr >= 0) & lm.alive[np.maximum(q_arr, 0)]
        same = q_arr == p_arr
        bind = ~dup & ~same
        # one bind per feature: keep the first, push the rest to the
        # sequential path (they will see the just-bound landmark there)
        first = np.zeros(len(feats), bool)
        first[np.unique(feats, return_index=True)[1]] = True
        easy = bind & first
        hard = ~same & ~easy

        bp, bf = p_arr[easy], feats[easy]
        m.core.add_observations(bp, target_kf, bf)
        n_fused = len(bp)

        for p, feat in zip(p_arr[hard].tolist(), feats[hard].tolist()):
            if not lm.alive[p]:
                continue
            q = int(ks.obs_lm[target_kf, feat])
            if q == p:
                continue
            if q >= 0 and lm.alive[q]:
                # duplicate: keep the better-observed landmark
                if lm.n_obs[p] >= lm.n_obs[q]:
                    m.replace_landmark(q, p)
                else:
                    m.replace_landmark(p, q)
            else:
                m.core.add_observation(p, target_kf, feat)
            n_fused += 1
        return n_fused

    def fuse_neighbors(self, kf: int) -> int:
        m = self.map
        ks = m.keyframes
        lm = m.landmarks

        ring1 = m.covisible_neighbors(kf, 5)
        targets = list(dict.fromkeys(
            ring1 + [k2 for k in ring1 for k2 in m.covisible_neighbors(k, 2)]))
        targets = [t for t in targets if t != kf and ks.alive[t]]
        targets = targets[: self.FUSE_TARGETS]
        if not targets:
            return 0

        cur_pts = lm.resolve(ks.obs_lm[kf])
        cur_pts = np.unique(cur_pts[cur_pts >= 0])
        cur_pts = cur_pts[lm.alive[cur_pts]]
        if len(cur_pts) == 0:
            return 0

        def bucket(n):
            for b in (1024, 2048, 4096, 8192):
                if n <= b:
                    return b
            return self.cfg.tracking.max_local_points

        cap = bucket(len(cur_pts))
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: len(cur_pts)] = cur_pts[:cap]
        safe = np.maximum(p_ids, 0)

        # pad the target list to the fixed vmap width (repeats are inert:
        # their matches are applied idempotently)
        T = self.FUSE_TARGETS
        tgt = (targets + [targets[0]] * T)[:T]
        sel = np.asarray(tgt)
        slots = (self.ring.slots_for(list(sel))
                 if self.ring is not None and self.mirror_fn is not None
                 else None)
        if slots is not None:
            mirror = self.mirror_fn(force=True)   # fresh landmark blocks
            matches = np.asarray(fuse_ring_batch(
                *mirror, jnp.asarray(p_ids),
                self.ring.arrays, jnp.asarray(slots),
                jnp.asarray(ks.Tcw[sel]), self.cfg,
            ))  # (T, cap)
        else:
            matches = np.asarray(fuse_match_batch(
                jnp.asarray(lm.pos[safe]), jnp.asarray(lm.desc[safe]),
                jnp.asarray(lm.normal[safe]), jnp.asarray(lm.dmin[safe]),
                jnp.asarray(lm.dmax[safe]), jnp.asarray(p_ids >= 0),
                jnp.asarray(ks.kp_xy[sel]), jnp.asarray(ks.kp_octave[sel]),
                jnp.asarray(ks.kp_angle[sel]), jnp.asarray(ks.kp_desc[sel]),
                jnp.asarray(ks.kp_valid[sel]), jnp.asarray(ks.u_right[sel]),
                jnp.asarray(ks.Tcw[sel]), self.cfg,
            ))  # (T, cap)

        n_fused = 0
        for ti, target_kf in enumerate(targets):
            n_fused += self._apply_fuse_matches(target_kf, p_ids, matches[ti])

        # reverse direction: neighbors' points into the current KF
        ids = lm.resolve(ks.obs_lm[np.asarray(targets)].ravel())
        ids = ids[ids >= 0]
        ids = np.unique(ids[lm.alive[ids]])
        nb_pts = ids[~np.isin(ids, cur_pts, assume_unique=False)]
        nb_pts = nb_pts[: self.cfg.tracking.max_local_points]
        if len(nb_pts):
            cap2 = bucket(len(nb_pts))
            p_ids2 = np.full(cap2, -1, np.int32)
            p_ids2[: len(nb_pts)] = np.asarray(nb_pts, np.int32)
            safe2 = np.maximum(p_ids2, 0)
            slots2 = (self.ring.slots_for([kf])
                      if self.ring is not None and self.mirror_fn is not None
                      else None)
            if slots2 is not None:
                mirror = self.mirror_fn(force=True)
                match = np.asarray(fuse_ring_batch(
                    *mirror, jnp.asarray(p_ids2),
                    self.ring.arrays, jnp.asarray(slots2),
                    jnp.asarray(ks.Tcw[[kf]]), self.cfg,
                ))[0]
            else:
                match = np.asarray(fuse_match_step(
                    jnp.asarray(lm.pos[safe2]), jnp.asarray(lm.desc[safe2]),
                    jnp.asarray(lm.normal[safe2]), jnp.asarray(lm.dmin[safe2]),
                    jnp.asarray(lm.dmax[safe2]), jnp.asarray(p_ids2 >= 0),
                    jnp.asarray(ks.kp_xy[kf]), jnp.asarray(ks.kp_octave[kf]),
                    jnp.asarray(ks.kp_angle[kf]), jnp.asarray(ks.kp_desc[kf]),
                    jnp.asarray(ks.kp_valid[kf]), jnp.asarray(ks.u_right[kf]),
                    jnp.asarray(ks.Tcw[kf]), self.cfg,
                ))
            n_fused += self._apply_fuse_matches(kf, p_ids2, match)

        if n_fused:
            m.update_connections(kf)
            m.update_landmark_geometry(cur_pts)
        return n_fused

    # ---------------- keyframe culling ----------------

    def cull_keyframes(self, kf: int, on_removed=None) -> int:
        m = self.map
        ks = m.keyframes
        n_culled = 0
        for cand in m.covisible_neighbors(kf):
            if cand == 0 or not ks.alive[cand]:
                continue
            if (ks.obs_lm[cand] >= 0).sum() < 30:
                continue
            n_pts, n_redundant = m.core.redundancy(cand)
            if n_pts > 0 and n_redundant > 0.9 * n_pts:
                self._remove_keyframe(cand)
                if on_removed is not None:
                    on_removed(cand)
                n_culled += 1
        return n_culled

    def _remove_keyframe(self, kf: int):
        """KeyFrame.set_bad_flag with the intended semantics (the
        reference's version calls missing methods, SURVEY.md §6):
        erase observations, reconnect covisibility, reparent children."""
        m = self.map
        ks = m.keyframes
        m.core.remove_keyframe(kf)
        parent = m.parent.get(kf)
        # freeze the relative pose to the (live) parent so frames whose
        # reference KF this was stay exportable after later corrections
        # (KeyFrame.mTcp, KeyFrame.py:411; consumed by map.resolve_ref)
        anchor = parent if parent is not None else 0
        Tcp = (ks.Tcw[kf] @ np.linalg.inv(ks.Tcw[anchor])).astype(np.float32)
        m.dead_anchor[kf] = (anchor, Tcp)
        # Reparent orphans by covisibility (KeyFrame.py:357-415 intended
        # semantics): repeatedly hand the (child, candidate) pair with the
        # globally strongest covisibility to that candidate parent, the
        # adopted child joining the candidate set; children with no
        # covisible candidate fall back to the dead KF's parent.
        fallback = parent if parent is not None else 0
        candidates = [fallback]
        remaining = list(m.children.get(kf, ()))
        while remaining:
            best_w, best_child, best_parent = 0, None, None
            for child in remaining:
                for cand in candidates:
                    w = m.covis_weight(child, cand)
                    if w > best_w:
                        best_w, best_child, best_parent = w, child, cand
            if best_child is None:
                break
            m.parent[best_child] = best_parent
            m.children.setdefault(best_parent, set()).add(best_child)
            candidates.append(best_child)
            remaining.remove(best_child)
        for child in remaining:
            m.parent[child] = fallback
            m.children.setdefault(fallback, set()).add(child)
        m.children.pop(kf, None)
        if parent is not None:
            m.children.get(parent, set()).discard(kf)
            m.parent.pop(kf, None)
        ks.alive[kf] = False
