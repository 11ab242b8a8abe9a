"""System facade: the full SLAM pipeline (tracking + local mapping).

API parity with the reference System (System.py:20-168):
``track_stereo``, ``save_trajectory_kitti``, ``reset``, ``shutdown``,
``activate/deactivate_localization_mode``.  The reference's three threads
become a synchronous interleaved schedule (SURVEY.md §2.3): each keyframe
insertion immediately runs the local-mapping step (covisibility update,
point culling, local Schur BA) before the next frame is tracked — same
semantics, deterministic order, no locks.

Loop closing / relocalization hook in as later stages on this same spine.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict, deque
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.config import SlamConfig
from pyorbslam_jax.io.kitti import save_trajectory_kitti
from pyorbslam_jax.ops import matching as match_ops
from pyorbslam_jax.ops.hamming import popcount, unpack_bits
from pyorbslam_jax.optim import pose_opt
from pyorbslam_jax.optim.epnp import epnp_ransac
from pyorbslam_jax.place import vocabulary as vocab_mod
from pyorbslam_jax.place.keyframe_db import KeyFrameDatabase
from pyorbslam_jax.place.vocabulary import Vocabulary
from pyorbslam_jax.slam.frame import (
    StereoFrame,
    build_stereo_frame_jit,
    pack_frame,
    unpack_frame_np,
    unproject,
)
from pyorbslam_jax.slam.slam_map import SlamMap
from pyorbslam_jax.slam.tracking import (
    fused_retrack_snapshot_step,
    fused_retrack_step,
    fused_track_chain_step,
    fused_track_step,
    fused_track_window,
    kf_snapshot,
    local_track_step,
    motion_track_step,
    unpack_bool_np,
)


def _cap_bucket(n: int, max_cap: int) -> int:
    """Pick a padded capacity bucket so device programs stay few-shaped
    while small local maps don't pay full-capacity compute."""
    for b in (2048, 4096, 8192):
        if n <= b and b <= max_cap:
            return b
    return max_cap


_MIRROR_FIELDS = ("pos", "desc", "normal", "dmin", "dmax", "alive")


@jax.jit
def _bow_match_jit(kf_desc, kf_node, q_active, f_bits, f_pop, f_node,
                   f_valid):
    """search_by_BoW as ONE dispatch (called eagerly this is dozens of
    per-op dispatches) — the relocalization candidate matcher."""
    return match_ops.match_by_bow(
        unpack_bits(kf_desc), popcount(kf_desc), kf_node, q_active,
        f_bits, f_pop, f_node, f_valid)


@jax.jit
def _bow_match_rot_jit(kf_desc, kf_node, q_active, f_bits, f_pop, f_node,
                       f_valid, kf_angle, f_angle):
    """search_by_BoW + rotation-consistency as ONE dispatch — the
    reference-keyframe fallback matcher (Tracking.py:329-356)."""
    idx, dist, matched = match_ops.match_by_bow(
        unpack_bits(kf_desc), popcount(kf_desc), kf_node, q_active,
        f_bits, f_pop, f_node, f_valid)
    matched = match_ops.rotation_consistency_mask(
        kf_angle, f_angle, jnp.maximum(idx, 0), matched)
    return idx, matched


@jax.jit
def _mirror_scatter(mirror, ids, rows):
    """Scatter changed landmark rows into the device-resident mirror —
    a delta update copying |changed| x 68 B to the device instead of the
    full mirror (which grows with the map)."""
    return tuple(m.at[ids].set(r) for m, r in zip(mirror, rows))


def _handle_pending(handle) -> bool:
    """True when a device result buffer has NOT landed on the host yet.
    Conservative: treats handles without is_ready (numpy fallbacks) as
    ready."""
    try:
        return hasattr(handle, "is_ready") and not handle.is_ready()
    except Exception:
        return False


def need_new_keyframe(
    n_inliers: int, n_ref_matches: int, n_kfs: int,
    frame_id: int, last_kf_frame: int, last_reloc_frame: int,
    tracked_close: int, non_tracked_close: int,
    min_frames: int, max_frames: int,
    mapper_idle: bool = True, queue_len: int = 0,
) -> bool:
    """Tracking.need_new_key_frame (Tracking.py:470-520), as a pure
    host predicate.

    Clauses (reference names):
      * reloc guard: no keyframes right after relocalization while the
        map is already mature;
      * bNeedToInsertClose: close points are undertracked;
      * c1a: max_frames elapsed since the last keyframe;
      * c1b: min_frames elapsed and the mapper can accept (always true
        in the synchronous schedule);
      * c1c: inliers collapsed below 0.25x the reference KF's tracked
        points, or close points needed;
      * c2: inliers below thRefRatio x reference (0.75 stereo; 0.4 while
        the map has <2 KFs), or close needed — and at least 15 inliers.
    """
    if frame_id < last_reloc_frame + max_frames and n_kfs > max_frames:
        return False
    need_close = tracked_close < 100 and non_tracked_close > 70
    th_ref_ratio = 0.75 if n_kfs >= 2 else 0.4
    c1a = frame_id >= last_kf_frame + max_frames
    c1b = frame_id >= last_kf_frame + min_frames and mapper_idle
    c1c = n_inliers < n_ref_matches * 0.25 or need_close
    c2 = (n_inliers < n_ref_matches * th_ref_ratio or need_close) \
        and n_inliers > 15
    if not ((c1a or c1b or c1c) and c2):
        return False
    # mapper-busy arbitration (Tracking.py:512-519): in the synchronous
    # schedule the mapper is idle by construction; kept for parity with
    # an async host schedule
    return mapper_idle or queue_len < 3


@dataclasses.dataclass
class System:
    cfg: SlamConfig
    landmark_capacity: int = 1 << 18
    keyframe_capacity: int = 4096
    # local BA cadence: every 2nd keyframe.  The reference's LocalMapping
    # aborts an in-flight BA whenever the keyframe queue is non-empty
    # (mbAbortBA, LocalMapping.py:86-106), so its effective cadence under
    # KF-every-3-frames load is below one run per keyframe; measured here,
    # every-2nd is both faster AND slightly more accurate than every-KF
    # (less geometry churn between consecutive overlapping windows)
    ba_every_n_kf: int = 2
    # windowed mode: a scanned frame is committed only while its local-map
    # anchoring stays at least this strong; the rest of the window re-tracks
    # per-frame (keyframes then refresh the map at full accuracy).  Guards
    # against the map-feedback drift of committing weakly-anchored poses.
    window_commit_min_inliers: int = 90
    localization_only: bool = False
    # ablation switch for drift-repair evaluation: odometry+mapping
    # without place recognition / loop correction
    enable_loop_closing: bool = True
    vocabulary: Optional[Vocabulary] = None  # trained lazily if absent

    def __post_init__(self):
        self.reset()

    # ---------------- public API (reference parity) ----------------

    def reset(self):
        self.map = SlamMap(
            self.cfg, self.landmark_capacity, self.keyframe_capacity
        )
        self.kfdb = (
            KeyFrameDatabase(self.vocabulary) if self.vocabulary else None
        )
        self.loop_closer = None
        self.local_mapper = None
        from pyorbslam_jax.slam.kf_ring import DeviceKFRing

        self.kf_ring = DeviceKFRing()
        self.last_reloc_frame = -10**9
        self.state = "NOT_INITIALIZED"
        self.Tcw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.last_frame: Optional[StereoFrame] = None
        self.last_assign: Optional[np.ndarray] = None
        self.lm_created_kf = np.full(self.landmark_capacity, -1, np.int32)
        self.recent_lms: list = []
        self.last_kf_frame = -10**9   # frame id of the last keyframe
        self.frame_id = -1
        self.trajectory: list = []   # raw per-frame Tcw at track time
        self.frame_refs: list = []   # (ref_kf, Tcr): relative log for export
        self.stats: list = []
        self._mirror = None          # device-resident landmark blocks
        self._mirror_stale = True
        self._mirror_shadow = None   # host copy of the uploaded rows
        self._mirror_cap = 0
        self._mirror_pending = np.empty(0, np.int32)  # sub-tolerance dirt
        self._frame_cache = None     # (frame, host snapshot) of the last pull
        self._vocab_cache = None     # (frame, (word, weight, node)) prefetch
        self._snap_prefetch = None   # (frame, device kf_snapshot buffer)
        # windowed schedule: while committing a window the mapper counts
        # as BUSY (the reference's async LocalMapping while a queue
        # drains, LocalMapping.py:86-106) — keyframe insertion then needs
        # c1a/c1c and is capped by the queue arbitration
        self._mapper_queue = None    # None = idle (per-frame schedule)
        self._pending_window = None  # in-flight pipelined window
        self._scan_correction = None
        # ---- pipelined per-frame (async) schedule state ----
        self._async_q: list = []     # in-flight dispatch records (<= 1)
        self._chain_healthy = True   # raw device chain tracks host chain
        self._defer_maintenance = False  # windowed commit in progress
        self._maint_queue: list = []     # (kf, bow) awaiting mapping work
        self._maint_pipe: list = []      # staged in-flight mapping items
        # schedule diagnostics (profiling); bounded — KITTI-00-scale
        # runs must not grow host memory per event
        self.events = deque(maxlen=4096)
        self.times = defaultdict(float)   # per-stage wall clock
        self.time_counts = defaultdict(int)

    @contextlib.contextmanager
    def _t(self, label: str):
        """Wall-clock a pipeline stage into ``self.times`` (the permanent
        schedule observability the bench/profiler report)."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[label] += time.perf_counter() - t0
            self.time_counts[label] += 1

    def track_stereo(self, left: np.ndarray, right: np.ndarray,
                     timestamp: float) -> np.ndarray:
        self.frame_id += 1
        # upload in the caller's dtype (uint8 preferred: 4x cheaper
        # transfer); build_stereo_frame casts to f32 on device
        left = jnp.asarray(left)
        right = jnp.asarray(right)
        if self.state == "NOT_INITIALIZED":
            frame = build_stereo_frame_jit(left, right, self.cfg)
            self._stereo_initialization(frame, timestamp)
        else:
            self._track_fused(left, right, timestamp)
        self.trajectory.append(self.Tcw.copy())
        # relative-pose log: frame pose expressed in its reference KF so
        # later BA / loop corrections propagate to the whole trajectory
        # (System.save_trajectory_kitti chaining, System.py:124-145)
        ref = self.map.keyframes.n - 1
        if ref >= 0:
            Tcr = self.Tcw @ np.linalg.inv(self.map.keyframes.Tcw[ref])
            self.frame_refs.append((ref, Tcr.astype(np.float32)))
        else:
            self.frame_refs.append((-1, self.Tcw.copy()))
        return self.Tcw

    # ---------------- pipelined per-frame (async) schedule ----------------
    #
    # The deployed software pipeline.  Each call, in order:
    #   1. ENQUEUE the new frame's image upload (asynchronous — the
    #      transfer streams while everything below runs);
    #   2. COMMIT the frame dispatched last call: its packed row has been
    #      copying to the host since dispatch, so the read is free; the
    #      commit updates pose/state, decides and INSERTS a keyframe
    #      (bindings + stereo landmarks + BoW registration) — its feature
    #      snapshot was prefetched speculatively at dispatch;
    #   3. DISPATCH this frame's fused tracking step against the map as
    #      of the commit (same freshness as the synchronous path);
    #   4. run the committed keyframe's MAPPING work (triangulation,
    #      fuse, local BA, loop closing) while the device tracks — the
    #      single-process form of the reference's async Tracking/LocalMapping
    #      split (System.py:58-64, LocalMapping.py:43-84); its pose
    #      refinements fold into the in-flight frame at its commit.

    def track_stereo_async(self, left, right, timestamp) -> np.ndarray:
        """Feed one stereo pair into the pipelined schedule; returns the
        pose of the last COMMITTED frame (one frame behind the feed —
        call :meth:`flush_async` to commit the tail).  Falls back to the
        synchronous per-frame machine until initialized or after a
        tracking loss."""
        if self.state not in ("OK", "MARGINAL") or self.map.keyframes.n == 0:
            self.flush_async()
            return self.track_stereo(left, right, timestamp)
        left = jnp.asarray(left)     # upload streams under the commit
        right = jnp.asarray(right)
        if self._async_q:
            self._commit_chain(self._async_q.pop(0))
        if self.state in ("OK", "MARGINAL") and self.map.keyframes.n > 0:
            self._dispatch_chain(left, right, timestamp)
            # one device stage per in-flight keyframe: dispatches queue
            # behind the tracking step; reads consume results dispatched
            # a frame ago (already copied)
            self._run_maintenance_queue(blocking=False)
        else:
            # the commit lost tracking: this frame goes through the
            # synchronous rescue machine instead
            self._run_maintenance_queue()
            self.track_stereo(left, right, timestamp)
        return self.Tcw

    def flush_async(self):
        """Commit every in-flight pipelined frame."""
        while self._async_q:
            self._commit_chain(self._async_q.pop(0))
        self._run_maintenance_queue()

    def _dispatch_chain(self, left, right, timestamp):
        with self._t("async.dispatch"):
            self._dispatch_chain_inner(left, right, timestamp)

    def _dispatch_chain_inner(self, left, right, timestamp):
        lm = self.map.landmarks
        mirror = self._landmark_mirror()
        local_ids = self._local_point_ids(self.last_assign)
        cap = _cap_bucket(len(local_ids), self.cfg.tracking.max_local_points)
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: len(local_ids)] = local_ids

        q_lm = lm.resolve(self.last_assign)
        Tcw_pred = (self.velocity @ self.Tcw).astype(np.float32)
        row, frame = fused_track_chain_step(
            left, right, *mirror,
            self.last_frame, jnp.asarray(q_lm),
            jnp.asarray(Tcw_pred), jnp.asarray(self.Tcw),
            jnp.asarray(p_ids), self.cfg,
        )
        if hasattr(row, "copy_to_host_async"):
            row.copy_to_host_async()   # readback overlaps the next compute
        # speculative keyframe-snapshot prefetch: if this frame becomes a
        # keyframe at commit, its feature snapshot + BoW will already be
        # on the host (skipping the ~1 round-trip stall).  Only the frame
        # IMMEDIATELY after a keyframe skips it — on corner-dense worlds
        # the steady-state cadence is a keyframe every 2 frames, and a
        # >=2 gap heuristic made every other keyframe pay a blocking
        # ~50 ms snapshot read at commit
        if self.frame_id + 1 - self.last_kf_frame >= 1:
            self._prefetch_snapshot(frame)
        self._async_q.append(dict(
            row=row, frame=frame, base=self.Tcw.copy(),
            p_ids=p_ids, n_local=len(local_ids),
            n_feat=int(q_lm.shape[0]), timestamp=timestamp,
        ))

    def _commit_chain(self, rec):
        with self._t("async.commit"):
            self._commit_chain_inner(rec)

    def _commit_chain_inner(self, rec):
        lm = self.map.landmarks
        self.frame_id += 1
        with self._t("async.read"):
            out = np.asarray(rec["row"])
        N, P = rec["n_feat"], len(rec["p_ids"])
        stats = out[:5]
        raw = out[5:21].copy().view(np.float32).reshape(4, 4)
        n_matches, n_in_motion, n_in_local = (int(x) for x in stats[:3])

        # deferred maintenance may have refined the pose this frame's
        # prediction chained from (rec["base"]); rebase preserving the
        # tracked relative motion.  base == self.Tcw in the common
        # no-refinement case, making this exactly `raw`.
        healthy = (n_matches >= 20 and n_in_motion >= 20
                   and n_in_local >= 10 and np.isfinite(raw).all())
        if healthy:
            Tcw_i = np.ascontiguousarray(
                raw @ np.linalg.inv(rec["base"]) @ self.Tcw, np.float32)
        if not healthy:
            # weak tracking: the full per-frame state machine (motion
            # retry, BoW reference-KF fallback, wide rescue, reloc)
            # takes this frame
            self.events.append("async:rescue")
            self._track(rec["frame"], rec["timestamp"])
            self.trajectory.append(self.Tcw.copy())
            self._append_frame_ref()
            return

        assign = lm.resolve(out[21: 21 + N])
        assign = np.where(
            (assign >= 0) & lm.alive[np.maximum(assign, 0)], assign, -1)
        p_visible = unpack_bool_np(out[21 + N: 21 + N + P // 32], P)
        vis_ids = rec["p_ids"][p_visible[:P]]
        vis_ids = vis_ids[vis_ids >= 0]
        lm.visible[vis_ids] += 1
        found_ids = np.unique(assign[assign >= 0])
        lm.found[found_ids] += 1
        lm.visible[found_ids] += 1

        tracked_close, non_tracked_close = int(stats[3]), int(stats[4])
        self.state = "OK" if n_in_local >= 20 else "MARGINAL"
        self.Tcw = Tcw_i
        # keyframe mapping work is deferred past the next dispatch (the
        # chip tracks while the host runs it)
        self._defer_maintenance = True
        try:
            self._finish_track(
                rec["frame"], assign, n_matches, n_in_local,
                tracked_close, non_tracked_close, rec["n_local"],
                rec["timestamp"],
            )
        finally:
            self._defer_maintenance = False
        self.trajectory.append(self.Tcw.copy())
        self._append_frame_ref()

    def _append_frame_ref(self):
        ref = self.map.keyframes.n - 1
        if ref >= 0:
            Tcr = self.Tcw @ np.linalg.inv(self.map.keyframes.Tcw[ref])
            self.frame_refs.append((ref, Tcr.astype(np.float32)))
        else:
            self.frame_refs.append((-1, self.Tcw.copy()))

    def track_stereo_window(self, lefts, rights, timestamps) -> np.ndarray:
        """Track a window of W frames with ONE device dispatch
        (tracking.fused_track_window): a lax.scan carries features/pose
        across frames on-chip; keyframe decisions and map updates run on
        the host AFTER the window from the per-frame packed stats.  The
        local map is frozen for the window — the same lag the reference's
        asynchronous LocalMapping thread produces.  Falls back to
        per-frame tracking until initialized or when any frame in the
        window tracks weakly.  Returns the W per-frame Tcw poses."""
        if self.state != "OK" or self.map.keyframes.n == 0:
            L = len(timestamps)
            poses, i = [], 0
            while i < L and (self.state != "OK"
                             or self.map.keyframes.n == 0):
                poses.append(
                    self.track_stereo(lefts[i], rights[i], timestamps[i]))
                i += 1
            if L - i >= 3:
                poses.extend(self._commit_window(self._dispatch_window(
                    lefts[i:], rights[i:], timestamps[i:])))
            else:
                for j in range(i, L):
                    poses.append(self.track_stereo(
                        lefts[j], rights[j], timestamps[j]))
            return np.stack(poses)
        return self._commit_window(
            self._dispatch_window(lefts, rights, timestamps))

    # ---- pipelined deployment driver ----
    #
    # The schedule per feed call:
    #   1. COMMIT the in-flight window's tracking core: read its rows,
    #      re-anchor weak frames, insert keyframes (features + stereo
    #      landmarks + BoW registration), all against the current map;
    #   2. DISPATCH the next window's scan, chaining the device carry
    #      REBASED onto the host's corrected pose — the scan therefore
    #      runs with a map that is fresh as of its own first frame (the
    #      reference's one-keyframe mapping lag, not a multi-window one);
    #   3. run the committed keyframes' MAPPING work (triangulation,
    #      fuse, local BA, loop closing) while the device scans — the
    #      single-process form of the async Tracking/LocalMapping split
    #      (System.py:58-64).  Pose refinements found here fold into the
    #      live pose and reach the in-flight window via its base
    #      correction at the next commit.

    def window_feed(self, lefts, rights, timestamps) -> np.ndarray:
        """Feed one window; returns the poses that became FINAL with this
        call (usually the previous window's W poses; empty on the first
        call; 2W when a bootstrap flush occurs).

        Operating envelope: the in-flight window scans against a map
        frozen up to 2W-1 frames ago, so per-window camera motion must
        stay well inside the projection-search radius at scene depth
        (rule of thumb: <= ~2-3 m per window at KITTI-like depths).
        Faster motion makes in-scan rows anchor on landmarks their own
        drifted keyframes created — a compounding ratchet the deferred
        BA repairs too late.  For fast motion use track_stereo_async
        (per-frame map updates, same upload/compute overlap)."""
        if self.state != "OK" or self.map.keyframes.n == 0:
            done = self.window_flush()
            # bootstrap: per-frame only until initialized/recovered, then
            # scan the REMAINDER of the window as one dispatch (the
            # sub-width program compiles once and is cached)
            L = len(timestamps)
            poses, i = [], 0
            while i < L and (self.state != "OK"
                             or self.map.keyframes.n == 0):
                poses.append(
                    self.track_stereo(lefts[i], rights[i], timestamps[i]))
                i += 1
            if L - i >= 3:
                poses.extend(self._commit_window(self._dispatch_window(
                    lefts[i:], rights[i:], timestamps[i:])))
            else:
                for j in range(i, L):
                    poses.append(self.track_stereo(
                        lefts[j], rights[j], timestamps[j]))
            boot = np.stack(poses)
            return np.concatenate([done, boot]) if len(done) else boot

        old = self._pending_window
        self._pending_window = None
        out = np.zeros((0, 4, 4), np.float32)
        carry = None
        if old is not None:
            self._defer_maintenance = True
            try:
                out = self._commit_window(old)
            finally:
                self._defer_maintenance = False
            if self.state != "OK":
                # lost mid-window: the per-frame rescue machine already
                # took the tail; drain mapping work and track this window
                # per-frame too
                self._run_maintenance_queue()
                return np.concatenate([out, np.stack([
                    self.track_stereo(lefts[i], rights[i], timestamps[i])
                    for i in range(len(timestamps))])])
            if self._chain_healthy:
                # rebase the device carry onto the corrected pose: the
                # raw chain's relative motion is kept, its anchor moves
                # to the host's pose (velocity is invariant under this
                # right-multiplication)
                raw_last, corrected = self._scan_correction
                M = jnp.asarray(
                    (np.linalg.inv(raw_last) @ corrected).astype(np.float32))
                frame_c, _, Tcw_c, Tlw_c = old["carry"]
                q_lm = jnp.asarray(
                    self.map.landmarks.resolve(self.last_assign))
                carry = (frame_c, q_lm, Tcw_c @ M, Tlw_c @ M)
            else:
                self.events.append("chain:reseed")
        new = self._dispatch_window(lefts, rights, timestamps, carry=carry)
        base_pre = self.Tcw.copy()
        self._pending_window = new
        # the committed keyframes' mapping work runs under the scan
        self._run_maintenance_queue()
        # pose refinements from maintenance reach the in-flight window
        # as a base correction (its raw chain is anchored at base_pre)
        new["base"] = (base_pre, self.Tcw.copy())
        return out

    def window_flush(self) -> np.ndarray:
        """Commit any in-flight window; returns its poses."""
        pending = self._pending_window
        self._pending_window = None
        if pending is None:
            return np.zeros((0, 4, 4), np.float32)
        if pending.get("discard") or self.state != "OK":
            return np.stack([
                self.track_stereo(l, r, t) for l, r, t in zip(
                    pending["lefts"], pending["rights"],
                    pending["timestamps"])
            ])
        return self._commit_window(pending)

    def _dispatch_window(self, lefts, rights, timestamps, carry=None):
        """Upload one window of stereo pairs and dispatch the scan.
        ``carry`` (device tuple from the previous scan) lets the chip
        chain windows without waiting for host processing."""
        with self._t("window.dispatch"):
            return self._dispatch_window_inner(
                lefts, rights, timestamps, carry)

    def _dispatch_window_inner(self, lefts, rights, timestamps, carry=None):
        W = len(timestamps)
        lm = self.map.landmarks
        local_ids = self._spatial_point_ids(self.Tcw)
        cap = _cap_bucket(len(local_ids), self.cfg.tracking.max_local_points)
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: len(local_ids)] = local_ids

        # ONE host->device transfer for the whole window (uint8 where the
        # caller provides it: 4x smaller than f32)
        images = jnp.asarray(np.stack([
            np.stack([np.asarray(lefts[i]), np.asarray(rights[i])])
            for i in range(W)
        ]))
        if carry is None:
            frame0 = self.last_frame
            q_lm0 = jnp.asarray(lm.resolve(self.last_assign))
            Tlw0 = jnp.asarray(self.Tcw)
            Tllw0 = jnp.asarray(
                (np.linalg.inv(self.velocity) @ self.Tcw).astype(np.float32))
        else:
            frame0, q_lm0, Tlw0, Tllw0 = carry
        packed, frames, carry_out = fused_track_window(
            images, *self._landmark_mirror(), frame0, q_lm0,
            jnp.asarray(p_ids), Tlw0, Tllw0, self.cfg,
        )
        if hasattr(packed, "copy_to_host_async"):
            packed.copy_to_host_async()   # overlap the read with the scan
        return dict(packed=packed, frames=frames, carry=carry_out,
                    frame0=frame0,
                    lefts=lefts, rights=rights, timestamps=timestamps,
                    p_ids=p_ids, n_local=len(local_ids),
                    n_feat=int(q_lm0.shape[0]), base=None)

    def _commit_window(self, pending) -> np.ndarray:
        with self._t("window.commit_total"):
            return self._commit_window_inner(pending)

    def _commit_window_inner(self, pending) -> np.ndarray:
        """Process one scanned window.  Healthy frames commit the scan
        pose directly.  A frame that needs a keyframe — or whose
        scan anchoring weakened — is RE-ANCHORED on device first: one
        local_track_packed dispatch re-optimizes its pose against the
        CURRENT map, reusing the scan's extracted features (no ORB
        re-extraction).  Only frames that stay weak after re-anchoring
        (true tracking loss) fall back to the per-frame state machine
        with its relocalization ladder."""
        timestamps = pending["timestamps"]
        lefts, rights = pending["lefts"], pending["rights"]
        p_ids = pending["p_ids"]
        local_n = pending["n_local"]
        lm = self.map.landmarks
        W = len(timestamps)
        with self._t("window.read"):
            out = np.asarray(pending["packed"])  # ONE device->host transfer
        n_feat = pending["n_feat"]
        N, P = n_feat, len(p_ids)
        frames = pending["frames"]
        stats = out[:, :5]

        base_raw, base_corr = pending["base"] or (None, None)
        raw_last = out[W - 1, 5:21].copy().view(np.float32).reshape(4, 4)
        trk = self.cfg.tracking
        poses = []
        aborted = None
        self._mapper_queue = 0   # window commit = mapper busy
        for i in range(W):
            row = out[i]
            raw = row[5:21].copy().view(np.float32).reshape(4, 4)
            frame_i = jax.tree_util.tree_map(lambda a: a[i], frames)
            frame_prev = pending["frame0"] if i == 0 else \
                jax.tree_util.tree_map(lambda a: a[i - 1], frames)
            retracked = False
            scan_weak = (int(row[0]) < 20 or int(row[1]) < 20
                         or not np.isfinite(raw).all())

            def adopt_retrack(re):
                nonlocal base_raw, base_corr
                (n_matches_i, n_inliers, Tcw_i, assign, p_ids_i,
                 p_visible, tracked_close, non_tracked_close) = re
                # the re-tracked pose leaves the raw scan chain: fold the
                # delta into the base correction so later rows follow.
                # A non-finite raw (diverged scan pose opt) must never
                # become the base — keep the previous finite base; later
                # healthy rows then rebase off it instead of off NaNs.
                if np.isfinite(raw).all():
                    base_raw = raw.copy()
                    base_corr = Tcw_i.copy()
                return (n_matches_i, n_inliers, Tcw_i, assign, p_ids_i,
                        p_visible, tracked_close, non_tracked_close,
                        int((p_ids_i >= 0).sum()))

            if scan_weak:
                # motion tracking collapsed mid-scan (often map staleness
                # in the pipelined schedule): re-anchor ON DEVICE against
                # the current map, reusing the scan's extracted features —
                # only a failed re-track falls back to per-frame rescue
                self.events.append("retrack:scan_weak")
                re = self._retrack_window_frame(frame_i, frame_prev)
                if re is None:
                    aborted = i
                    self.events.append("abort:scan_weak")
                    break
                (n_matches_i, n_inliers, Tcw_i, assign, p_vis_ids,
                 p_visible, tracked_close, non_tracked_close,
                 n_local_i) = adopt_retrack(re)
                retracked = True
            else:
                n_matches_i = int(row[0])
                n_inliers = int(row[2])
                assign = lm.resolve(row[21: 21 + N])
                assign = np.where(
                    (assign >= 0) & lm.alive[np.maximum(assign, 0)],
                    assign, -1)
                p_visible = unpack_bool_np(row[21 + N: 21 + N + P // 32], P)
                if base_raw is None:
                    Tcw_i = raw
                else:
                    # a pathological (singular) base must degrade to the
                    # per-frame rescue, not abort the whole commit
                    try:
                        Tcw_i = raw @ np.linalg.inv(base_raw) @ base_corr
                    except np.linalg.LinAlgError:
                        aborted = i
                        self.events.append("abort:singular_base")
                        break
                Tcw_i = np.ascontiguousarray(Tcw_i, dtype=np.float32)
                tracked_close = int(row[3])
                non_tracked_close = int(row[4])
                n_local_i = local_n
                p_vis_ids = p_ids

            # does this frame need a keyframe, or did its map anchoring
            # weaken below the commit bar?  The mapper is modeled as the
            # reference's async LocalMapping: idle once its per-KF
            # latency has elapsed (the synchronous commit can run it
            # immediately) — gating it off for the entire commit starves
            # keyframe creation and lets the map exhaust under the scan
            ks = self.map.keyframes
            needs_kf = need_new_keyframe(
                n_inliers=int((assign >= 0).sum()),
                n_ref_matches=self._ref_kf_tracked_points(),
                n_kfs=int(ks.alive[: ks.n].sum()),
                frame_id=self.frame_id + 1,
                last_kf_frame=self.last_kf_frame,
                last_reloc_frame=self.last_reloc_frame,
                tracked_close=tracked_close,
                non_tracked_close=non_tracked_close,
                min_frames=trk.min_frames, max_frames=trk.max_frames,
                mapper_idle=(self.frame_id + 1 >= self.last_kf_frame
                             + trk.mapper_latency_frames),
                queue_len=self._mapper_queue,
            )
            if not retracked and (
                    needs_kf or n_inliers < self.window_commit_min_inliers):
                # a keyframe-to-be is re-anchored against the CURRENT map
                # before insertion (its landmarks seed everything that
                # follows); the same dispatch returns the insertion
                # snapshot+BoW so the keyframe costs one round trip
                self.events.append(
                    "retrack:needs_kf" if needs_kf else "retrack:weak_anchor")
                re = self._retrack_window_frame(
                    frame_i, frame_prev, want_snapshot=needs_kf)
                if re is None:
                    # weak even against the fresh map: this stretch needs
                    # the per-frame machine's full rescue ladder
                    aborted = i
                    self.events.append("abort:retrack_failed")
                    break
                (n_matches_i, n_inliers, Tcw_i, assign, p_vis_ids,
                 p_visible, tracked_close, non_tracked_close,
                 n_local_i) = adopt_retrack(re)

            self.frame_id += 1
            vis_ids = p_vis_ids[p_visible[: len(p_vis_ids)]]
            vis_ids = vis_ids[vis_ids >= 0]
            lm.visible[vis_ids] += 1
            found_ids = np.unique(assign[assign >= 0])
            lm.found[found_ids] += 1
            lm.visible[found_ids] += 1

            self.state = "OK" if n_inliers >= 20 else "MARGINAL"
            self.Tcw = np.ascontiguousarray(Tcw_i, dtype=np.float32)
            pre_kf_Tcw = self.Tcw.copy()
            self._finish_track(
                frame_i, assign, n_matches_i, n_inliers,
                tracked_close, non_tracked_close, n_local_i, timestamps[i],
            )
            if not np.allclose(self.Tcw, pre_kf_Tcw, atol=1e-7):
                base_raw = raw.copy()
                base_corr = self.Tcw.copy()
            self.trajectory.append(self.Tcw.copy())
            ref = self.map.keyframes.n - 1
            Tcr = self.Tcw @ np.linalg.inv(self.map.keyframes.Tcw[ref])
            self.frame_refs.append((ref, Tcr.astype(np.float32)))
            poses.append(self.Tcw.copy())
        if aborted is not None:
            # true weakness: the per-frame machine (BoW fallback, wide
            # rescue, relocalization) takes the rest of the window
            for i in range(aborted, W):
                poses.append(
                    self.track_stereo(lefts[i], rights[i], timestamps[i]))
        self._mapper_queue = None   # mapper idle again
        # an aborted commit means the per-frame machine took over for
        # the tail: the device chain must reseed from host state.  A
        # non-finite raw chain end (pose optimization diverged on
        # garbage matches) must never be inverted for a rebase.
        det = float(np.linalg.det(raw_last)) \
            if np.isfinite(raw_last).all() else 0.0
        self._chain_healthy = (
            aborted is None and 0.5 < abs(det) < 2.0)
        # raw device pose of the window's last frame vs the host's
        # corrected pose — the next dispatch rebases the carry by this
        self._scan_correction = (raw_last, self.Tcw.copy())
        return np.stack(poses)

    def _retrack_window_frame(self, frame_i, frame_prev,
                              want_snapshot: bool = False):
        """Full tracking body (motion + local + pose opt) for one scanned
        frame against the CURRENT map, reusing its extracted features —
        the device re-track that precedes in-window keyframe insertion.
        With ``want_snapshot`` the same dispatch also returns the
        keyframe-insertion snapshot + BoW vectors (one read, not two).
        Returns (n_matches, n_inliers, Tcw, assign, p_ids, p_visible,
        tracked_close, non_tracked_close) or None when weak."""
        with self._t("window.retrack"):
            return self._retrack_window_frame_inner(
                frame_i, frame_prev, want_snapshot)

    def _retrack_window_frame_inner(self, frame_i, frame_prev,
                                    want_snapshot: bool):
        lm = self.map.landmarks
        Tcw_pred = (self.velocity @ self.Tcw).astype(np.float32)
        q_lm = lm.resolve(self.last_assign)
        local_ids = self._spatial_point_ids(Tcw_pred)
        cap = _cap_bucket(len(local_ids), self.cfg.tracking.max_local_points)
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: len(local_ids)] = local_ids
        voc = self.vocabulary
        want_snapshot = want_snapshot and voc is not None

        def attempt(th_base):
            if want_snapshot:
                return np.asarray(fused_retrack_snapshot_step(
                    frame_i, *self._landmark_mirror(),
                    jnp.asarray(q_lm), frame_prev, jnp.asarray(p_ids),
                    jnp.asarray(Tcw_pred), jnp.asarray(self.Tcw), self.cfg,
                    voc._device_arrays(), voc.k, voc.L,
                    voc.feature_levels_up, th_base=th_base,
                ))
            return np.asarray(fused_retrack_step(
                frame_i, *self._landmark_mirror(),
                jnp.asarray(q_lm), frame_prev, jnp.asarray(p_ids),
                jnp.asarray(Tcw_pred), jnp.asarray(self.Tcw), self.cfg,
                th_base=th_base,
            ))

        packed = attempt(7.0)
        N = q_lm.shape[0]
        stats = packed[:5]
        n_matches, n_in_motion, n_inliers = (int(x) for x in stats[:3])
        if n_matches < 20 or n_in_motion < 20 or n_inliers < 20:
            # wide-radius rescue (the per-frame ladder's 28 px tier,
            # Tracking.py's 2*th retry) before giving up on the frame
            packed = attempt(28.0)
            stats = packed[:5]
            n_matches, n_in_motion, n_inliers = (int(x) for x in stats[:3])
        if n_matches < 20 or n_in_motion < 20 or n_inliers < 20:
            return None
        if want_snapshot:
            base = 21 + N + len(p_ids)
            buf = packed[base:]
            snap = unpack_frame_np(buf[: 16 * N], N)
            self._frame_cache = (frame_i, snap)
            self._vocab_cache = (frame_i, (
                buf[16 * N: 17 * N],
                buf[17 * N: 18 * N].view(np.float32),
                buf[18 * N: 19 * N],
            ))
            self._snap_prefetch = None
        Tcw = packed[5:21].copy().view(np.float32).reshape(4, 4)
        assign = packed[21: 21 + N].copy()
        p_visible = packed[21 + N: 21 + N + len(p_ids)].astype(bool)
        return (n_matches, n_inliers,
                np.ascontiguousarray(Tcw, np.float32), assign, p_ids,
                p_visible, int(stats[3]), int(stats[4]))

    def corrected_trajectory(self) -> np.ndarray:
        """Per-frame Tcw with all keyframe corrections applied.  Frames
        whose reference KF was culled chain Tcr through the frozen
        dead-KF relative poses to the nearest live ancestor
        (System.save_trajectory_kitti, System.py:124-145)."""
        out = []
        for (ref, Tcr), raw in zip(self.frame_refs, self.trajectory):
            if ref >= 0:
                ref, Tcr = self.map.resolve_ref(ref, Tcr)
                out.append(Tcr @ self.map.keyframes.Tcw[ref])
            else:
                out.append(raw)
        return np.stack(out) if out else np.zeros((0, 4, 4), np.float32)

    def save_trajectory_kitti(self, path: str):
        save_trajectory_kitti(path, self.corrected_trajectory())

    def activate_localization_mode(self):
        """Freeze the map (reference System.py:106-112 stops LocalMapping):
        drain in-flight frames and staged mapping work first so the frozen
        map is consistent, then suppress keyframe creation.  Odometry
        survives unmapped excursions through the mainline hybrid VO
        queries (the reference's temporal VO points, Tracking.py:612-659)."""
        self.flush_async()
        self._run_maintenance_queue()
        self.localization_only = True

    def deactivate_localization_mode(self):
        self.localization_only = False

    def shutdown(self):
        """Drain all in-flight work so every fed frame lands in the
        trajectory, mirroring the reference's drain-before-exit
        (System.py:149-167 joins its threads).  Covers the async
        per-frame pipeline, a pending window, and the staged
        keyframe-maintenance queue; idempotent."""
        self.flush_async()
        self.window_flush()
        self._run_maintenance_queue()

    # ---------------- initialization ----------------

    def _stereo_initialization(self, frame: StereoFrame, timestamp: float):
        # the reference requires > 500 features at its 2000-feature
        # operating point (Tracking.py:284); scale the gate with the
        # configured budget so small configs can still bootstrap
        n_valid = int(np.asarray(frame.valid).sum())
        if n_valid <= min(500, self.cfg.orb.n_features // 4):
            return
        if self.vocabulary is None:
            # prefer the shipped offline-trained vocabulary (corpus idf,
            # tools/train_vocab.py); fall back to training a small scene
            # vocabulary from the initial frame (DBoW2 k-majority)
            self.vocabulary = vocab_mod.load_default()
        if self.vocabulary is None:
            d = np.asarray(frame.desc)[np.asarray(frame.valid)]
            self.vocabulary = vocab_mod.train(d, k=10, L=3, seed=0)
        if self.kfdb is None:
            self.kfdb = KeyFrameDatabase(self.vocabulary)
        self.Tcw = np.eye(4, dtype=np.float32)
        self._prefetch_snapshot(frame)
        assign = self._create_landmarks(frame, self.Tcw, limit=None)
        self._insert_keyframe(frame, assign, timestamp, run_ba=False)
        self.last_frame = frame
        self.last_assign = assign
        self.state = "OK"

    # ---------------- per-frame tracking ----------------

    def _landmark_mirror(self, force: bool = False):
        """Device-resident landmark blocks (positions, descriptors,
        normals, distance bands, alive mask), refreshed only after map
        mutations — per-frame tracking gathers from these by index so the
        blocks never cross the host boundary (SURVEY §7 host/device split).

        Refreshes are DELTA updates: a host-side shadow copy finds the
        rows any map mutation touched (including native-core kills the
        Python layer never sees) and only those rows are copied —
        at KITTI-00 scale a full re-upload is ~8 MB per window, a delta
        is a few hundred KB."""
        lm = self.map.landmarks
        if force:
            self._mirror_stale = True
        if self._mirror is not None and not self._mirror_stale:
            return self._mirror
        cap = 1 << 14
        while cap < lm.n:
            cap <<= 1
        cap = min(cap, lm.capacity)

        def full_upload():
            host = tuple(getattr(lm, f)[:cap] for f in _MIRROR_FIELDS)
            self._mirror = tuple(jnp.asarray(h) for h in host)
            self._mirror_shadow = tuple(h.copy() for h in host)
            self._mirror_cap = cap
            # shadow now equals host: all dirt is accounted for
            lm.drain_dirty()
            self.map.core.drain_dirty()
            self._mirror_pending = np.empty(0, np.int32)

        if self._mirror is None or self._mirror_cap != cap:
            full_upload()
        else:
            # INCREMENTAL refresh: every mirrored-field writer marks the
            # ids it touched (LandmarkStore.mark_dirty; native kills are
            # drained from mapcore), so the candidate set is O(rows
            # written) instead of an O(capacity) field scan per refresh
            # — the scan was a map-size-proportional per-frame host cost
            # at 700-frame scale.
            #
            # Float fields then use a tolerance: local BA jitters
            # thousands of positions by fractions of a millimeter every
            # solve, and re-uploading all of them costs more uplink than
            # the images themselves.  The shadow holds the last UPLOADED
            # values; sub-tolerance ids stay in the pending set so drift
            # accumulates against the shadow and still uploads once it
            # matters.  Tolerances are far below the matcher's search
            # radius at any depth.
            cand = np.unique(np.concatenate([
                self._mirror_pending, lm.drain_dirty(),
                self.map.core.drain_dirty()]))
            cand = cand[cand < cap].astype(np.int32)
            tol = dict(pos=2e-3, normal=1e-2, dmin=1e-2, dmax=1e-2)
            changed = np.zeros(len(cand), bool)
            for f, s in zip(_MIRROR_FIELDS, self._mirror_shadow):
                h = getattr(lm, f)[cand]
                if f in tol:
                    d = np.abs(h - s[cand]) > tol[f]
                else:
                    d = h != s[cand]
                changed |= d.any(axis=1) if d.ndim == 2 else d
            ids = cand[changed]
            self._mirror_pending = cand[~changed]
            if len(ids) > cap // 4:
                full_upload()
            elif len(ids):
                pad = 256
                while pad < len(ids):
                    pad <<= 1
                ids_p = np.full(pad, ids[0], np.int32)
                ids_p[: len(ids)] = ids
                rows = tuple(
                    jnp.asarray(getattr(lm, f)[ids_p])
                    for f in _MIRROR_FIELDS)
                self._mirror = _mirror_scatter(
                    self._mirror, jnp.asarray(ids_p), rows)
                for f, s in zip(_MIRROR_FIELDS, self._mirror_shadow):
                    s[ids] = getattr(lm, f)[ids]
        self._mirror_stale = False
        return self._mirror

    def _track_fused(self, left, right, timestamp: float):
        """Fast path: the whole per-frame hot path in one device dispatch
        (tracking.fused_track_step) + one packed read-back.  Falls back to
        the step-by-step host path on weak tracking (rare)."""
        with self._t("perframe.track"):
            return self._track_fused_inner(left, right, timestamp)

    def _track_fused_inner(self, left, right, timestamp: float):
        lm = self.map.landmarks
        Tcw_pred = (self.velocity @ self.Tcw).astype(np.float32)
        q_lm = lm.resolve(self.last_assign)
        local_ids = self._local_point_ids(self.last_assign)
        cap = _cap_bucket(len(local_ids), self.cfg.tracking.max_local_points)
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: len(local_ids)] = local_ids

        fres = fused_track_step(
            left, right, *self._landmark_mirror(),
            jnp.asarray(q_lm), self.last_frame,
            jnp.asarray(p_ids), jnp.asarray(Tcw_pred), jnp.asarray(self.Tcw),
            self.cfg,
        )
        packed = np.asarray(fres.packed)   # ONE device->host transfer
        n_feat = q_lm.shape[0]
        stats = packed[:5]
        Tcw = packed[5:21].view(np.float32).reshape(4, 4)
        assign = packed[21: 21 + n_feat]
        p_visible = packed[21 + n_feat:].astype(bool)
        n_matches, n_in_motion, n_inliers, tracked_close, non_tracked_close = (
            int(x) for x in stats
        )
        if n_matches < 20 or n_in_motion < 20 or n_inliers < 10:
            # weak tracking: rerun through the host state machine (BoW
            # reference-KF fallback, wide-radius rescue, relocalization)
            return self._track(fres.frame, timestamp)

        vis_ids = p_ids[p_visible]
        vis_ids = vis_ids[vis_ids >= 0]
        lm.visible[vis_ids] += 1
        found_ids = np.unique(assign[assign >= 0])
        lm.found[found_ids] += 1
        lm.visible[found_ids] += 1

        self.state = "OK" if n_inliers >= 20 else "MARGINAL"
        self.Tcw = np.asarray(Tcw, np.float32)
        self._finish_track(
            fres.frame, assign, n_matches, n_inliers,
            tracked_close, non_tracked_close, len(local_ids), timestamp,
        )

    def _track(self, frame: StereoFrame, timestamp: float):
        lm = self.map.landmarks
        Tcw_pred = (self.velocity @ self.Tcw).astype(np.float32)
        lm_ids = lm.resolve(self.last_assign)
        q_active = lm_ids >= 0
        safe = np.maximum(lm_ids, 0)

        def motion_attempt(th_base):
            return motion_track_step(
                frame,
                jnp.asarray(lm.pos[safe]),
                jnp.asarray(lm.desc[safe]),
                self.last_frame.angle,
                self.last_frame.octave,
                jnp.asarray(q_active & lm.alive[safe]),
                jnp.asarray(Tcw_pred),
                jnp.asarray(self.Tcw),
                self.cfg,
                th_base=th_base,
            )

        res = motion_attempt(7.0)
        assign = None
        if int(res.n_matches) < 20 or int(res.n_inliers) < 20:
            # fallbacks, in the reference's order: BoW matching against
            # the reference keyframe (track_reference_key_frame,
            # Tracking.py:329-356), then a wide-radius projection rescue
            # for large prediction errors BoW can't fix (e.g. sharp turns)
            ref = self._track_reference_keyframe(frame)
            if ref is not None:
                Tcw_mid, assign = ref
                n_matches = int((assign >= 0).sum())
            else:
                res = motion_attempt(28.0)
        if assign is None:
            n_matches = int(res.n_matches)
            feat_query = np.asarray(res.feat_query)
            assign = np.where(feat_query >= 0, lm_ids[np.maximum(feat_query, 0)], -1)
            Tcw_mid = np.asarray(res.Tcw) if n_matches >= 20 else Tcw_pred

        # local map from covisibility (update_local_keyframes/points)
        local_ids = self._local_point_ids(assign)
        cap = _cap_bucket(len(local_ids), self.cfg.tracking.max_local_points)
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: len(local_ids)] = local_ids
        p_safe = np.maximum(p_ids, 0)
        feat_has = assign >= 0
        feat_xw = lm.pos[np.maximum(assign, 0)]

        lres = local_track_step(
            frame,
            jnp.asarray(feat_xw),
            jnp.asarray(feat_has),
            jnp.asarray(lm.pos[p_safe]),
            jnp.asarray(lm.desc[p_safe]),
            jnp.asarray(lm.normal[p_safe]),
            jnp.asarray(lm.dmin[p_safe]),
            jnp.asarray(lm.dmax[p_safe]),
            jnp.asarray(p_ids >= 0),
            jnp.asarray(Tcw_mid),
            self.cfg,
        )
        n_inliers = int(lres.n_inliers)
        tracked = np.asarray(lres.tracked)
        feat_local = np.asarray(lres.feat_local)
        assign = np.where(feat_local >= 0, p_ids[np.maximum(feat_local, 0)], assign)
        assign = np.where(tracked, assign, -1)

        # found / visible counters (track_local_map bookkeeping)
        vis_ids = p_ids[np.asarray(lres.p_visible)]
        vis_ids = vis_ids[vis_ids >= 0]
        lm.visible[vis_ids] += 1
        found_ids = np.unique(assign[assign >= 0])
        lm.found[found_ids] += 1
        lm.visible[found_ids] += 1

        if n_inliers >= 10:
            # accept — the reference keeps the optimized pose even when
            # flagging weak tracking; discarding a 10+-inlier solution
            # cascades into permanent loss
            self.state = "OK" if n_inliers >= 20 else "MARGINAL"
            self.Tcw = np.asarray(lres.Tcw)
        else:
            reloc = self._relocalize(frame)
            if reloc is not None:
                self.state = "OK"
                self.Tcw, assign = reloc
                self.last_reloc_frame = self.frame_id
            else:
                self.state = "WEAK"
                self.Tcw = Tcw_pred
                assign = np.full(frame.capacity, -1, np.int32)

        depth = np.asarray(frame.depth)
        valid = np.asarray(frame.valid)
        th_depth = self.cfg.camera.depth_threshold
        close = (depth > 0) & (depth < th_depth) & valid
        tracked_close = int((close & (assign >= 0)).sum())
        non_tracked_close = int((close & (assign < 0)).sum())
        self._finish_track(
            frame, assign, n_matches, n_inliers,
            tracked_close, non_tracked_close, len(local_ids), timestamp,
        )

    def _finish_track(self, frame, assign, n_matches, n_inliers,
                      tracked_close, non_tracked_close, n_local,
                      timestamp):
        self.velocity = (
            self.Tcw @ np.linalg.inv(self.trajectory[-1])
        ).astype(np.float32)

        # keyframe decision (Tracking.need_new_key_frame parity), plus:
        # MARGINAL frames force a keyframe (refresh the local map before
        # tracking dies); WEAK frames with failed relocalization reseed via
        # a keyframe as the last resort so odometry survives unmapped
        # excursions (the reference's auto-reset analog, Tracking.py:258-262)
        trk = self.cfg.tracking
        ks = self.map.keyframes
        # mnMatchesInliers counts ALL tracked map points in the frame
        # (Tracking.py:375-382), not just stereo-edge pose-opt inliers —
        # the ratio clauses are calibrated against that count
        n_tracked_points = int((assign >= 0).sum())
        need_kf = not self.localization_only and (
            (self.state == "OK" and need_new_keyframe(
                n_inliers=n_tracked_points,
                n_ref_matches=self._ref_kf_tracked_points(),
                n_kfs=int(ks.alive[: ks.n].sum()),
                frame_id=self.frame_id,
                last_kf_frame=self.last_kf_frame,
                last_reloc_frame=self.last_reloc_frame,
                tracked_close=tracked_close,
                non_tracked_close=non_tracked_close,
                min_frames=trk.min_frames, max_frames=trk.max_frames,
                mapper_idle=(
                    self.frame_id
                    >= self.last_kf_frame + trk.mapper_latency_frames
                ),
                queue_len=self._mapper_queue or 0,
            ))
            or self.state == "MARGINAL"
            or self.state == "WEAK"
        )
        if need_kf:
            # one combined snapshot+BoW read instead of two round trips
            if self._frame_cache is None or self._frame_cache[0] is not frame:
                self._prefetch_snapshot(frame)
            assign = self._create_landmarks(frame, self.Tcw, limit=100,
                                            existing=assign)
            kf_id = self._insert_keyframe(frame, assign, timestamp, run_ba=True)
            # local mapping may have added triangulated/fused bindings to
            # this keyframe; carry them into the tracker state
            assign = self.map.keyframes.obs_lm[kf_id].copy()

        self.last_frame = frame
        self.last_assign = assign
        self.stats.append(
            dict(frame=self.frame_id, matches=n_matches, inliers=n_inliers,
                 tracked_points=n_tracked_points,
                 tracked_close=tracked_close, new_kf=need_kf,
                 state=self.state,
                 local_points=n_local, n_kfs=self.map.keyframes.n,
                 n_landmarks=int(self.map.landmarks.alive.sum())),
        )

    # ---------------- local mapping (synchronous) ----------------

    def _prefetch_snapshot(self, frame: StereoFrame):
        """Dispatch the keyframe snapshot+BoW read for a device-resident
        frame and start its host copy asynchronously.  Costs nothing if
        never consumed (the buffer is dropped); consumed lazily by
        :meth:`_frame_host`."""
        if self.vocabulary is None:
            return
        if self._snap_prefetch is not None and \
                self._snap_prefetch[0] is frame:
            return
        voc = self.vocabulary
        buf = kf_snapshot(
            frame, voc._device_arrays(), voc.k, voc.L,
            voc.feature_levels_up)
        if hasattr(buf, "copy_to_host_async"):
            buf.copy_to_host_async()
        self._snap_prefetch = (frame, buf)

    def _frame_host(self, frame: StereoFrame) -> dict:
        """Host snapshot of a frame's per-feature arrays, pulled in ONE
        device->host transfer and cached per frame object."""
        if self._frame_cache is not None and self._frame_cache[0] is frame:
            return self._frame_cache[1]
        if self._snap_prefetch is not None and self._snap_prefetch[0] is frame:
            with self._t("kf.snapshot_read"):
                buf = np.asarray(self._snap_prefetch[1])
            self._snap_prefetch = None
            n = frame.capacity
            snap = unpack_frame_np(buf[: 16 * n], n)
            self._frame_cache = (frame, snap)
            self._vocab_cache = (frame, (
                buf[16 * n: 17 * n],
                buf[17 * n: 18 * n].view(np.float32),
                buf[18 * n: 19 * n],
            ))
            return snap
        snap = unpack_frame_np(np.asarray(pack_frame(frame)), frame.capacity)
        self._frame_cache = (frame, snap)
        return snap

    def _insert_keyframe(self, frame: StereoFrame, assign: np.ndarray,
                         timestamp: float, run_ba: bool):
        with self._t("kf.insert_total"):
            return self._insert_keyframe_inner(
                frame, assign, timestamp, run_ba)

    def _insert_keyframe_inner(self, frame: StereoFrame, assign: np.ndarray,
                               timestamp: float, run_ba: bool):
        frame_np = self._frame_host(frame)
        if self._vocab_cache is not None and self._vocab_cache[0] is frame:
            word, wweight, node = self._vocab_cache[1]   # window prefetch
        else:
            word, wweight, node = self.vocabulary.transform(
                frame.desc, levels_up=self.vocabulary.feature_levels_up)
        kf = self.map.add_keyframe(
            frame_np, self.Tcw, assign, self.frame_id, timestamp,
            kp_node=node,
        )
        self.kf_ring.insert(kf, frame)
        bow = self.vocabulary.bow_vector(word, wweight, frame_np["valid"])
        self.kfdb.add(kf, bow)
        if self.loop_closer is None and self.enable_loop_closing:
            from pyorbslam_jax.slam.loop_closing import LoopCloser

            self.loop_closer = LoopCloser(
                self.cfg, self.map, self.vocabulary, self.kfdb
            )
        if self.local_mapper is None:
            from pyorbslam_jax.slam.local_mapping import LocalMapper

            self.local_mapper = LocalMapper(
                self.cfg, self.map,
                ring=self.kf_ring, mirror_fn=self._landmark_mirror)
        new_ids = assign[(assign >= 0) & (self.lm_created_kf[np.maximum(assign, 0)] < 0)]
        self.lm_created_kf[new_ids] = kf
        self.recent_lms.append(np.unique(assign[assign >= 0]))
        self.last_kf_frame = self.frame_id
        if self._mapper_queue is not None:
            self._mapper_queue += 1

        # map-point culling over landmarks created in the last 3 KFs
        if len(self.recent_lms) > 3:
            self.map.cull_map_points(
                self.recent_lms[-3], kf, self.lm_created_kf
            )

        self._mirror_stale = True   # the store changed; re-upload lazily
        if run_ba:
            if self._defer_maintenance:
                # windowed schedule: the mapping work for this keyframe
                # (triangulation / fuse / BA / loop closing) runs AFTER
                # the next window's scan is dispatched, overlapping the
                # chip — the reference's asynchronous LocalMapping lag
                # (LocalMapping.py:43-84)
                self._maint_queue.append((kf, bow))
            else:
                self._kf_maintenance(kf, bow, deferred=False)
        return kf

    def _kf_maintenance(self, kf: int, bow, deferred: bool):
        """LocalMapping + LoopClosing work for one keyframe
        (LocalMapping.run order: triangulate new points over covisible
        neighbors, fuse duplicates, local BA, keyframe culling, then the
        loop-closing stage).  ``deferred`` = running after later frames
        were already tracked: pose refinements fold into the live pose
        as a rigid delta instead of being adopted directly."""
        if self.local_mapper is not None:
            # triangulation + both fuse directions in ONE dispatch + ONE
            # packed read (LocalMapper.maintain)
            with self._t("kf.maintain"):
                self.local_mapper.maintain(kf)

        if kf % self.ba_every_n_kf == 0:
            pre = self.map.keyframes.Tcw[kf].copy()
            with self._t("kf.local_ba"):
                info = self.map.local_ba(kf)
            if info.get("ran"):
                if deferred:
                    delta = self.map.keyframes.Tcw[kf] @ np.linalg.inv(pre)
                    self.Tcw = (delta @ self.Tcw).astype(np.float32)
                else:
                    # adopt the BA-refined pose for the current camera
                    self.Tcw = self.map.keyframes.Tcw[kf].copy()

        if self.local_mapper is not None and kf % 4 == 0:
            self.local_mapper.cull_keyframes(
                kf, on_removed=lambda k: self.kfdb.erase(k))

        if self.loop_closer is not None:
            pre = self.map.keyframes.Tcw[kf].copy()
            with self._t("kf.loop"):
                closed = self.loop_closer.on_keyframe(kf, bow)
            ran_slice = False
            if not closed:
                with self._t("kf.gba_slice"):
                    ran_slice = self.loop_closer.run_gba_slice()
            if ran_slice:
                # amortized global-BA slice from a recent loop closure
                # (bounded per-keyframe latency; see LoopCloser.correct)
                delta = self.map.keyframes.Tcw[kf] @ np.linalg.inv(pre)
                self.Tcw = (delta @ self.Tcw).astype(np.float32)
            if closed:
                # loop correction + pose graph + GBA rewrote the map;
                # adopt the corrected current pose and clear the motion
                # model (the old velocity lives in the pre-correction frame)
                if deferred:
                    delta = self.map.keyframes.Tcw[kf] @ np.linalg.inv(pre)
                    self.Tcw = (delta @ self.Tcw).astype(np.float32)
                else:
                    self.Tcw = self.map.keyframes.Tcw[kf].copy()
                self.velocity = np.eye(4, dtype=np.float32)
        self._mirror_stale = True

    def _run_maintenance_queue(self, blocking: bool = True):
        """Advance the deferred per-keyframe mapping work.

        Each keyframe's mapping pass is a little pipeline —
        maintain-dispatch -> maintain-apply -> BA-dispatch -> BA-apply ->
        culling/loop closing — and the pipelined schedule advances every
        in-flight keyframe ONE device stage per tracked frame
        (``blocking=False``): a stage's read happens one frame after its
        dispatch, so it overlaps the chip's next tracking step.  The
        windowed/flush paths run the pipe to completion
        (``blocking=True``).  Pose refinements fold into the live pose
        as rigid deltas (the reference's async LocalMapping lag,
        LocalMapping.py:43-84)."""
        for kf, bow in self._maint_queue:
            self._maint_pipe.append(dict(
                kf=kf, bow=bow, stage="new", pend=None, ba_pend=None,
                pre=None))
        self._maint_queue = []
        while self._maint_pipe:
            for it in list(self._maint_pipe):
                self._advance_maint_item(it)
                if it["stage"] == "done":
                    self._maint_pipe.remove(it)
            if not blocking:
                break

    def _advance_maint_item(self, it):
        kf, bow = it["kf"], it["bow"]
        lmapper = self.local_mapper
        if it["stage"] == "new":
            if lmapper is None:
                it["stage"] = "maint_done"
                return
            with self._t("kf.maintain_dispatch"):
                it["pend"] = lmapper.maintain_dispatch(kf)
            if it["pend"] is None:
                # ring rotated a participant out: separate-step fallback
                with self._t("kf.maintain"):
                    lmapper.create_new_points(kf)
                    lmapper.fuse_neighbors(kf)
                self._mirror_stale = True
                it["stage"] = "maint_done"
                return
            it["stage"] = "maint_dispatched"
            return
        if it["stage"] == "maint_dispatched":
            # readiness-aware gap: the packed read was
            # copy_to_host_async'd at dispatch; if solve + transfer have
            # not landed yet, defer ONE extra frame instead of blocking
            # (a fixed extra wait compounds map staleness at high
            # keyframe cadence — observed ATE blowup at KF-per-frame)
            if _handle_pending(it["pend"].get("handle")) \
                    and not it.get("waited"):
                it["waited"] = True
                return
            with self._t("kf.maintain_apply"):
                lmapper.maintain_apply(it["pend"])
            self._mirror_stale = True
            it["stage"] = "maint_done"
            return
        if it["stage"] == "maint_done":
            if kf % self.ba_every_n_kf == 0:
                it["pre"] = self.map.keyframes.Tcw[kf].copy()
                with self._t("kf.ba_dispatch"):
                    r = self.map.local_ba(kf, split=True)
                if r.get("pending") is not None:
                    it["ba_pend"] = r["pending"]
                    it["stage"] = "ba_dispatched"
                    return
            it["stage"] = "post_ba"
            return self._advance_maint_item(it)
        if it["stage"] == "ba_dispatched":
            # same readiness-aware deferral as the maintain stage
            if _handle_pending(it["ba_pend"].get("handle")) \
                    and not it.get("ba_waited"):
                it["ba_waited"] = True
                return
            with self._t("kf.ba_apply"):
                self.map.local_ba_apply(it["ba_pend"])
            delta = self.map.keyframes.Tcw[kf] @ np.linalg.inv(it["pre"])
            self.Tcw = (delta @ self.Tcw).astype(np.float32)
            self._mirror_stale = True
            it["stage"] = "post_ba"
            return self._advance_maint_item(it)
        if it["stage"] == "post_ba":
            if lmapper is not None and kf % 4 == 0:
                lmapper.cull_keyframes(
                    kf, on_removed=lambda k: self.kfdb.erase(k))
            if self.loop_closer is not None:
                pre = self.map.keyframes.Tcw[kf].copy()
                with self._t("kf.loop"):
                    closed = self.loop_closer.on_keyframe(kf, bow)
                ran_slice = False
                if not closed:
                    with self._t("kf.gba_slice"):
                        ran_slice = self.loop_closer.run_gba_slice()
                if ran_slice:
                    delta = self.map.keyframes.Tcw[kf] @ np.linalg.inv(pre)
                    self.Tcw = (delta @ self.Tcw).astype(np.float32)
                if closed:
                    delta = self.map.keyframes.Tcw[kf] @ np.linalg.inv(pre)
                    self.Tcw = (delta @ self.Tcw).astype(np.float32)
                    self.velocity = np.eye(4, dtype=np.float32)
            self._mirror_stale = True
            it["stage"] = "done"

    # ---------------- reference-keyframe tracking ----------------

    def _track_reference_keyframe(self, frame: StereoFrame):
        """Tracking.track_reference_key_frame (Tracking.py:329-356): BoW-match
        the current frame against its REFERENCE keyframe (the one its
        relative-pose log anchors to — after relocalizing into an old map
        region this is the old-region keyframe, not the newest one) with
        the 0.7 ratio test at TH_LOW plus rotation consistency
        (ORBMatcher.search_by_BoW_kf_f:21-118), seed the pose from the last
        frame, run motion-only optimization; accepted at >= 10 inliers.
        Falls back to the newest keyframe if the reference is unavailable."""
        ks = self.map.keyframes
        kf = ks.n - 1
        if self.frame_refs and self.frame_refs[-1][0] >= 0:
            ref, _ = self.map.resolve_ref(
                self.frame_refs[-1][0], np.eye(4, dtype=np.float32))
            if 0 <= ref < ks.n and ks.alive[ref]:
                kf = ref
        if kf < 0 or self.vocabulary is None:
            return None
        lm = self.map.landmarks
        kf_lm = lm.resolve(ks.obs_lm[kf])
        q_active = (kf_lm >= 0) & lm.alive[np.maximum(kf_lm, 0)]
        if q_active.sum() < 15:
            return None
        _, _, node = self.vocabulary.transform(
            frame.desc, levels_up=self.vocabulary.feature_levels_up)
        idx, matched = _bow_match_rot_jit(
            jnp.asarray(ks.kp_desc[kf]),
            jnp.asarray(ks.kp_node[kf]), jnp.asarray(q_active),
            frame.desc_bits, popcount(frame.desc), jnp.asarray(node),
            frame.valid,
            jnp.asarray(ks.kp_angle[kf]), frame.angle,
        )
        matched_np = np.asarray(matched)
        if matched_np.sum() < 15:
            return None
        idx_np = np.asarray(idx)
        qi = np.nonzero(matched_np)[0]
        assign = np.full(frame.capacity, -1, np.int32)
        assign[idx_np[qi]] = kf_lm[qi]

        has = assign >= 0
        Xw = lm.pos[np.maximum(assign, 0)]
        obs = np.stack([
            np.asarray(frame.xy)[:, 0], np.asarray(frame.xy)[:, 1],
            np.asarray(frame.u_right)], 1)
        frame_valid = np.asarray(frame.valid)
        edge_active = has & (np.asarray(frame.u_right) > 0) & frame_valid
        inv_sigma2 = np.asarray(self.cfg.orb.inv_level_sigma2)[
            np.asarray(frame.octave)]
        c = self.cfg.camera
        cam5 = jnp.asarray([c.fx, c.fy, c.cx, c.cy, c.bf], jnp.float32)
        pres = pose_opt.pose_optimization(
            jnp.asarray(self.Tcw), jnp.asarray(Xw), jnp.asarray(obs),
            jnp.asarray(inv_sigma2), jnp.asarray(edge_active), cam5,
            rounds=self.cfg.ba.pose_rounds,
            iters=self.cfg.ba.pose_iters_per_round,
        )
        if int(pres.num_inliers) < 10:
            return None
        inl = np.asarray(pres.inliers)
        assign = np.where(edge_active & ~inl, -1, assign)
        return np.asarray(pres.Tcw), assign

    # ---------------- relocalization ----------------

    def _relocalize(self, frame: StereoFrame):
        """Tracking.relocalization (Tracking.py:661-763): BoW candidates ->
        BoW matching (>=15) -> batched EPnP RANSAC -> pose optimization,
        accepted at >=50 stereo inliers after a final refinement."""
        if self.kfdb is None or self.map.keyframes.n == 0:
            return None
        frame_valid = np.asarray(frame.valid)
        word, wweight, node = self.vocabulary.transform(
            frame.desc, levels_up=self.vocabulary.feature_levels_up)
        qbow = self.vocabulary.bow_vector(word, wweight, frame_valid)
        cands = self.kfdb.detect_relocalization_candidates(
            qbow, self.map.covisible_neighbors
        )[:5]
        if not cands:
            return None

        f_bits = unpack_bits(frame.desc)
        f_pop = popcount(frame.desc)
        f_node = jnp.asarray(node)
        cam4 = jnp.asarray(
            [self.cfg.camera.fx, self.cfg.camera.fy,
             self.cfg.camera.cx, self.cfg.camera.cy], jnp.float32)
        cam5 = jnp.asarray(
            [self.cfg.camera.fx, self.cfg.camera.fy, self.cfg.camera.cx,
             self.cfg.camera.cy, self.cfg.camera.bf], jnp.float32)
        sigma2 = np.asarray(self.cfg.orb.level_sigma2)
        inv_sigma2_feat = np.asarray(self.cfg.orb.inv_level_sigma2)[
            np.asarray(frame.octave)]

        for kf in cands:
            ks = self.map.keyframes
            kf_lm = ks.obs_lm[kf]
            q_active = kf_lm >= 0
            idx, dist, matched = _bow_match_jit(
                jnp.asarray(ks.kp_desc[kf]),
                jnp.asarray(ks.kp_node[kf]), jnp.asarray(q_active),
                f_bits, f_pop, f_node, jnp.asarray(frame_valid),
            )
            matched = np.asarray(matched)
            idx = np.asarray(idx)
            if matched.sum() < 15:
                continue
            # correspondences: frame feature -> landmark world pos
            qi = np.nonzero(matched)[0]
            fi = idx[qi]
            lm_ids = self.map.landmarks.resolve(kf_lm[qi])
            ok = lm_ids >= 0
            qi, fi, lm_ids = qi[ok], fi[ok], lm_ids[ok]
            if len(qi) < 15:
                continue
            Xw = self.map.landmarks.pos[lm_ids]
            f_xy = np.asarray(frame.xy)[fi]
            f_oct = np.asarray(frame.octave)[fi]

            # bucket-pad the correspondence count: a fresh shape would
            # compile a fresh RANSAC program
            n = len(qi)
            B = 64
            while B < n:
                B <<= 1
            pad = B - n

            def _p(a, fill=0.0):
                return np.concatenate(
                    [a, np.full((pad,) + a.shape[1:], fill, a.dtype)]) \
                    if pad else a

            res = epnp_ransac(
                jnp.asarray(_p(Xw)), jnp.asarray(_p(f_xy)),
                jnp.asarray(_p(sigma2[f_oct], 1.0)),
                jnp.asarray(np.arange(B) < n), cam4,
                jax.random.PRNGKey(self.frame_id),
            )
            if not bool(res.ok):
                continue
            Tcw0 = np.eye(4, dtype=np.float32)
            Tcw0[:3, :3] = np.asarray(res.R)
            Tcw0[:3, 3] = np.asarray(res.t)

            # motion-only refinement over the matched set
            assign = np.full(frame.capacity, -1, np.int32)
            assign[fi] = lm_ids
            has = assign >= 0
            Xw_full = self.map.landmarks.pos[np.maximum(assign, 0)]
            obs = np.stack([
                np.asarray(frame.xy)[:, 0], np.asarray(frame.xy)[:, 1],
                np.asarray(frame.u_right)], 1)
            edge_active = has & (np.asarray(frame.u_right) > 0) & frame_valid
            pres = pose_opt.pose_optimization(
                jnp.asarray(Tcw0), jnp.asarray(Xw_full), jnp.asarray(obs),
                jnp.asarray(inv_sigma2_feat), jnp.asarray(edge_active), cam5,
            )
            n_good = int(pres.num_inliers)
            if n_good < 10:
                continue
            inl = np.asarray(pres.inliers)
            assign = np.where(edge_active & ~inl, -1, assign)
            Tcw_cur = np.asarray(pres.Tcw)

            # two-tier projection rescue (Tracking.py:724-755): project the
            # candidate KF's landmarks with the coarse pose and re-match —
            # first wide (th=10, ORBdist=100), then, if still marginal,
            # tight (th=3, ORBdist=64); each tier re-runs pose optimization
            # (folded into local_track_step).  Accept at >= 50 inliers.
            lm = self.map.landmarks
            kf_pts = lm.resolve(kf_lm)
            kf_pts = np.unique(kf_pts[kf_pts >= 0])
            kf_pts = kf_pts[lm.alive[kf_pts]]
            cap = _cap_bucket(len(kf_pts), self.cfg.tracking.max_local_points)
            p_ids = np.full(cap, -1, np.int32)
            p_ids[: len(kf_pts)] = kf_pts[:cap]
            p_safe = np.maximum(p_ids, 0)

            def rescue(assign, Tcw_np, radius_mult, max_dist_th):
                lres = local_track_step(
                    frame,
                    jnp.asarray(lm.pos[np.maximum(assign, 0)]),
                    jnp.asarray(assign >= 0),
                    jnp.asarray(lm.pos[p_safe]),
                    jnp.asarray(lm.desc[p_safe]),
                    jnp.asarray(lm.normal[p_safe]),
                    jnp.asarray(lm.dmin[p_safe]),
                    jnp.asarray(lm.dmax[p_safe]),
                    jnp.asarray(p_ids >= 0),
                    jnp.asarray(Tcw_np),
                    self.cfg,
                    radius_mult=radius_mult, max_dist_th=max_dist_th,
                )
                feat_local = np.asarray(lres.feat_local)
                tracked = np.asarray(lres.tracked)
                new_assign = np.where(
                    feat_local >= 0, p_ids[np.maximum(feat_local, 0)], assign
                )
                new_assign = np.where(tracked, new_assign, -1)
                return int(lres.n_inliers), np.asarray(lres.Tcw), new_assign

            if n_good < 50:
                n_good, Tcw_cur, assign = rescue(assign, Tcw_cur, 10.0, 100)
                if 30 < n_good < 50:
                    n_good, Tcw_cur, assign = rescue(assign, Tcw_cur, 3.0, 64)
            if n_good < 50:
                continue
            return Tcw_cur, assign
        return None

    # ---------------- helpers ----------------

    def _ref_kf_tracked_points(self) -> int:
        """KeyFrame.tracked_map_points(minObs) for the reference (latest)
        keyframe: its observed landmarks with enough total observations
        (Tracking.py:483-487; stereo observations count 2)."""
        ks = self.map.keyframes
        ref = ks.n - 1
        if ref < 0:
            return 0
        min_obs = 3 if ks.alive[: ks.n].sum() > 2 else 2
        ids = self.map.landmarks.resolve(ks.obs_lm[ref])
        ids = ids[ids >= 0]
        lm = self.map.landmarks
        ids = ids[lm.alive[ids]]
        return int((lm.n_obs[ids] >= min_obs).sum())

    def _spatial_point_ids(self, Tcw: np.ndarray,
                           radius: float = 80.0) -> np.ndarray:
        """Local map for the WINDOWED schedule: every live landmark
        within ``radius`` of the camera, nearest-first when over
        capacity.  The reference's per-frame covisibility walk
        (update_local_points) only covers ~one keyframe neighborhood —
        frozen for a whole window it starves within a few frames of
        forward motion; a spatial ball around the corrected pose keeps
        the scan anchored for the window's full travel (device frustum
        and scale-band gates do the per-frame narrowing)."""
        lm = self.map.landmarks
        n = lm.n
        if n == 0:
            return np.empty(0, np.int32)
        Ow = -Tcw[:3, :3].T @ Tcw[:3, 3]
        d2 = ((lm.pos[:n] - Ow) ** 2).sum(1)
        sel = lm.alive[:n] & (d2 < radius * radius)
        ids = np.nonzero(sel)[0]
        cap = self.cfg.tracking.max_local_points
        if len(ids) > cap:
            ids = ids[np.argpartition(d2[ids], cap)[:cap]]
        return ids.astype(np.int32)

    def _local_point_ids(self, assign: np.ndarray) -> np.ndarray:
        """update_local_keyframes + update_local_points (Tracking.py:392-436):
        KFs observing currently-assigned landmarks, plus their best
        covisible neighbors; local points = union of their observations.
        One native call (mapcore_local_points) replaces the per-frame
        Python dict walk."""
        tracked = np.unique(assign[assign >= 0])
        if len(tracked) == 0:
            return np.empty(0, np.int32)
        return self.map.core.local_points(
            tracked, self.cfg.tracking.max_local_points)

    def _create_landmarks(self, frame: StereoFrame, Tcw: np.ndarray,
                          limit: Optional[int],
                          existing: Optional[np.ndarray] = None) -> np.ndarray:
        """Depth-ordered stereo landmark creation (create_new_key_frame,
        Tracking.py:523-576)."""
        lm = self.map.landmarks
        snap = self._frame_host(frame)
        depth = snap["depth"]
        valid = snap["valid"]
        octave = snap["octave"]
        desc = snap["desc"]
        assign = (existing.copy() if existing is not None
                  else np.full(frame.capacity, -1, np.int32))

        Twc = np.linalg.inv(Tcw)
        # host-side unproject (Frame.unproject_stereo semantics) — the
        # snapshot already holds everything; no extra device round trip
        cam = self.cfg.camera
        z = depth
        pc = np.stack([
            (snap["xy"][:, 0] - cam.cx) * z / cam.fx,
            (snap["xy"][:, 1] - cam.cy) * z / cam.fy,
            z,
        ], axis=-1)
        pts_w = (pc @ Twc[:3, :3].T + Twc[:3, 3]).astype(np.float32)
        Ow = Twc[:3, 3]

        cand = np.nonzero((depth > 0) & valid & (assign < 0))[0]
        cand = cand[np.argsort(depth[cand])]
        if limit is not None:
            th_depth = self.cfg.camera.depth_threshold
            total = int((assign >= 0).sum())
            take = []
            for i in cand:
                take.append(i)
                total += 1
                if depth[i] > th_depth and total > limit:
                    break
            cand = np.array(take, dtype=np.int64)
        if len(cand) == 0:
            return assign

        po = pts_w[cand] - Ow
        dist = np.linalg.norm(po, axis=1)
        normal = po / np.maximum(dist[:, None], 1e-6)
        ids = lm.add(
            pts_w[cand], desc[cand], normal, dist, octave[cand],
            self.cfg.orb.scale_factor, self.cfg.orb.n_levels,
            ref_kf=self.map.keyframes.n,
        )
        assign[cand] = ids
        return assign
