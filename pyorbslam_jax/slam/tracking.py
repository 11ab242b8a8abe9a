"""Frame-to-frame tracking: motion model + projection matching + pose LM.

The device side is one jitted program per frame (:func:`motion_track_step`)
reproducing the reference hot path Tracking.track_with_motion_model
(Tracking.py:578-616): project last frame's landmarks with the
constant-velocity pose prediction, match by projection with th=7 px
(falling back to 2*th when matches < 20, selected branchlessly), apply the
rotation-consistency histogram, then run the 4x10 LM pose optimization
with outlier gating, and finally strip outlier assignments.

The host side (:class:`Tracker`) owns the landmark store and the
bookkeeping the reference spreads across Tracking.py's state machine:
stereo initialization (Tracking.py:282-319), velocity update
(Tracking.py:224-232), keyframe-style landmark creation by depth order
(create_new_key_frame, Tracking.py:523-576).  This module alone is a
complete stereo visual odometry (the BASELINE "tracking-only" config);
local mapping / loop closing build on top of it.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.config import SlamConfig
from pyorbslam_jax.geometry import se3
from pyorbslam_jax.ops import matching as match_ops
from pyorbslam_jax.ops.hamming import popcount, unpack_bits
from pyorbslam_jax.optim import pose_opt
from pyorbslam_jax.slam.frame import (
    StereoFrame,
    build_stereo_frame,
    build_stereo_frame_jit,
    unproject,
)
from pyorbslam_jax.slam.mapstore import LandmarkStore

from pyorbslam_jax.utils.precision import f32_matmuls


class TrackStepResult(NamedTuple):
    Tcw: jnp.ndarray          # (4, 4) optimized pose
    feat_query: jnp.ndarray   # (N,) int32: matched query slot per feature (-1)
    tracked: jnp.ndarray      # (N,) bool: feature holds a surviving match
    inlier_edge: jnp.ndarray  # (N,) bool: stereo edge survived chi2 gating
    n_matches: jnp.ndarray    # () int32 matches after rotation check
    n_inliers: jnp.ndarray    # () int32 pose-opt stereo inliers


def _cam_vec(cfg: SlamConfig) -> jnp.ndarray:
    c = cfg.camera
    return jnp.asarray([c.fx, c.fy, c.cx, c.cy, c.bf], jnp.float32)


def _bounds_vec(cfg: SlamConfig) -> jnp.ndarray:
    c = cfg.camera
    return jnp.asarray([0.0, c.width - 1.0, 0.0, c.height - 1.0], jnp.float32)


@functools.partial(jax.jit, static_argnames=("cfg", "th_base"))
def motion_track_step(
    frame: StereoFrame,
    q_pos: jnp.ndarray,        # (Q, 3) landmark world positions (per last-frame slot)
    q_desc: jnp.ndarray,       # (Q, 8) packed landmark descriptors
    q_angle: jnp.ndarray,      # (Q,) last-frame keypoint angle
    q_octave: jnp.ndarray,     # (Q,) last-frame keypoint octave
    q_active: jnp.ndarray,     # (Q,) bool: slot carries a live landmark
    Tcw_pred: jnp.ndarray,     # (4, 4) velocity-model prediction
    Tlw: jnp.ndarray,          # (4, 4) last frame pose (for fwd/bwd octave logic)
    cfg: SlamConfig,
    th_base: float = 7.0,      # search radius tier; retried wider by the host
) -> TrackStepResult:
    cam = _cam_vec(cfg)
    bounds = _bounds_vec(cfg)
    orb = cfg.orb
    scale_factors = jnp.asarray(orb.scale_factors, jnp.float32)
    n_levels = orb.n_levels

    proj = match_ops.project_points(Tcw_pred, q_pos, cam, bounds)

    # forward/backward octave window (ORBMatcher.py:305-352)
    twc = -Tcw_pred[:3, :3].T @ Tcw_pred[:3, 3]
    tlc = Tlw[:3, :3] @ twc + Tlw[:3, 3]
    baseline = cfg.camera.baseline
    fwd = tlc[2] > baseline
    bwd = -tlc[2] > baseline
    min_lev = jnp.where(fwd, q_octave, jnp.where(bwd, 0, q_octave - 1))
    max_lev = jnp.where(
        fwd, n_levels - 1, jnp.where(bwd, q_octave, q_octave + 1)
    )

    q_bits = unpack_bits(q_desc)
    q_pop = popcount(q_desc)
    f_pop = popcount(frame.desc)
    active = q_active & proj.in_image
    f_free = frame.valid

    # ONE Hamming matrix shared by both radius tiers (the product is the
    # expensive part; the window masks are cheap elementwise ops)
    from pyorbslam_jax.ops import hamming as ham

    dist_qf = ham.hamming_matrix_bits(q_bits, q_pop, frame.desc_bits, f_pop)

    def run(th):
        radius = th * scale_factors[q_octave]
        idx, dist, matched = match_ops.match_by_projection(
            proj.u, proj.v, proj.ur, q_bits, q_pop, radius,
            min_lev, max_lev, active,
            frame.xy, frame.octave, frame.u_right, frame.desc_bits, f_pop,
            f_free, max_dist_th=match_ops.TH_HIGH, ratio=None, stereo_gate=True,
            dist=dist_qf,
        )
        matched = match_ops.rotation_consistency_mask(
            q_angle, frame.angle, jnp.maximum(idx, 0), matched
        )
        return idx, matched

    idx1, m1 = run(th_base)
    n1 = jnp.sum(m1.astype(jnp.int32))
    idx2, m2 = run(2.0 * th_base)
    use_wide = n1 < 20
    idx = jnp.where(use_wide, idx2, idx1)
    matched = jnp.where(use_wide, m2, m1)
    n_matches = jnp.sum(matched.astype(jnp.int32))

    # scatter query -> feature assignment
    n_feat = frame.capacity
    q_ids = jnp.arange(q_pos.shape[0], dtype=jnp.int32)
    feat_query = jnp.full((n_feat,), -1, jnp.int32)
    scatter_to = jnp.where(matched, idx, n_feat)  # dump non-matches past the end
    feat_query = jnp.zeros((n_feat + 1,), jnp.int32).at[:].set(-1).at[scatter_to].set(q_ids)[:n_feat]

    has_point = feat_query >= 0
    Xw = q_pos[jnp.maximum(feat_query, 0)]
    obs = jnp.stack([frame.xy[:, 0], frame.xy[:, 1], frame.u_right], axis=-1)
    inv_sigma2 = jnp.asarray(cfg.orb.inv_level_sigma2, jnp.float32)[frame.octave]
    edge_active = has_point & (frame.u_right > 0) & frame.valid

    result = pose_opt.pose_optimization(
        Tcw_pred, Xw, obs, inv_sigma2, edge_active, cam,
        rounds=cfg.ba.pose_rounds, iters=cfg.ba.pose_iters_per_round,
    )

    # outlier assignments are dropped (Tracking.py:601-608); matches
    # without a stereo edge survive on the matcher's word alone
    tracked = has_point & jnp.where(edge_active, result.inliers, True)
    feat_query = jnp.where(tracked, feat_query, -1)

    return TrackStepResult(
        Tcw=result.Tcw,
        feat_query=feat_query,
        tracked=tracked,
        inlier_edge=result.inliers,
        n_matches=n_matches,
        n_inliers=result.num_inliers,
    )


def vo_track_frame(left, right, prev: StereoFrame, Tlw, Tllw,
                   cfg: SlamConfig):
    """One tracked frame as one traceable program, with no map: dual ORB
    extraction + stereo matching + VO queries from the previous frame's
    stereo points + constant-velocity prediction + projection matching +
    LM pose optimization.  Returns (frame, Tcw, n_inliers).  The
    tracking-only benchmark scans it over a sequence; ``chip_smoke.py``
    compiles it at full width."""
    frame = build_stereo_frame(left, right, cfg)
    q_pos = unproject(prev, cfg, se3.inverse(Tlw))
    vel = Tlw @ se3.inverse(Tllw)
    res = motion_track_step.__wrapped__(
        frame, q_pos, prev.desc, prev.angle, prev.octave, prev.depth > 0,
        vel @ Tlw, Tlw, cfg)
    return frame, res.Tcw, res.n_inliers


class LocalTrackResult(NamedTuple):
    Tcw: jnp.ndarray
    feat_local: jnp.ndarray   # (N,) int32: local-point slot newly matched (-1)
    tracked: jnp.ndarray      # (N,) bool: any assignment surviving pose opt
    inlier_edge: jnp.ndarray  # (N,) bool
    n_inliers: jnp.ndarray    # () int32 (mnMatchesInliers analog)
    p_visible: jnp.ndarray    # (P,) bool: local point passed the frustum gate


@functools.partial(
    jax.jit, static_argnames=("cfg", "radius_mult", "max_dist_th"))
def local_track_step(
    frame: StereoFrame,
    feat_xw: jnp.ndarray,      # (N, 3) world pos for already-assigned features
    feat_has: jnp.ndarray,     # (N,) bool feature already has a point
    p_pos: jnp.ndarray,        # (P, 3) local map point positions
    p_desc: jnp.ndarray,       # (P, 8)
    p_normal: jnp.ndarray,     # (P, 3)
    p_dmin: jnp.ndarray,       # (P,) 0.8 * min scale-invariance distance
    p_dmax: jnp.ndarray,       # (P,) 1.2 * max
    p_active: jnp.ndarray,     # (P,) bool (excludes already-assigned points)
    Tcw: jnp.ndarray,          # (4, 4) pose after motion tracking
    cfg: SlamConfig,
    radius_mult: Optional[float] = None,
    max_dist_th: Optional[int] = None,
) -> LocalTrackResult:
    """Tracking.track_local_map (Tracking.py:358-468) as one device program:
    frustum-gate the local point set, match by projection with the
    viewing-cos radius and 0.8 ratio test, then re-run pose optimization
    over the union of assignments.

    With ``radius_mult``/``max_dist_th`` set it instead reproduces the
    relocalization projection rescue (ORBMatcher.search_by_projection_f_kf_f,
    ORBMatcher.py:924-1008): radius = mult * scale[predicted level], level
    window [pred-1, pred+1], best-match Hamming cut at ``max_dist_th``
    with no ratio test (the two reference tiers are 10/100 then 3/64,
    Tracking.py:724-755)."""
    cam = _cam_vec(cfg)
    bounds = _bounds_vec(cfg)
    orb = cfg.orb
    scale_factors = jnp.asarray(orb.scale_factors, jnp.float32)

    proj = match_ops.project_points(Tcw, p_pos, cam, bounds)
    Ow = match_ops.se3_center(Tcw)
    in_frustum = match_ops.frustum_gate(
        proj, p_normal, p_dmin, p_dmax, p_pos, Ow, viewing_cos_limit=0.5
    )
    active = p_active & in_frustum

    # predicted level and radius (ORBMatcher.py:215-246, 285-289)
    max_dist = p_dmax / 1.2
    pred_level = match_ops.predict_scale(
        proj.dist, max_dist, float(np.log(orb.scale_factor)), orb.n_levels
    )
    po = p_pos - Ow
    view_cos = jnp.einsum("pi,pi->p", po, p_normal) / jnp.maximum(proj.dist, 1e-6)
    if radius_mult is None:
        r = jnp.where(view_cos > 0.998, 2.5, 4.0)
        max_level = pred_level
        ratio = 0.8
    else:
        r = jnp.full_like(view_cos, radius_mult)
        max_level = pred_level + 1
        ratio = None
    radius = r * scale_factors[pred_level]

    p_bits = unpack_bits(p_desc)
    p_pop = popcount(p_desc)
    f_pop = popcount(frame.desc)
    f_free = frame.valid & ~feat_has

    idx, _, matched = match_ops.match_by_projection(
        proj.u, proj.v, proj.ur, p_bits, p_pop, radius,
        pred_level - 1, max_level, active,
        frame.xy, frame.octave, frame.u_right, frame.desc_bits, f_pop,
        f_free,
        max_dist_th=(match_ops.TH_HIGH if max_dist_th is None else max_dist_th),
        ratio=ratio, stereo_gate=True,
    )

    n_feat = frame.capacity
    p_ids = jnp.arange(p_pos.shape[0], dtype=jnp.int32)
    scatter_to = jnp.where(matched, idx, n_feat)
    feat_local = jnp.zeros((n_feat + 1,), jnp.int32).at[:].set(-1).at[scatter_to].set(p_ids)[:n_feat]

    has_local = feat_local >= 0
    Xw = jnp.where(
        has_local[:, None], p_pos[jnp.maximum(feat_local, 0)], feat_xw
    )
    has_point = feat_has | has_local
    obs = jnp.stack([frame.xy[:, 0], frame.xy[:, 1], frame.u_right], axis=-1)
    inv_sigma2 = jnp.asarray(cfg.orb.inv_level_sigma2, jnp.float32)[frame.octave]
    edge_active = has_point & (frame.u_right > 0) & frame.valid

    result = pose_opt.pose_optimization(
        Tcw, Xw, obs, inv_sigma2, edge_active, cam,
        rounds=cfg.ba.pose_rounds, iters=cfg.ba.pose_iters_per_round,
    )
    tracked = has_point & jnp.where(edge_active, result.inliers, True)
    feat_local = jnp.where(tracked, feat_local, -1)
    n_inliers = jnp.sum((tracked & edge_active).astype(jnp.int32))
    return LocalTrackResult(
        Tcw=result.Tcw, feat_local=feat_local, tracked=tracked,
        inlier_edge=result.inliers, n_inliers=n_inliers,
        p_visible=active,
    )


@functools.partial(jax.jit, static_argnames=("cfg", "th_base"))
def fused_retrack_step(
    frame: StereoFrame,
    m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive,
    q_lm, frame_prev: StereoFrame, p_ids, Tcw_pred, Tlw,
    cfg: SlamConfig, th_base: float = 7.0,
) -> jnp.ndarray:
    """The full per-frame tracking body (:func:`_fused_track_core`:
    motion-model + local-map matching + pose optimization) on an
    ALREADY-EXTRACTED frame against the CURRENT landmark mirror —
    the device-side re-track of a scan-tracked frame before keyframe
    insertion.  Costs one dispatch + one packed read; skips the ORB
    extraction the scan already did."""
    packed, _, _ = _fused_track_core(
        frame, m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive,
        q_lm, frame_prev, p_ids, Tcw_pred, Tlw, cfg, th_base,
    )
    return packed


class FusedTrackResult(NamedTuple):
    frame: StereoFrame        # the built frame (stays on device)
    packed: jnp.ndarray       # (5 + 16 + N + P,) int32 — everything the host
    #   needs, in ONE buffer (one device->host read per frame):
    #   [0:5]   stats: n_matches, n_inliers_motion, n_inliers_local,
    #           tracked_close, non_tracked_close
    #   [5:21]  Tcw f32 bits (bitcast, row-major)
    #   [21:21+N]   assign: landmark id per feature (-1 none)
    #   [21+N:]     p_visible as 0/1 per local-point slot


@functools.partial(jax.jit, static_argnames=("cfg", "th_base"))
def fused_track_step(
    left: jnp.ndarray, right: jnp.ndarray,
    m_pos: jnp.ndarray,        # (M, 3)  device-resident landmark mirror
    m_desc: jnp.ndarray,       # (M, 8)
    m_normal: jnp.ndarray,     # (M, 3)
    m_dmin: jnp.ndarray,       # (M,)
    m_dmax: jnp.ndarray,       # (M,)
    m_alive: jnp.ndarray,      # (M,) bool
    q_lm: jnp.ndarray,         # (N,) int32 landmark id per LAST-frame feature
    last_frame: StereoFrame,   # previous frame's features (device)
    p_ids: jnp.ndarray,        # (P,) int32 local-map landmark ids (-1 pad)
    Tcw_pred: jnp.ndarray,     # (4, 4) velocity prediction
    Tlw: jnp.ndarray,          # (4, 4) last frame pose
    cfg: SlamConfig,
    th_base: float = 7.0,
) -> FusedTrackResult:
    """The whole per-frame hot path as ONE device program: stereo frame
    build + motion-model tracking + local-map tracking, gathering landmark
    blocks from the device-resident mirror by index.

    Per frame the host uploads only the two images and three small index/
    pose arrays and reads back one packed result — the landmark blocks
    (positions/descriptors/normals/bands) never cross the host boundary.
    This is the array-program reshaping of Tracking.track (Tracking.py:148-280),
    whose object-graph reads the reference does per-feature on the host.

    Semantics note: the local point set ``p_ids`` is the covisible
    neighborhood of the PREVIOUS frame's assignments (the host computes it
    before dispatch), one frame staler than Tracking.update_local_points
    (Tracking.py:392-436).  Between keyframes the local neighborhood is
    static, so this differs only on the frame immediately after a map
    change; weak results fall back to the step-by-step host path.
    """
    frame = build_stereo_frame(left, right, cfg)
    packed, _, _ = _fused_track_core(
        frame, m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive,
        q_lm, last_frame, p_ids, Tcw_pred, Tlw, cfg, th_base,
    )
    return FusedTrackResult(frame=frame, packed=packed)


@f32_matmuls
def _fused_track_core(
    frame: StereoFrame,
    m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive,
    q_lm, frame_prev: StereoFrame, p_ids, Tcw_pred, Tlw, cfg, th_base=7.0,
):
    """Shared device body of the fused per-frame step and the windowed
    scan: motion-model + local-map tracking against the landmark mirror.
    Returns (packed result, Tcw, assign).

    Motion-stage queries are HYBRID: last-frame slots backed by a live
    landmark use the mirror's BA-refined position + distinctive
    descriptor; the rest chain visual odometry off the previous frame's
    stereo unprojection (the reference's temporal-VO-point concept,
    Tracking.py:612-659, promoted to the mainline path).  This keeps
    motion tracking alive when the local map is stale — essential for the
    windowed schedule, whose map is frozen for W frames.
    """
    safe_q = jnp.maximum(q_lm, 0)
    has_lm = (q_lm >= 0) & m_alive[safe_q]
    q_pos_vo = unproject(frame_prev, cfg, se3.inverse(Tlw))
    q_pos = jnp.where(has_lm[:, None], m_pos[safe_q], q_pos_vo)
    q_desc = jnp.where(has_lm[:, None], m_desc[safe_q], frame_prev.desc)
    q_active = has_lm | (frame_prev.valid & (frame_prev.depth > 0))
    res = motion_track_step.__wrapped__(
        frame, q_pos, q_desc, frame_prev.angle, frame_prev.octave, q_active,
        Tcw_pred, Tlw, cfg, th_base,
    )
    # only landmark-backed matches produce map assignments; VO matches
    # still anchored the pose optimization above
    fq_safe = jnp.maximum(res.feat_query, 0)
    assign1 = jnp.where((res.feat_query >= 0) & has_lm[fq_safe],
                        q_lm[fq_safe], -1)
    ok_motion = res.n_matches >= 20
    Tcw_mid = jnp.where(ok_motion, res.Tcw, Tcw_pred)

    feat_has = assign1 >= 0
    feat_xw = m_pos[jnp.maximum(assign1, 0)]
    safe_p = jnp.maximum(p_ids, 0)
    lres = local_track_step.__wrapped__(
        frame, feat_xw, feat_has,
        m_pos[safe_p], m_desc[safe_p], m_normal[safe_p],
        m_dmin[safe_p], m_dmax[safe_p],
        (p_ids >= 0) & m_alive[safe_p],
        Tcw_mid, cfg,
    )
    assign_loc = jnp.where(lres.feat_local >= 0,
                           p_ids[jnp.maximum(lres.feat_local, 0)], assign1)
    assign_loc = jnp.where(lres.tracked, assign_loc, -1)

    # a local stage with too few anchors (stale map) must not overrule a
    # healthy motion/VO pose — keep the motion result in that case
    use_local = lres.n_inliers >= 10
    Tcw_fin = jnp.where(use_local, lres.Tcw, Tcw_mid)
    assign = jnp.where(use_local, assign_loc, assign1)

    depth = frame.depth
    close = (depth > 0) & (depth < cfg.camera.depth_threshold) & frame.valid
    tracked_close = jnp.sum((close & (assign >= 0)).astype(jnp.int32))
    non_tracked_close = jnp.sum((close & (assign < 0)).astype(jnp.int32))
    stats = jnp.stack([
        res.n_matches, res.n_inliers, lres.n_inliers,
        tracked_close, non_tracked_close,
    ]).astype(jnp.int32)
    packed = jnp.concatenate([
        stats,
        jax.lax.bitcast_convert_type(Tcw_fin.reshape(-1), jnp.int32),
        assign,
        lres.p_visible.astype(jnp.int32),
    ])
    return packed, Tcw_fin, assign


def _bitpack_bool(x: jnp.ndarray) -> jnp.ndarray:
    """(P,) bool -> (P/32,) int32 little-endian bit words (P % 32 == 0).
    A scanned row's p_visible reads back 32x smaller packed."""
    bits = x.astype(jnp.uint32).reshape(-1, 32)
    words = (bits << jnp.arange(32, dtype=jnp.uint32)[None, :]).sum(
        axis=1, dtype=jnp.uint32)
    return jax.lax.bitcast_convert_type(words, jnp.int32)


def unpack_bool_np(words: np.ndarray, n: int) -> np.ndarray:
    """Host inverse of :func:`_bitpack_bool` -> (n,) bool."""
    return np.unpackbits(
        words.view(np.uint8), bitorder="little")[:n].astype(bool)


@functools.partial(jax.jit, static_argnames=("cfg",))
def fused_track_window(
    images: jnp.ndarray,       # (W, 2, H, Wd) stereo pairs (u8 or f32)
    m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive,   # landmark mirror
    last_frame: StereoFrame,   # previous frame's features (device)
    q_lm0: jnp.ndarray,        # (N,) landmark id per last-frame feature
    p_ids: jnp.ndarray,        # (P,) local-map ids, fixed for the window
    Tlw0: jnp.ndarray,         # (4, 4) last frame pose
    Tllw0: jnp.ndarray,        # (4, 4) pose before that (velocity seed)
    cfg: SlamConfig,
):
    """Track a WINDOW of frames in one device program: ``lax.scan``
    carries (previous features, landmark assignment, pose pair) across
    frames so the device streams frame after frame with zero host
    involvement — the batch deployment shape (SURVEY §2.3
    "track N frames -> map-update step").

    The local map (mirror + p_ids) is frozen for the window, which
    matches the reference's real-time semantics: its LocalMapping thread
    updates the map asynchronously, so tracking there also runs on a
    map that lags by however long mapping takes.  Keyframe decisions are
    made by the host AFTER the window from the per-frame packed stats.

    Each packed row carries only what the host needs for EVERY frame —
    stats, pose, landmark assignment, and the bit-packed local-point
    visibility.  Frames the host promotes to keyframes pull their
    feature snapshot + BoW vectors afterwards in a second small read
    (:func:`kf_snapshot`) — paying 19N ints per KEYFRAME beats paying
    19N per scanned frame:
      [0:5] stats | [5:21] Tcw | [21:21+N] assign | [+P/32] p_visible bits

    Returns (stacked packed rows (W, row), stacked frames, final carry —
    the carry stays ON DEVICE so the next window can be dispatched
    without waiting for the host to process this one).
    """

    def body(carry, lr):
        frame_prev, q_lm, Tlw, Tllw = carry
        frame = build_stereo_frame(lr[0], lr[1], cfg)
        with jax.default_matmul_precision("float32"):
            vel = Tlw @ se3.inverse(Tllw)
        packed, Tcw, assign = _fused_track_core(
            frame, m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive,
            q_lm, frame_prev, p_ids,
            vel @ Tlw, Tlw, cfg,
        )
        n_core = 21 + assign.shape[0]
        row = jnp.concatenate([
            packed[:n_core], _bitpack_bool(packed[n_core:] != 0)])
        return (frame, assign, Tcw, Tlw), (row, frame)

    carry, (packed, frames) = jax.lax.scan(
        body, (last_frame, q_lm0, Tlw0, Tllw0), images
    )
    return packed, frames, carry


@functools.partial(jax.jit, static_argnames=("cfg",))
def fused_track_chain_step(
    left: jnp.ndarray, right: jnp.ndarray,
    m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive,   # landmark mirror
    frame_prev: StereoFrame,   # previous frame's features (device handle)
    q_lm: jnp.ndarray,         # (N,) landmark id per prev-frame feature
    Tcw_pred: jnp.ndarray,     # (4, 4) velocity-model prediction
    Tlw: jnp.ndarray,          # (4, 4) prev frame pose
    p_ids: jnp.ndarray,        # (P,) local-map ids (-1 pad)
    cfg: SlamConfig,
):
    """One frame of the pipelined per-frame deployment schedule: the
    sync path's :func:`fused_track_step` with the previous frame's
    features kept ON DEVICE (no re-extraction, no re-upload) and the
    result row bit-packing its visibility mask — its readback is started
    asynchronously at dispatch and consumed one call later, which is
    what lets upload(N+1), compute(N) and readback(N-1) overlap.  The reference's never-block tracking thread
    (Tracking.py:95-116) as a depth-2 software pipeline.

    Returns (packed row  [stats 5 | Tcw 16 | assign N | p_visible P/32]
    and the built frame).  The row layout matches
    :func:`fused_track_window`'s."""
    frame = build_stereo_frame(left, right, cfg)
    packed, _, assign = _fused_track_core(
        frame, m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive,
        q_lm, frame_prev, p_ids, Tcw_pred, Tlw, cfg,
    )
    n_core = 21 + assign.shape[0]
    row = jnp.concatenate([
        packed[:n_core], _bitpack_bool(packed[n_core:] != 0)])
    return row, frame


@functools.partial(
    jax.jit,
    static_argnames=("cfg", "th_base", "voc_k", "voc_L", "voc_levels_up"))
def fused_retrack_snapshot_step(
    frame: StereoFrame,
    m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive,
    q_lm, frame_prev: StereoFrame, p_ids, Tcw_pred, Tlw,
    cfg: SlamConfig, voc_arrays,
    voc_k: int, voc_L: int, voc_levels_up: int,
    th_base: float = 7.0,
) -> jnp.ndarray:
    """:func:`fused_retrack_step` + :func:`kf_snapshot` in ONE dispatch
    and ONE packed read — the likely-keyframe re-track path: the host
    gets the re-anchored pose/assignments AND the insertion snapshot/BoW
    without a second round trip.  Layout: [retrack 21+N+P | snapshot 19N]."""
    packed, _, _ = _fused_track_core(
        frame, m_pos, m_desc, m_normal, m_dmin, m_dmax, m_alive,
        q_lm, frame_prev, p_ids, Tcw_pred, Tlw, cfg, th_base,
    )
    snap = kf_snapshot.__wrapped__(
        frame, voc_arrays, voc_k, voc_L, voc_levels_up)
    return jnp.concatenate([packed, snap])


@functools.partial(
    jax.jit, static_argnames=("voc_k", "voc_L", "voc_levels_up"))
def kf_snapshot(
    frame: StereoFrame, voc_arrays,
    voc_k: int, voc_L: int, voc_levels_up: int,
) -> jnp.ndarray:
    """Everything keyframe insertion needs from a device-resident frame,
    in ONE packed read: the host feature snapshot (pack_frame) plus the
    BoW word/weight/node vectors from the vocabulary tree descent
    (Frame.compute_BoW, TemplatedVocabulary.transform:108-161).  Layout:
      [pack_frame 16N | word N | weight bits N | node N]."""
    from pyorbslam_jax.place.vocabulary import _transform_jit
    from pyorbslam_jax.slam.frame import pack_frame

    word, wweight, node = _transform_jit.__wrapped__(
        frame.desc, *voc_arrays, voc_k, voc_L, voc_levels_up)
    return jnp.concatenate([
        pack_frame(frame),
        word.astype(jnp.int32),
        jax.lax.bitcast_convert_type(wweight.astype(jnp.float32), jnp.int32),
        node.astype(jnp.int32),
    ])


@dataclasses.dataclass
class Tracker:
    """Host orchestrator for the tracking-only (visual odometry) pipeline."""

    cfg: SlamConfig
    landmark_capacity: int = 1 << 18
    local_window: int = 10        # recent KF groups forming the local map

    def __post_init__(self):
        self.landmarks = LandmarkStore(self.landmark_capacity)
        self.state = "NOT_INITIALIZED"
        self.Tcw = np.eye(4, dtype=np.float32)
        self.velocity = np.eye(4, dtype=np.float32)
        self.last_frame: Optional[StereoFrame] = None
        self.last_assign: Optional[np.ndarray] = None  # (N,) landmark ids
        self.kf_groups: list = []  # landmark-id arrays per KF event (local map)
        self.frames_since_kf = 0
        self.frame_id = -1
        self.trajectory: list = []
        self.stats: list = []

    def _local_point_ids(self, exclude: np.ndarray) -> np.ndarray:
        """Local map = landmarks of recent KF groups minus already-assigned
        (the port's update_local_points over observer keyframes,
        Tracking.py:424-436, with the recent-KF window standing in for the
        covisibility walk until the keyframe store lands)."""
        cap = self.cfg.tracking.max_local_points
        groups = self.kf_groups[-self.local_window:]
        if not groups:
            return np.empty(0, np.int32)
        ids = np.unique(np.concatenate(groups))
        ids = self.landmarks.resolve(ids)
        ids = ids[(ids >= 0) & self.landmarks.alive[np.maximum(ids, 0)]]
        excl = set(exclude[exclude >= 0].tolist())
        if excl:
            ids = ids[~np.isin(ids, list(excl))]
        return ids[-cap:].astype(np.int32)

    # ---------------- public API ----------------

    def track(self, left: np.ndarray, right: np.ndarray, timestamp: float) -> np.ndarray:
        """Process one stereo pair; returns the current Tcw estimate."""
        self.frame_id += 1
        frame = build_stereo_frame_jit(
            jnp.asarray(left, jnp.float32), jnp.asarray(right, jnp.float32), self.cfg
        )
        if self.state == "NOT_INITIALIZED":
            self._stereo_initialization(frame)
        else:
            self._track_frame(frame, timestamp)
        self.trajectory.append(self.Tcw.copy())
        return self.Tcw

    # ---------------- internals ----------------

    def _stereo_initialization(self, frame: StereoFrame):
        n_valid = int(np.asarray(frame.valid).sum())
        if n_valid <= min(500, self.cfg.orb.n_features // 4):
            return  # wait for a richer frame (Tracking.py:284, scaled)
        self.Tcw = np.eye(4, dtype=np.float32)
        assign = self._create_landmarks(frame, self.Tcw, limit=None)
        self.kf_groups.append(np.unique(assign[assign >= 0]))
        self.last_frame = frame
        self.last_assign = assign
        self.velocity = np.eye(4, dtype=np.float32)
        self.frames_since_kf = 0
        self.state = "OK"

    def _track_frame(self, frame: StereoFrame, timestamp: float):
        Tcw_pred = (self.velocity @ self.Tcw).astype(np.float32)
        lm_ids = self.landmarks.resolve(self.last_assign)
        q_active = lm_ids >= 0
        safe = np.maximum(lm_ids, 0)

        res = motion_track_step(
            frame,
            jnp.asarray(self.landmarks.pos[safe]),
            jnp.asarray(self.landmarks.desc[safe]),
            self.last_frame.angle,
            self.last_frame.octave,
            jnp.asarray(q_active),
            jnp.asarray(Tcw_pred),
            jnp.asarray(self.Tcw),
            self.cfg,
        )
        n_matches = int(res.n_matches)
        feat_query = np.asarray(res.feat_query)
        assign = np.where(feat_query >= 0, lm_ids[np.maximum(feat_query, 0)], -1)
        Tcw_mid = np.asarray(res.Tcw) if n_matches >= 20 else Tcw_pred

        # ---- second stage: local-map tracking ----
        local_ids = self._local_point_ids(exclude=assign)
        cap = self.cfg.tracking.max_local_points
        p_ids = np.full(cap, -1, np.int32)
        p_ids[: len(local_ids)] = local_ids
        p_safe = np.maximum(p_ids, 0)
        feat_has = assign >= 0
        feat_xw = self.landmarks.pos[np.maximum(assign, 0)]

        lres = local_track_step(
            frame,
            jnp.asarray(feat_xw),
            jnp.asarray(feat_has),
            jnp.asarray(self.landmarks.pos[p_safe]),
            jnp.asarray(self.landmarks.desc[p_safe]),
            jnp.asarray(self.landmarks.normal[p_safe]),
            jnp.asarray(self.landmarks.dmin[p_safe]),
            jnp.asarray(self.landmarks.dmax[p_safe]),
            jnp.asarray(p_ids >= 0),
            jnp.asarray(Tcw_mid),
            self.cfg,
        )
        n_inliers = int(lres.n_inliers)
        tracked = np.asarray(lres.tracked)
        feat_local = np.asarray(lres.feat_local)
        assign = np.where(
            feat_local >= 0, p_ids[np.maximum(feat_local, 0)], assign
        )
        assign = np.where(tracked, assign, -1)

        if n_inliers < 20:
            # tracking lost: fall back to the prediction (the full system
            # attempts relocalization here; VO keeps odometry alive by
            # reseeding landmarks below)
            self.state = "WEAK"
            self.Tcw = Tcw_pred
            assign = np.full(frame.capacity, -1, np.int32)
        else:
            self.state = "OK"
            self.Tcw = np.asarray(lres.Tcw)

        self.velocity = (
            self.Tcw @ np.linalg.inv(self.trajectory[-1])
        ).astype(np.float32)

        self.frames_since_kf += 1
        depth = np.asarray(frame.depth)
        th_depth = self.cfg.camera.depth_threshold
        tracked_close = int(((depth > 0) & (depth < th_depth) & (assign >= 0)).sum())
        non_tracked_close = int(((depth > 0) & (depth < th_depth) & (assign < 0)).sum())
        need_close = tracked_close < 100 and non_tracked_close > 70
        need_kf = (
            n_inliers > 15
            and (need_close or self.frames_since_kf >= self.cfg.tracking.max_frames)
        ) or self.state == "WEAK"
        if need_kf:
            assign = self._create_landmarks(
                frame, self.Tcw, limit=100, existing=assign
            )
            group = assign[assign >= 0]
            self.kf_groups.append(np.unique(group))
            self.frames_since_kf = 0

        self.last_frame = frame
        self.last_assign = assign
        self.stats.append(
            dict(frame=self.frame_id, matches=n_matches, inliers=n_inliers,
                 tracked_close=tracked_close, new_kf=need_kf,
                 local_points=len(local_ids))
        )

    def _create_landmarks(
        self,
        frame: StereoFrame,
        Tcw: np.ndarray,
        limit: Optional[int],
        existing: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Create landmarks from stereo depths in depth order
        (create_new_key_frame semantics: unassigned features become new
        points until depth > ThDepth and > ``limit`` points exist)."""
        depth = np.asarray(frame.depth)
        valid = np.asarray(frame.valid)
        xy = np.asarray(frame.xy)
        octave = np.asarray(frame.octave)
        desc = np.asarray(frame.desc)
        assign = (
            existing.copy() if existing is not None
            else np.full(frame.capacity, -1, np.int32)
        )

        Twc = np.linalg.inv(Tcw)
        pts_w = np.asarray(unproject(frame, self.cfg, jnp.asarray(Twc, jnp.float32)))
        Ow = Twc[:3, 3]

        cand = np.nonzero((depth > 0) & valid & (assign < 0))[0]
        cand = cand[np.argsort(depth[cand])]
        if limit is not None:
            th_depth = self.cfg.camera.depth_threshold
            total_pts = int((assign >= 0).sum())
            take = []
            for i in cand:
                take.append(i)
                total_pts += 1
                if depth[i] > th_depth and total_pts > limit:
                    break
            cand = np.array(take, dtype=np.int64)
        if len(cand) == 0:
            return assign

        po = pts_w[cand] - Ow
        dist = np.linalg.norm(po, axis=1)
        normal = po / np.maximum(dist[:, None], 1e-6)
        ids = self.landmarks.add(
            pts_w[cand], desc[cand], normal, dist, octave[cand],
            self.cfg.orb.scale_factor, self.cfg.orb.n_levels, ref_kf=-1,
        )
        assign[cand] = ids
        return assign
