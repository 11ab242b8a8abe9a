"""Measure the reference pyOrbSLAM *tracking thread* on this machine.

Drives the reference's own ``Tracking.grab_image_stereo`` per-frame hot
path (/root/reference/Tracking.py:95-280) with its real Python code:

  - Frame construction: 2x C++ ORB extraction + Python stereo matching
    (/root/reference/Frame.py:13-279)
  - ``ORBMatcher.search_by_projection_f_f`` motion-model matching
    (/root/reference/ORBMatcher.py:291-393)
  - ``track_local_map``: is_in_frustum per local point +
    ``search_by_projection_f_p`` (/root/reference/Tracking.py:358-468)
  - keyframe decision + creation incl. MapPoint construction,
    compute_distinctive_descriptors, update_normal_and_depth
    (/root/reference/Tracking.py:470-576)

Only the pieces that CANNOT run here are stubbed, each in the direction
that makes the reference look *faster* (so the measured number remains an
upper bound on its true tracking fps):

  - g2o pose optimization (no Eigen on this machine): replaced by a
    vectorized-numpy Gauss-Newton stand-in (~1-2 ms/frame) that performs
    the same role (pose refinement + 7.815-chi2 outlier flags) at a cost
    far below the real 4x10-iteration g2o solve.
  - BoW (vocabulary load needs the 145 MB ORBvoc.txt, absent):
    ``compute_BoW``/BoW matching are bypassed by seeding the motion model
    so ``track_reference_key_frame`` is never needed — again removing
    reference work from the measurement.
  - LocalMapping/LoopClosing threads: not run at all (their triangulation,
    fuse, local BA and culling costs are excluded) except for the
    bookkeeping tracking itself needs (``Map.add_key_frame``).

Writes baseline_measured.json (scope="tracking-sans-g2o") at the repo
root; the previous frontend-only number is preserved alongside it.
"""

import json
import os
import sys
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
REF = "/root/reference"

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from ref_frontend_bench import RefExtractor  # noqa: E402


# ---------------------------------------------------------------- stubs

class OrderedSet:
    """Minimal ordered-set cover for the reference's `ordered_set` dep."""

    def __init__(self, iterable=()):
        self._d = dict.fromkeys(iterable)

    def add(self, x):
        self._d[x] = None

    append = add

    def clear(self):
        self._d.clear()

    def discard(self, x):
        self._d.pop(x, None)

    def __iter__(self):
        return iter(self._d)

    def __len__(self):
        return len(self._d)

    def __contains__(self, x):
        return x in self._d

    def __sub__(self, other):
        return OrderedSet(k for k in self._d if k not in other)

    def __or__(self, other):
        s = OrderedSet(self._d)
        for k in other:
            s.add(k)
        return s


def install_stub_modules():
    g2o = types.ModuleType("g2o")
    sys.modules.setdefault("g2o", g2o)

    oset = types.ModuleType("ordered_set")
    oset.OrderedSet = OrderedSet
    sys.modules.setdefault("ordered_set", oset)

    pyorb = types.ModuleType("pyORBExtractor")
    pyorb.ORBextractor = RefExtractor
    sys.modules.setdefault("pyORBExtractor", pyorb)


class StubVocabulary:
    """Only reached at stereo_initialization (frame 0, untimed)."""

    def transform(self, descriptors, levels_up):
        return {}, {}


class FakeLocalMapper:
    """The queue surface Tracking consumes; insert does the one piece of
    mapping-thread work tracking depends on (Map registration)."""

    def __init__(self, mp_map):
        self.map = mp_map

    def insert_key_frame(self, kf):
        self.map.add_key_frame(kf)

    def is_stopped(self):
        return False

    def stop_requested(self):
        return False

    def accept_key_frames(self):
        return True

    def interrupt_BA(self):
        pass

    def keyframes_in_queue(self):
        return 0

    def set_not_stop(self, flag):
        return True

    def request_reset(self):
        pass


def make_inline_local_mapper(sysobj, mp_map, stats):
    """The reference's REAL LocalMapping (its mapping-thread Python work),
    run inline per keyframe — on a GIL interpreter the mapping thread's
    work serializes with tracking, so wall-clock frames/s must include
    it.  Its g2o local BA cannot build here and is EXCLUDED; stages that
    hit the port's known-broken methods (SURVEY.md §6: KeyFrame.
    set_bad_flag and friends) are skipped and counted — every exclusion
    favors the reference."""
    from LocalMapping import LocalMapping

    class InlineLocalMapper(LocalMapping):
        def insert_key_frame(self, pKF):
            self.mlNewKeyFrames.append(pKF)
            self.process_new_key_frame()
            for stage in (self.map_point_culling,
                          self.create_new_map_points,
                          self.search_in_neighbors):
                try:
                    stage()
                except Exception as e:  # reference port bugs: skip stage
                    stats.setdefault("mapping_stage_skips", {}).setdefault(
                        f"{stage.__name__}: {type(e).__name__}", 0)
                    stats["mapping_stage_skips"][
                        f"{stage.__name__}: {type(e).__name__}"] += 1
            # g2o local BA: unbuildable here — excluded entirely

        def set_not_stop(self, flag):
            return True

        def is_stopped(self):
            return False

        def stop_requested(self):
            return False

        def accept_key_frames(self):
            return True

        def interrupt_BA(self):
            pass

        def keyframes_in_queue(self):
            return 0

    return InlineLocalMapper(sysobj, mp_map)


class FakeDrawer:
    def update(self, tracker):
        pass

    def set_current_camera_pose(self, pose):
        pass


class FakeSystem:
    def __init__(self):
        self.mpLocalMapper = None
        self.mpLoopCloser = None
        self.mpViewer = None

    def reset(self):
        raise RuntimeError("reference tracking reset — run unhealthy")


# ------------------------------------------------- cheap pose-opt stand-in

def _exp_se3(xi):
    """xi = (vx, vy, vz, wx, wy, wz) -> 4x4, first-order-exact rotation."""
    v, w = xi[:3], xi[3:]
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        R = np.eye(3) + W
        V = np.eye(3)
    else:
        W2 = W @ W
        R = np.eye(3) + np.sin(th) / th * W + (1 - np.cos(th)) / th**2 * W2
        V = (np.eye(3) + (1 - np.cos(th)) / th**2 * W
             + (th - np.sin(th)) / th**3 * W2)
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = V @ v
    return T


def make_cheap_pose_optimization(stats):
    def cheap_pose_optimization(self, frame):
        t0 = time.time()
        idx = [i for i in range(frame.N)
               if frame.mvpMapPoints[i] is not None and frame.mvuRight[i] > 0]
        if len(idx) < 10:
            stats["pose_opt_s"] += time.time() - t0
            return len(idx)
        Xw = np.array([frame.mvpMapPoints[i].get_world_pos().reshape(3)
                       for i in idx])
        kps = np.array([[frame.mvKeysUn[i].pt[0], frame.mvKeysUn[i].pt[1],
                         frame.mvuRight[i]] for i in idx])
        inv_s2 = np.array([frame.mvInvLevelSigma2[frame.mvKeysUn[i].octave]
                           for i in idx])
        fx, fy, cx, cy, bf = frame.fx, frame.fy, frame.cx, frame.cy, frame.mbf
        T = frame.mTcw.astype(np.float64).copy()
        inlier = np.ones(len(idx), bool)
        delta = np.sqrt(7.815)
        for rnd in range(4):
            for _ in range(5):
                Xc = Xw @ T[:3, :3].T + T[:3, 3]
                z = np.maximum(Xc[:, 2], 1e-6)
                u = fx * Xc[:, 0] / z + cx
                v = fy * Xc[:, 1] / z + cy
                ur = u - bf / z
                r = kps - np.stack([u, v, ur], 1)
                # Huber reweighting (dropped in the last round, like the
                # reference's pose_optimization round structure)
                if rnd < 3:
                    e = np.sqrt(np.sum(r * r, 1) * inv_s2)
                    huber = np.where(e > delta, delta / np.maximum(e, 1e-9), 1.0)
                else:
                    huber = np.ones(len(idx))
                # J of residual wrt (v,w) left-perturbation, rows (u,v,ur)
                x, y = Xc[:, 0], Xc[:, 1]
                iz = 1.0 / z
                iz2 = iz * iz
                Ju = np.stack([fx * iz, np.zeros_like(z), -fx * x * iz2], 1)
                Jv = np.stack([np.zeros_like(z), fy * iz, -fy * y * iz2], 1)
                Jr = Ju + np.stack([np.zeros_like(z), np.zeros_like(z),
                                    bf * iz2], 1)
                Jp = np.stack([Ju, Jv, Jr], 1)            # (N,3,3) d/dXc
                Jx = np.zeros((len(idx), 3, 6))
                Jx[:, :, :3] = Jp
                # d(Xc)/dw = -[Xc]x, so col(w_k) = Jp @ (-[Xc]x e_k)
                Jx[:, :, 3] = Jp[:, :, 2] * Xc[:, None, 1] - Jp[:, :, 1] * Xc[:, None, 2]
                Jx[:, :, 4] = Jp[:, :, 0] * Xc[:, None, 2] - Jp[:, :, 2] * Xc[:, None, 0]
                Jx[:, :, 5] = Jp[:, :, 1] * Xc[:, None, 0] - Jp[:, :, 0] * Xc[:, None, 1]
                wgt = (inv_s2 * inlier * huber)[:, None, None]
                H = np.einsum("nik,nil->kl", Jx * wgt, Jx)
                b = np.einsum("nik,ni->k", Jx * wgt, r)
                try:
                    dx = np.linalg.solve(H + 1e-9 * np.eye(6), b)
                except np.linalg.LinAlgError:
                    break
                T = _exp_se3(dx) @ T
            Xc = Xw @ T[:3, :3].T + T[:3, 3]
            z = np.maximum(Xc[:, 2], 1e-6)
            u = fx * Xc[:, 0] / z + cx
            v = fy * Xc[:, 1] / z + cy
            ur = u - bf / z
            chi2 = np.sum((kps - np.stack([u, v, ur], 1)) ** 2, 1) * inv_s2
            inlier = chi2 <= 7.815
        for k, i in enumerate(idx):
            frame.mvbOutlier[i] = not bool(inlier[k])
        frame.set_pose(T.astype(np.float32))
        stats["pose_opt_s"] += time.time() - t0
        return int(inlier.sum())

    return cheap_pose_optimization


# ---------------------------------------------------------------- driver

def load_reference_vocabulary():
    """Export the shipped vocabulary asset to ORBvoc.txt format and load
    it with the reference's OWN TemplatedVocabulary parser, so the
    reference's compute_BoW / search_for_triangulation run their real
    code on their real data structure."""
    from pyDBoW.TemplatedVocabulary import TemplatedVocabulary

    from pyorbslam_jax.place import vocabulary as vocab_mod

    txt = os.path.join(REPO, "tests", "_data", "orbvoc_synth.txt")
    npz = os.path.join(REPO, "pyorbslam_jax", "assets", "orb_vocab.npz")
    if (not os.path.exists(txt)
            or os.path.getmtime(txt) < os.path.getmtime(npz)):
        voc = vocab_mod.load_default()
        voc.save_text(txt)
    ref_voc = TemplatedVocabulary(k=10, L=5, weighting="TF_IDF",
                                  scoring="L1_NORM")
    assert ref_voc.load_from_text_file(txt)
    return ref_voc


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--tracking-only", action="store_true",
                    help="exclude the reference's LocalMapping work "
                         "(mapping is included by default: on a GIL "
                         "interpreter its Python mapping thread "
                         "serializes with tracking)")
    ap.add_argument("--frames", type=int, default=26)
    cli = ap.parse_args()

    install_stub_modules()
    sys.path.insert(0, REF)
    sys.path.insert(0, REPO)
    from pyorbslam_jax.io.synthetic import generate_sequence

    import Optimizer as RefOptimizer
    from Map import Map
    from Tracking import Tracking

    stats = {"pose_opt_s": 0.0}
    RefOptimizer.Optimizer.pose_optimization = make_cheap_pose_optimization(stats)

    with_mapping = not cli.tracking_only
    voc = load_reference_vocabulary() if with_mapping else StubVocabulary()
    n_frames = cli.frames
    width, height = 1241, 376
    seq = generate_sequence(
        n_frames=n_frames, width=width, height=height, trajectory="straight",
        speed=0.8, seed=3, cache_dir=os.path.join(REPO, "tests", "_data"),
    )

    settings = {
        "Camera.fx": float(seq.K[0, 0]), "Camera.fy": float(seq.K[1, 1]),
        "Camera.cx": float(seq.K[0, 2]), "Camera.cy": float(seq.K[1, 2]),
        "Camera.k1": 0.0, "Camera.k2": 0.0, "Camera.p1": 0.0, "Camera.p2": 0.0,
        "Camera.bf": float(seq.bf), "Camera.fps": 10.0, "Camera.RGB": 0,
        "ORBextractor.nFeatures": 2000, "ORBextractor.scaleFactor": 1.2,
        "ORBextractor.nLevels": 8, "ORBextractor.iniThFAST": 20,
        "ORBextractor.minThFAST": 7, "ThDepth": 40.0,
    }

    n_timed = n_frames - 1
    pass_fps = []
    for rep in range(3):
        stats["pose_opt_s"] = 0.0
        sysobj = FakeSystem()
        mp_map = Map()
        drawer = FakeDrawer()
        tracker = Tracking(sysobj, voc, drawer, drawer, mp_map,
                           object(), settings, "STEREO")
        sysobj.mpLocalMapper = (
            make_inline_local_mapper(sysobj, mp_map, stats) if with_mapping
            else FakeLocalMapper(mp_map))

        # frame 0: stereo initialization (untimed)
        tracker.grab_image_stereo(seq.left[0].astype(np.uint8),
                                  seq.right[0].astype(np.uint8), 0.0, 0)
        assert tracker.mState == "OK", "reference stereo init failed"

        # The init-frame copy predates the mpReferenceKF assignment in
        # stereo_initialization (/root/reference/Tracking.py:305-321); the
        # reference only survives because frame 1 takes the BoW path, which
        # we bypass. Point it at the init KF so update_last_frame works.
        tracker.mLastFrame.mpReferenceKF = tracker.mpReferenceKF

        tracker.mnLastRelocFrameId = -10

        t0 = time.time()
        for i in range(1, n_frames):
            # Seed the motion model with the ground-truth velocity delta
            # each frame (mVelocity = Tcw_cur @ Twc_last). This emulates
            # the pose quality the reference's real g2o solver would
            # provide (the numpy stand-in alone drifts and loses tracking
            # by frame ~15) and maximizes match candidates — favoring the
            # reference.
            tracker.mVelocity = (np.linalg.inv(seq.poses_wc[i])
                                 @ seq.poses_wc[i - 1]).astype(np.float32)
            tracker.grab_image_stereo(seq.left[i].astype(np.uint8),
                                      seq.right[i].astype(np.uint8),
                                      0.1 * i, i)
        dt = time.time() - t0
        pass_fps.append(n_timed / dt)

        n_tracked = sum(1 for i in range(tracker.mCurrentFrame.N)
                        if tracker.mCurrentFrame.mvpMapPoints[i] is not None)
        print(f"pass {rep}: {pass_fps[-1]:.3f} fps; {n_tracked} tracked "
              f"points in last frame, {tracker.mnMatchesInliers} inliers, "
              f"{mp_map.key_frames_in_map()} KFs, "
              f"{mp_map.map_points_in_map()} map points")
        assert tracker.mnMatchesInliers >= 30, "reference tracking unhealthy"

    fps = max(pass_fps)  # best of 3 passes: favors the reference
    print(f"reference tracking (sans g2o): {fps:.3f} frames/s "
          f"({1000 / fps:.0f} ms/frame; pose-opt stand-in "
          f"{stats['pose_opt_s'] / n_timed * 1000:.1f} ms/frame of that)")

    prev_path = os.path.join(REPO, "baseline_measured.json")
    frontend_fps = None
    if os.path.exists(prev_path):
        with open(prev_path) as f:
            prev = json.load(f)
        frontend_fps = prev.get("frontend_only_fps", prev.get("reference_fps"))

    if with_mapping:
        scope = (
            "tracking+mapping-sans-g2o (reference Tracking.grab_image_stereo"
            " + its REAL LocalMapping per keyframe, inline as the GIL"
            " serializes it: 2x C++ ORB extraction, Python stereo matching,"
            " projection matchers, local-map frustum search, KF creation,"
            " compute_BoW via its own TemplatedVocabulary, map-point"
            " culling, BoW-guided triangulation, neighbor fuse; its g2o"
            " solves [2-3 pose opts/frame + local BA/KF] are excluded or"
            " replaced by a ~1ms numpy stand-in, and port-broken stages"
            " are skipped - every substitution favors the reference, so"
            " this remains an upper bound on its true full-system speed)")
    else:
        scope = (
            "tracking-sans-g2o (reference Tracking.grab_image_stereo: "
            "2x C++ ORB extraction + Python stereo matching + "
            "search_by_projection_f_f + track_local_map frustum/"
            "projection matching + KF creation; g2o solves replaced by "
            "a ~1ms numpy stand-in, BoW and mapping-thread work "
            "excluded - still an upper bound on reference speed)")
    out = {
        "reference_fps": fps,
        "scope": scope,
        "hardware": "this machine's CPU",
        "config": "1241x376, 2000 features, 8 levels",
        "frontend_only_fps": frontend_fps,
        "pass_fps": pass_fps,
        "pose_opt_standin_s_per_frame": stats["pose_opt_s"] / n_timed,
        "mapping_stage_skips": stats.get("mapping_stage_skips", {}),
    }
    with open(prev_path, "w") as fjson:
        json.dump(out, fjson, indent=1)
    print("wrote baseline_measured.json")


if __name__ == "__main__":
    main()
