"""Keyframe decision parity (Tracking.need_new_key_frame) and
trajectory export through culled keyframes (System.save_trajectory_kitti
spanning-tree chaining, System.py:124-145)."""

import itertools

import numpy as np

from pyorbslam_jax.config import OrbConfig, SlamConfig
from pyorbslam_jax.slam.local_mapping import LocalMapper
from pyorbslam_jax.slam.slam_map import SlamMap
from pyorbslam_jax.slam.system import need_new_keyframe


def reference_decision(n_inliers, n_ref_matches, n_kfs, frame_id,
                       last_kf_frame, last_reloc_frame, tracked_close,
                       non_tracked_close, min_frames, max_frames):
    """Independent transcription of Tracking.py:470-520 (mapper idle)."""
    if frame_id < last_reloc_frame + max_frames and n_kfs > max_frames:
        return False
    need_close = (tracked_close < 100) and (non_tracked_close > 70)
    th_ref_ratio = 0.4 if n_kfs < 2 else 0.75
    c1a = frame_id >= last_kf_frame + max_frames
    c1b = frame_id >= last_kf_frame + min_frames
    c1c = n_inliers < n_ref_matches * 0.25 or need_close
    c2 = (n_inliers < n_ref_matches * th_ref_ratio or need_close) \
        and n_inliers > 15
    return bool((c1a or c1b or c1c) and c2)


class TestNeedNewKeyframe:
    def test_truth_table_matches_reference(self):
        grid = itertools.product(
            [10, 16, 40, 80, 200],        # n_inliers
            [0, 50, 100, 300],            # n_ref_matches
            [1, 2, 5, 20],                # n_kfs
            [5, 30],                      # frame_id
            [0, 25, 29],                  # last_kf_frame
            [-1000, 28],                  # last_reloc_frame
            [50, 150],                    # tracked_close
            [60, 80],                     # non_tracked_close
            [0, 3],                       # min_frames
        )
        for (ninl, nref, nkfs, fid, lkf, lreloc, tc, ntc, minf) in grid:
            expect = reference_decision(
                ninl, nref, nkfs, fid, lkf, lreloc, tc, ntc, minf, 10)
            got = need_new_keyframe(
                n_inliers=ninl, n_ref_matches=nref, n_kfs=nkfs,
                frame_id=fid, last_kf_frame=lkf, last_reloc_frame=lreloc,
                tracked_close=tc, non_tracked_close=ntc,
                min_frames=minf, max_frames=10)
            assert got == expect, (
                ninl, nref, nkfs, fid, lkf, lreloc, tc, ntc, minf)

    def test_min_frames_suppresses_early_keyframes(self):
        # with min_frames=5 and strong tracking, frames right after a KF
        # must not trigger a new one even if the ratio clause fires
        common = dict(
            n_inliers=100, n_ref_matches=200, n_kfs=5,
            last_reloc_frame=-10**9, tracked_close=150,
            non_tracked_close=0, min_frames=5, max_frames=30)
        assert not need_new_keyframe(frame_id=12, last_kf_frame=10, **common)
        assert need_new_keyframe(frame_id=16, last_kf_frame=10, **common)

    def test_mapper_busy_queue_arbitration(self):
        # c1a fires (max_frames elapsed); a busy mapper only accepts the
        # keyframe while its queue is short
        common = dict(
            n_inliers=100, n_ref_matches=200, n_kfs=5, frame_id=45,
            last_kf_frame=10, last_reloc_frame=-10**9, tracked_close=150,
            non_tracked_close=0, min_frames=0, max_frames=30)
        assert need_new_keyframe(mapper_idle=False, queue_len=0, **common)
        assert not need_new_keyframe(mapper_idle=False, queue_len=3, **common)


def _tiny_map(n_kfs=4):
    cfg = SlamConfig(orb=OrbConfig(n_features=128, n_levels=2))
    m = SlamMap(cfg, landmark_capacity=512, keyframe_capacity=16)
    nf = cfg.orb.max_keypoints
    rng = np.random.default_rng(0)
    frame_np = dict(
        xy=rng.uniform(0, 100, (nf, 2)).astype(np.float32),
        octave=np.zeros(nf, np.int32), angle=np.zeros(nf, np.float32),
        desc=np.zeros((nf, 8), np.uint32), valid=np.ones(nf, bool),
        u_right=np.ones(nf, np.float32), depth=np.ones(nf, np.float32),
    )
    # shared landmarks so covisibility links all keyframes
    ids = m.landmarks.add(
        rng.normal(size=(64, 3)).astype(np.float32),
        np.zeros((64, 8), np.uint32), np.tile([0, 0, 1.0], (64, 1)),
        np.full(64, 5.0), np.zeros(64, np.int32), 1.2, 2, ref_kf=0)
    assign = np.full(nf, -1, np.int32)
    assign[:64] = ids
    for k in range(n_kfs):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = float(k)        # distinct poses along x
        m.add_keyframe(frame_np, T, assign.copy(), k, float(k))
    return cfg, m


class TestCulledKeyframeExport:
    def test_resolve_ref_chains_through_dead_ancestors(self):
        cfg, m = _tiny_map(4)
        mapper = LocalMapper(cfg, m)
        ks = m.keyframes

        # a frame referenced KF 2 with some relative offset
        Tcr = np.eye(4, dtype=np.float32)
        Tcr[1, 3] = 0.25
        frame_pose_before = Tcr @ ks.Tcw[2]

        mapper._remove_keyframe(2)
        assert 2 in m.dead_anchor
        ref, Tcr2 = m.resolve_ref(2, Tcr)
        assert ref != 2 and ks.alive[ref]
        np.testing.assert_allclose(
            Tcr2 @ ks.Tcw[ref], frame_pose_before, atol=1e-5)

        # a later correction moves the live anchor: the exported frame
        # pose must follow it through the frozen Tcp chain
        shift = np.eye(4, dtype=np.float32)
        shift[2, 3] = 3.0
        ks.Tcw[ref] = (ks.Tcw[ref] @ shift).astype(np.float32)
        ref2, Tcr3 = m.resolve_ref(2, Tcr)
        assert ref2 == ref
        corrected = Tcr3 @ ks.Tcw[ref]
        np.testing.assert_allclose(
            corrected, frame_pose_before @ shift, atol=1e-5)

    def test_chain_of_two_culls(self):
        cfg, m = _tiny_map(5)
        mapper = LocalMapper(cfg, m)
        ks = m.keyframes
        # force a deeper spanning tree: 3 -> 2 -> 0
        m.children.get(m.parent[3], set()).discard(3)
        m.parent[3] = 2
        m.children.setdefault(2, set()).add(3)
        Tcr = np.eye(4, dtype=np.float32)
        pose_before = Tcr @ ks.Tcw[3]
        mapper._remove_keyframe(3)
        assert m.dead_anchor[3][0] == 2
        mapper._remove_keyframe(2)
        ref, Tcr2 = m.resolve_ref(3, Tcr)
        assert ks.alive[ref] and ref not in m.dead_anchor
        np.testing.assert_allclose(Tcr2 @ ks.Tcw[ref], pose_before, atol=1e-5)


class TestCovisibilityReparenting:
    """KeyFrame.set_bad_flag intended semantics (KeyFrame.py:357-415):
    orphans of a culled keyframe iteratively attach to their strongest
    covisible candidate parent, adopted children joining the candidate
    set — not blindly to the dead KF's parent."""

    def _designed_map(self):
        cfg = SlamConfig(orb=OrbConfig(n_features=128, n_levels=2))
        m = SlamMap(cfg, landmark_capacity=512, keyframe_capacity=16)
        nf = cfg.orb.max_keypoints
        rng = np.random.default_rng(1)
        frame_np = dict(
            xy=rng.uniform(0, 100, (nf, 2)).astype(np.float32),
            octave=np.zeros(nf, np.int32), angle=np.zeros(nf, np.float32),
            desc=np.zeros((nf, 8), np.uint32), valid=np.ones(nf, bool),
            u_right=np.ones(nf, np.float32), depth=np.ones(nf, np.float32),
        )
        ids = m.landmarks.add(
            rng.normal(size=(68, 3)).astype(np.float32),
            np.zeros((68, 8), np.uint32), np.tile([0, 0, 1.0], (68, 1)),
            np.full(68, 5.0), np.zeros(68, np.int32), 1.2, 2, ref_kf=0)
        # landmark groups -> covisibility design:
        # w(0,1)=40 w(0,2)=40 w(1,2)=45 w(0,3)=16 w(1,3)=30 w(2,3)=25
        groups = {
            0: list(range(0, 40)),                        # KFs 0,1,2 (+0..15 with 3)
            1: list(range(0, 45)) + list(range(54, 68)),  # KF 1
            2: list(range(0, 45)) + list(range(45, 54)),  # KF 2
            3: list(range(0, 16)) + list(range(45, 68)),  # KF 3
        }
        for k in range(4):
            assign = np.full(nf, -1, np.int32)
            sel = groups[k]
            assign[: len(sel)] = ids[sel]
            T = np.eye(4, dtype=np.float32)
            T[0, 3] = float(k)
            m.add_keyframe(frame_np, T, assign, k, float(k))
        return cfg, m

    def test_orphans_adopt_strongest_covisible_candidate(self):
        cfg, m = self._designed_map()
        assert m.parent[1] == 0 and m.parent[2] == 1 and m.parent[3] == 1
        assert m.covis_weight(3, 2) == 25 and m.covis_weight(3, 0) == 16

        LocalMapper(cfg, m)._remove_keyframe(1)

        # orphan 2 attaches to candidate 0 (w=40); once adopted, orphan 3
        # prefers 2 (w=25) over the fallback 0 (w=16)
        assert m.parent[2] == 0
        assert m.parent[3] == 2
        # spanning-tree integrity: parents alive, children lists
        # consistent, no cycles
        ks = m.keyframes
        for child, parent in m.parent.items():
            assert ks.alive[parent], (child, parent)
            assert child in m.children.get(parent, set())
        for kf, kids in m.children.items():
            for c in kids:
                assert m.parent[c] == kf
        seen = set()
        node, steps = 3, 0
        while node in m.parent:
            node = m.parent[node]
            assert node not in seen
            seen.add(node)
            steps += 1
            assert steps < 16
