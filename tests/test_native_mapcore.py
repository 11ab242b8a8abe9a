"""Native map core: equivalence against straightforward Python
recounts, attached-buffer mutation semantics, and gather correctness."""

from collections import defaultdict

import numpy as np
import pytest

from pyorbslam_jax.native import mapcore_ffi


def make_core(n_kf=12, n_feat=64, n_lm=256):
    obs = np.full((n_kf, n_feat), -1, np.int32)
    ur = np.ones((n_kf, n_feat), np.float32)   # all stereo
    oct_ = np.zeros((n_kf, n_feat), np.int32)
    n_obs = np.zeros(n_lm, np.int32)
    alive = np.zeros(n_lm, bool)
    rep = np.full(n_lm, -1, np.int32)
    found = np.ones(n_lm, np.int32)
    vis = np.ones(n_lm, np.int32)
    mc = mapcore_ffi.MapCore(obs, ur, oct_, n_obs, alive, rep, found, vis)
    return mc, dict(obs=obs, ur=ur, oct=oct_, n_obs=n_obs, alive=alive,
                    rep=rep, found=found, vis=vis)


@pytest.fixture(scope="module", autouse=True)
def _native():
    if not mapcore_ffi.available():
        pytest.skip("native mapcore not buildable here")


class TestNativeMapCore:
    def test_covisibility_matches_python(self):
        rng = np.random.default_rng(0)
        mc, bufs = make_core()
        n_kf, n_feat, n_lm = 12, 64, 256
        bufs["alive"][:] = True

        py_lm_obs = defaultdict(dict)
        for kf in range(n_kf):
            picks = rng.choice(n_lm, 40, replace=False)
            slots = rng.choice(n_feat, 40, replace=False)
            bufs["obs"][kf, slots] = picks
            mc.add_keyframe(kf)
            for s, p in zip(slots, picks):
                py_lm_obs[int(p)][kf] = int(s)

        for kf in range(n_kf):
            ids, w, parent = mc.update_connections(kf, th=5)
            counter = defaultdict(int)
            row = bufs["obs"][kf]
            for lm in row[row >= 0]:
                for other in py_lm_obs[int(lm)]:
                    if other != kf:
                        counter[other] += 1
            expect = {o: c for o, c in counter.items() if c >= 5}
            if not expect and counter:
                best = max(counter, key=counter.get)
                expect = {best: counter[best]}
            got = dict(zip(ids.tolist(), w.tolist()))
            assert got == expect, (kf, got, expect)
            assert all(w[i] >= w[i + 1] for i in range(len(w) - 1))
            if counter:
                assert counter[parent] == max(counter.values())

    def test_observation_lifecycle_and_buffers(self):
        mc, bufs = make_core(n_kf=4, n_feat=8, n_lm=32)
        bufs["alive"][:8] = True
        bufs["obs"][0, 0] = 5
        bufs["obs"][0, 2] = 7
        mc.add_keyframe(0)
        assert bufs["n_obs"][5] == 2      # stereo counts 2
        mc.add_observation(5, 1, 3)
        assert bufs["n_obs"][5] == 4
        assert bufs["obs"][1, 3] == 5     # attached buffer mutated
        kfs, feats = mc.observers(5)
        assert kfs.tolist() == [0, 1] and feats.tolist() == [0, 3]

        killed = mc.erase_observation(5, 1)
        assert killed                      # n_obs 2, single observer
        assert not bufs["alive"][5]
        assert bufs["obs"][0, 0] == -1

    def test_replace_forwards_and_folds_counters(self):
        mc, bufs = make_core(n_kf=4, n_feat=8, n_lm=32)
        bufs["alive"][:8] = True
        bufs["obs"][0, 0] = 3
        bufs["obs"][1, 1] = 3
        bufs["obs"][1, 5] = 4
        mc.add_keyframe(0)
        mc.add_keyframe(1)
        bufs["found"][3] = 7
        bufs["vis"][3] = 9
        mc.replace_landmark(3, 4)
        # kf0 had no observation of 4 -> forwarded; kf1 already had 4
        assert bufs["obs"][0, 0] == 4
        assert bufs["obs"][1, 1] == -1
        assert bufs["rep"][3] == 4
        assert not bufs["alive"][3]
        assert bufs["found"][4] == 1 + 7 and bufs["vis"][4] == 1 + 9
        kfs, _ = mc.observers(4)
        assert sorted(kfs.tolist()) == [0, 1]

    def test_local_points_gather(self):
        mc, bufs = make_core(n_kf=6, n_feat=16, n_lm=64)
        bufs["alive"][:40] = True
        # KF0 sees 0..9, KF1 sees 5..14, KF2 sees 30..39
        bufs["obs"][0, :10] = np.arange(10)
        bufs["obs"][1, :10] = np.arange(5, 15)
        bufs["obs"][2, :10] = np.arange(30, 40)
        for kf in range(3):
            mc.add_keyframe(kf)
            mc.update_connections(kf, th=1)
        out = mc.local_points(np.array([5, 6], np.int32), 64)
        # observers of 5,6 are KF0+KF1; their union minus tracked
        assert set(out.tolist()) == set(range(15)) - {5, 6}

    def test_local_ba_gather_and_assemble(self):
        mc, bufs = make_core(n_kf=6, n_feat=16, n_lm=64)
        bufs["alive"][:40] = True
        bufs["obs"][0, :10] = np.arange(10)
        bufs["obs"][1, :10] = np.arange(5, 15)
        bufs["obs"][2, :10] = np.arange(12, 22)
        for kf in range(3):
            mc.add_keyframe(kf)
            mc.update_connections(kf, th=1)
        cams, n_free, pnts = mc.local_ba_gather(1, 2, 64, 6)
        assert cams[0] == 1 and n_free == 2
        # fixed ring contains the remaining observer keyframe
        assert set(cams.tolist()) == {0, 1, 2}
        oc, op, okf, oft = mc.assemble_obs(cams, pnts, 256)
        # every assembled observation points at a real table entry
        for c, p, kf, ft in zip(oc, op, okf, oft):
            assert cams[c] == kf
            assert bufs["obs"][kf, ft] == pnts[p]

    def test_redundancy_counts(self):
        mc, bufs = make_core(n_kf=5, n_feat=8, n_lm=32)
        bufs["alive"][:8] = True
        for kf in range(4):
            bufs["obs"][kf, :4] = np.arange(4)
            mc.add_keyframe(kf)
        n_pts, n_red = mc.redundancy(0)
        assert n_pts == 4 and n_red == 4   # each seen by 3 others
        mc2, bufs2 = make_core(n_kf=5, n_feat=8, n_lm=32)
        bufs2["alive"][:8] = True
        for kf in range(3):
            bufs2["obs"][kf, :4] = np.arange(4)
            mc2.add_keyframe(kf)
        n_pts, n_red = mc2.redundancy(0)
        assert n_pts == 4 and n_red == 0   # only 2 other observers


class TestDirtyDrain:
    def test_kill_and_replace_paths_report_dirty_ids(self):
        mc, bufs = make_core()
        bufs["alive"][:8] = True
        # lm 0 observed by kf 0+1 (stereo => n_obs 4); lm 1 by kf 0 only
        bufs["obs"][0, 0] = 0
        bufs["obs"][1, 1] = 0
        bufs["obs"][0, 2] = 1
        mc.add_keyframe(0)
        mc.add_keyframe(1)
        assert list(mc.drain_dirty()) == []

        mc.kill_landmark(1)
        assert list(mc.drain_dirty()) == [1]
        assert list(mc.drain_dirty()) == []       # drained

        # support collapse inside erase_observation also reports
        mc.erase_observation(0, 0)                # n_obs 4->2, one observer
        assert list(mc.drain_dirty()) == [0]

        # replace flips alive of the source
        bufs["alive"][2] = bufs["alive"][3] = True
        bufs["obs"][1, 5] = 2
        mc.add_observation(2, 1, 5)
        bufs["obs"][0, 6] = 3
        mc.add_observation(3, 0, 6)
        mc.replace_landmark(2, 3)
        assert list(mc.drain_dirty()) == [2]
        # double-kill of an already-dead landmark reports nothing new
        mc.kill_landmark(2)
        assert list(mc.drain_dirty()) == []
