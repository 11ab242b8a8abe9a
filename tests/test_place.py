"""Vocabulary, BoW scoring, keyframe database, and EPnP tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pyorbslam_jax.place import vocabulary as vocab_mod
from pyorbslam_jax.place.keyframe_db import KeyFrameDatabase
from pyorbslam_jax.place.vocabulary import Vocabulary


def random_descriptors(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def perturb(rng, desc, bits=10):
    """Flip `bits` random bits per descriptor."""
    out = desc.copy()
    for i in range(len(out)):
        for _ in range(bits):
            w = rng.integers(0, 8)
            b = rng.integers(0, 32)
            out[i, w] ^= np.uint32(1) << np.uint32(b)
    return out


@pytest.fixture(scope="module")
def voc():
    rng = np.random.default_rng(0)
    return vocab_mod.train(random_descriptors(rng, 4000), k=10, L=4, seed=1)


class TestVocabulary:
    def test_structure(self, voc):
        assert voc.n_words > 100
        leaves = voc.word_id >= 0
        assert (voc.child_start[leaves] == 0).all()

    def test_transform_deterministic(self, voc):
        rng = np.random.default_rng(2)
        d = random_descriptors(rng, 64)
        w1, _, n1 = voc.transform(jnp.asarray(d))
        w2, _, n2 = voc.transform(jnp.asarray(d))
        np.testing.assert_array_equal(w1, w2)
        np.testing.assert_array_equal(n1, n2)
        assert (w1 >= 0).all()

    def test_similar_descriptors_often_share_words(self, voc):
        rng = np.random.default_rng(3)
        d = random_descriptors(rng, 200)
        d2 = perturb(rng, d, bits=6)
        w1, _, _ = voc.transform(jnp.asarray(d))
        w2, _, _ = voc.transform(jnp.asarray(d2))
        share = (w1 == w2).mean()
        # random pairs share words at ~1/n_words; perturbed pairs must be
        # far above that
        assert share > 0.3, share

    def test_save_load_roundtrip(self, voc, tmp_path):
        path = str(tmp_path / "voc.txt")
        voc.save_text(path)
        back = Vocabulary.load_text(path)
        rng = np.random.default_rng(4)
        d = jnp.asarray(random_descriptors(rng, 128))
        w1, _, _ = voc.transform(d)
        w2, _, _ = back.transform(d)
        assert (w1 == w2).mean() > 0.99

    def test_bow_score_self_is_one(self, voc):
        rng = np.random.default_rng(5)
        d = random_descriptors(rng, 300)
        w, wt, _ = voc.transform(jnp.asarray(d))
        bow = voc.bow_vector(w, wt)
        assert abs(Vocabulary.score(bow, bow) - 1.0) < 1e-6

    def test_bow_score_orders_similarity(self, voc):
        rng = np.random.default_rng(6)
        d = random_descriptors(rng, 300)
        d_sim = perturb(rng, d, bits=6)
        d_other = random_descriptors(rng, 300)
        bows = []
        for dd in (d, d_sim, d_other):
            w, wt, _ = voc.transform(jnp.asarray(dd))
            bows.append(voc.bow_vector(w, wt))
        s_sim = Vocabulary.score(bows[0], bows[1])
        s_other = Vocabulary.score(bows[0], bows[2])
        assert s_sim > 2.0 * s_other, (s_sim, s_other)


class TestKeyFrameDatabase:
    def test_loop_candidates_find_similar_kf(self, voc):
        rng = np.random.default_rng(7)
        base = random_descriptors(rng, 300)
        db = KeyFrameDatabase(voc)
        bows = {}
        for kf in range(8):
            d = (perturb(rng, base, bits=8) if kf == 5
                 else random_descriptors(rng, 300))
            w, wt, _ = voc.transform(jnp.asarray(d))
            bows[kf] = voc.bow_vector(w, wt)
            db.add(kf, bows[kf])

        w, wt, _ = voc.transform(jnp.asarray(perturb(rng, base, bits=4)))
        qbow = voc.bow_vector(w, wt)
        cands = db.detect_loop_candidates(
            99, qbow, min_score=0.01, connected=set(), covis_neighbors=lambda k, n: [],
        )
        assert 5 in cands

    def test_erase(self, voc):
        rng = np.random.default_rng(8)
        db = KeyFrameDatabase(voc)
        d = random_descriptors(rng, 100)
        w, wt, _ = voc.transform(jnp.asarray(d))
        bow = voc.bow_vector(w, wt)
        db.add(0, bow)
        db.erase(0)
        cands = db.detect_relocalization_candidates(bow, lambda k, n: [])
        assert cands == []


class TestEPnP:
    def _problem(self, rng, n=60, outlier_frac=0.0):
        from pyorbslam_jax.geometry import se3

        fx = fy = 400.0
        cx, cy = 320.0, 120.0
        Xw = np.stack([
            rng.uniform(-8, 8, n), rng.uniform(-3, 3, n), rng.uniform(5, 30, n)
        ], 1).astype(np.float32)
        xi = np.concatenate([
            rng.normal(0, 0.2, 3), rng.normal(0, 1.0, 3)
        ]).astype(np.float32)
        T = np.asarray(se3.exp_se3(jnp.asarray(xi)))
        Pc = Xw @ T[:3, :3].T + T[:3, 3]
        keep = Pc[:, 2] > 1
        Xw, Pc = Xw[keep], Pc[keep]
        n = len(Xw)
        uv = np.stack([
            fx * Pc[:, 0] / Pc[:, 2] + cx, fy * Pc[:, 1] / Pc[:, 2] + cy
        ], 1).astype(np.float32)
        uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
        n_out = int(outlier_frac * n)
        if n_out:
            sel = rng.choice(n, n_out, replace=False)
            uv[sel] += rng.uniform(30, 120, (n_out, 2)).astype(np.float32)
        cam4 = np.array([fx, fy, cx, cy], np.float32)
        return Xw, uv, cam4, T, n

    def test_ransac_recovers_pose(self):
        from pyorbslam_jax.optim.epnp import epnp_ransac

        rng = np.random.default_rng(0)
        Xw, uv, cam4, T, n = self._problem(rng, outlier_frac=0.25)
        res = epnp_ransac(
            jnp.asarray(Xw), jnp.asarray(uv), jnp.ones(n, jnp.float32),
            jnp.ones(n, bool), jnp.asarray(cam4), jax.random.PRNGKey(0),
        )
        assert bool(res.ok)
        t_err = np.linalg.norm(np.asarray(res.t) - T[:3, 3])
        R_err = np.arccos(np.clip(
            (np.trace(np.asarray(res.R).T @ T[:3, :3]) - 1) / 2, -1, 1))
        assert t_err < 0.1, t_err
        assert R_err < 0.02, R_err
        # inliers found among the 75% clean majority
        assert int(res.n_inliers) > 0.6 * n

    def test_degenerate_fails_gracefully(self):
        from pyorbslam_jax.optim.epnp import epnp_ransac

        rng = np.random.default_rng(1)
        n = 30
        Xw = rng.normal(0, 5, (n, 3)).astype(np.float32)
        uv = rng.uniform(0, 640, (n, 2)).astype(np.float32)  # random garbage
        res = epnp_ransac(
            jnp.asarray(Xw), jnp.asarray(uv), jnp.ones(n, jnp.float32),
            jnp.ones(n, bool),
            jnp.asarray([400.0, 400.0, 320.0, 120.0], jnp.float32),
            jax.random.PRNGKey(0),
        )
        assert int(res.n_inliers) < 15
