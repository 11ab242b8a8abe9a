"""The shipped offline-trained vocabulary asset (tools/train_vocab.py):
scale, idf weighting, default loading, and place-recognition quality on
held-out scenes."""

import numpy as np
import pytest

from pyorbslam_jax.place import vocabulary as vocab_mod


@pytest.fixture(scope="module")
def voc():
    v = vocab_mod.load_default()
    if v is None:
        pytest.skip("vocabulary asset not built")
    return v


class TestVocabularyAsset:
    def test_scale_and_weights(self, voc):
        # a real-scale tree, not a single-frame scene vocabulary
        assert voc.n_words > 50_000
        assert voc.L >= 5 and voc.k == 10
        w = voc.weight[voc.word_id >= 0]
        # corpus idf: non-uniform, mostly positive
        assert (w > 0).mean() > 0.8
        assert np.std(w[w > 0]) > 0.1

    def test_system_loads_asset_by_default(self, data_cache_dir):
        from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
        from pyorbslam_jax.io.synthetic import generate_sequence
        from pyorbslam_jax.slam.system import System

        seq = generate_sequence(
            n_frames=3, width=512, height=160, trajectory="straight",
            speed=0.8, seed=3, cache_dir=data_cache_dir)
        cfg = SlamConfig(camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=512, height=160, bf=seq.bf, th_depth=40.0),
            orb=OrbConfig(n_features=1000))
        sysm = System(cfg)
        for i in range(3):
            sysm.track_stereo(seq.left[i], seq.right[i], seq.timestamps[i])
        assert sysm.vocabulary is not None
        assert sysm.vocabulary.n_words > 50_000

    def test_held_out_place_discrimination(self, voc, data_cache_dir):
        """BoW scores on a HELD-OUT scene (seed not in the training set):
        same-place pairs must outscore different-place pairs by a clear
        margin — the precision property loop detection rests on."""
        import jax.numpy as jnp

        from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
        from pyorbslam_jax.io.synthetic import generate_sequence
        from pyorbslam_jax.slam.frame import build_stereo_frame_jit

        seq = generate_sequence(
            n_frames=24, width=512, height=160, trajectory="straight",
            speed=0.8, seed=77, cache_dir=data_cache_dir)
        cfg = SlamConfig(camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=512, height=160, bf=seq.bf, th_depth=40.0),
            orb=OrbConfig(n_features=1000))
        bows = []
        for i in [0, 1, 12, 22, 23]:
            frame = build_stereo_frame_jit(
                jnp.asarray(seq.left[i], jnp.float32),
                jnp.asarray(seq.right[i], jnp.float32), cfg)
            valid = np.asarray(frame.valid)
            word, ww, _ = voc.transform(
                frame.desc, levels_up=voc.feature_levels_up)
            bows.append(voc.bow_vector(word, ww, valid))
        score = vocab_mod.Vocabulary.score
        same = score(bows[0], bows[1])       # adjacent frames (~same place)
        same2 = score(bows[3], bows[4])
        far = score(bows[0], bows[2])        # ~10 m apart
        farther = score(bows[0], bows[3])    # ~18 m apart
        assert same > 2.0 * farther, (same, farther)
        assert same2 > 2.0 * farther, (same2, farther)
        assert same > far, (same, far)

    def test_text_roundtrip_small(self, tmp_path):
        """ORBvoc.txt writer/reader round trip preserves transform output
        (format parity with TemplatedVocabulary.load_from_text_file)."""
        rng = np.random.default_rng(0)
        desc = rng.integers(0, 2 ** 32, (400, 8), dtype=np.uint32)
        v = vocab_mod.train(desc, k=4, L=3, seed=1)
        path = str(tmp_path / "voc.txt")
        v.save_text(path)
        v2 = vocab_mod.Vocabulary.load_text(path)
        assert v2.k == v.k and v2.L == v.L and v2.n_words == v.n_words
        q = rng.integers(0, 2 ** 32, (64, 8), dtype=np.uint32)
        w1, _, n1 = v.transform(q)
        w2, _, n2 = v2.transform(q)
        np.testing.assert_array_equal(w1, w2)
        np.testing.assert_array_equal(n1, n2)
