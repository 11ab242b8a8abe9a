"""Golden tests for the ORB frontend against OpenCV ground truth."""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest

from pyorbslam_jax.config import OrbConfig
from pyorbslam_jax.io.synthetic import make_texture
from pyorbslam_jax.ops import fast as fast_ops
from pyorbslam_jax.ops import hamming as ham
from pyorbslam_jax.ops import orb_descriptor as desc_ops
from pyorbslam_jax.ops import pyramid as pyr_ops
from pyorbslam_jax.ops.extractor import extract_features_jit


@pytest.fixture(scope="module")
def test_image():
    """A corner-rich 480x320 uint8 test image."""
    tex = make_texture(512, seed=42)
    return tex[:320, :480].astype(np.uint8)


class TestPyramid:
    def test_level_sizes_match_reference_rule(self):
        sizes = pyr_ops.level_sizes(376, 1241, 1.2, 8)
        assert sizes[0] == (376, 1241)
        for l, (h, w) in enumerate(sizes):
            assert h == round(376 / 1.2 ** l)
            assert w == round(1241 / 1.2 ** l)

    def test_resize_matches_cv2(self, test_image):
        img = test_image.astype(np.float32)
        out_hw = (267, 400)
        mine = np.asarray(pyr_ops.resize_bilinear(jnp.asarray(img), out_hw))
        ref = cv2.resize(img, (400, 267), interpolation=cv2.INTER_LINEAR)
        assert np.abs(mine - ref).max() < 1.0  # sub-intensity-level agreement

    def test_gaussian_blur_matches_cv2(self, test_image):
        img = test_image.astype(np.float32)
        mine = np.asarray(pyr_ops.gaussian_blur(jnp.asarray(img)))
        ref = cv2.GaussianBlur(img, (7, 7), 2, borderType=cv2.BORDER_REFLECT_101)
        assert np.abs(mine - ref).max() < 0.5


class TestFast:
    def test_matches_cv2_fast(self, test_image):
        th = 20
        score = np.asarray(fast_ops.fast_score_map(jnp.asarray(test_image, jnp.float32)))
        score = np.asarray(fast_ops.nms3x3(jnp.where(jnp.asarray(score) > th, jnp.asarray(score), 0.0)))
        mine = {(x, y) for y, x in zip(*np.nonzero(score))
                if 3 <= x < test_image.shape[1] - 3 and 3 <= y < test_image.shape[0] - 3}

        det = cv2.FastFeatureDetector_create(
            threshold=th, nonmaxSuppression=True,
            type=cv2.FAST_FEATURE_DETECTOR_TYPE_9_16,
        )
        kps = det.detect(test_image)
        theirs = {(int(round(k.pt[0])), int(round(k.pt[1]))) for k in kps}

        assert len(theirs) > 50
        # overlap within 1px (NMS tie-breaks differ)
        def near(p, S):
            x, y = p
            return any((x + dx, y + dy) in S for dx in (-1, 0, 1) for dy in (-1, 0, 1))
        recall = sum(near(p, mine) for p in theirs) / len(theirs)
        precision = sum(near(p, theirs) for p in mine) / max(len(mine), 1)
        assert recall > 0.9, f"recall {recall}"
        assert precision > 0.9, f"precision {precision}"

    def test_cell_fallback_admits_low_threshold_in_empty_cells(self):
        score = np.zeros((64, 64), np.float32)
        score[10, 10] = 25.0   # strong corner in cell (0,0)
        score[10, 40] = 10.0   # weak corner in cell (0,1) with no strong one
        score[12, 12] = 10.0   # weak corner in cell that HAS a strong one
        out = np.asarray(fast_ops.cell_fallback_mask(jnp.asarray(score), 20.0, 7.0, 32))
        assert out[10, 10] > 0
        assert out[10, 40] > 0      # admitted by fallback
        assert out[12, 12] == 0     # suppressed: its cell has a strong corner

    def test_select_keypoints_spreads(self):
        rng = np.random.default_rng(0)
        score = rng.random((128, 128)).astype(np.float32)
        # one hot bucket with huge responses should still be capped
        score[:16, :16] += 100.0
        xy, resp, valid = fast_ops.select_keypoints(jnp.asarray(score), 64, bucket=16, per_bucket_cap=4)
        xy = np.asarray(xy)[np.asarray(valid)]
        in_hot = ((xy[:, 0] < 16) & (xy[:, 1] < 16)).sum()
        assert in_hot <= 4


class TestOrientationAndDescriptors:
    def _keypoints(self, img, n=60):
        score = np.array(fast_ops.fast_score_map(jnp.asarray(img, jnp.float32)))
        score[score <= 20] = 0
        score = np.array(fast_ops.nms3x3(jnp.asarray(score)))
        b = 40
        score[:b] = 0; score[-b:] = 0; score[:, :b] = 0; score[:, -b:] = 0
        ys, xs = np.nonzero(score)
        order = np.argsort(-score[ys, xs])[:n]
        return np.stack([xs[order], ys[order]], axis=1).astype(np.int32)

    def test_ic_angle_matches_direct_formula(self, test_image):
        """IC angle equals the reference formula (IC_Angle:77-104) computed
        point-by-point in numpy with the same umax circular patch."""
        xy = self._keypoints(test_image, n=12)
        img_f = jnp.asarray(test_image, jnp.float32)
        ang = np.asarray(desc_ops.ic_angle(pyr_ops.reflect_pad(img_f, 19), jnp.asarray(xy)))
        umax = desc_ops.umax_table()
        for (x, y), a in zip(xy, ang):
            m01 = m10 = 0.0
            for v in range(-15, 16):
                d = umax[abs(v)]
                for u in range(-d, d + 1):
                    val = float(test_image[y + v, x + u])
                    m10 += u * val
                    m01 += v * val
            want = np.degrees(np.arctan2(m01, m10)) % 360
            assert abs(((a - want) + 180) % 360 - 180) < 1e-2

    def test_descriptors_match_cv2_orb(self, test_image):
        """cv2.ORB.compute with injected angles runs the identical rBRIEF
        constants — byte-level golden check (cv2 keeps provided angles)."""
        xy = self._keypoints(test_image)
        img_f = jnp.asarray(test_image, jnp.float32)
        padded_raw = pyr_ops.reflect_pad(img_f, desc_ops.BORDER)
        ang = np.asarray(desc_ops.ic_angle(padded_raw, jnp.asarray(xy)))
        blurred = pyr_ops.gaussian_blur(img_f)
        padded_blur = pyr_ops.reflect_pad(blurred, desc_ops.BORDER)
        mine = np.asarray(
            desc_ops.brief_descriptors(padded_blur, jnp.asarray(xy), jnp.asarray(ang))
        )

        kps = [
            cv2.KeyPoint(float(x), float(y), 31.0, float(a))
            for (x, y), a in zip(xy, ang)
        ]
        orb = cv2.ORB_create(nlevels=1, edgeThreshold=19)
        kps_out, desc_cv = orb.compute(test_image, kps)
        assert desc_cv is not None and len(kps_out) == len(xy)

        theirs = desc_cv.view("<u4").reshape(-1, 8).astype(np.uint32)
        dist = np.asarray(
            ham.hamming_pairwise(jnp.asarray(mine), jnp.asarray(theirs))
        )
        # identical math up to rounding at the rotated-sample grid; allow a
        # few bits of disagreement for boundary-case samples
        assert np.median(dist) <= 6, f"median hamming to cv2 {np.median(dist)}"
        assert (dist <= 16).mean() > 0.9

    def test_orientation_follows_image_rotation(self, test_image):
        xy = self._keypoints(test_image, n=30)
        img_f = jnp.asarray(test_image, jnp.float32)
        ang0 = np.asarray(desc_ops.ic_angle(pyr_ops.reflect_pad(img_f, 19), jnp.asarray(xy)))

        h, w = test_image.shape
        M = cv2.getRotationMatrix2D((w / 2, h / 2), 30.0, 1.0)
        rot = cv2.warpAffine(test_image, M, (w, h))
        xy_h = np.hstack([xy, np.ones((len(xy), 1))])
        xy_r = (M @ xy_h.T).T.round().astype(np.int32)
        keep = (
            (xy_r[:, 0] > 40) & (xy_r[:, 0] < w - 40)
            & (xy_r[:, 1] > 40) & (xy_r[:, 1] < h - 40)
        )
        ang1 = np.asarray(
            desc_ops.ic_angle(
                pyr_ops.reflect_pad(jnp.asarray(rot, jnp.float32), 19),
                jnp.asarray(xy_r[keep]),
            )
        )
        # getRotationMatrix2D(+30) turns content by -30deg in y-down pixel
        # coords -> IC angles shift by -30
        delta = (ang1 - ang0[keep] + 30.0 + 180) % 360 - 180
        assert np.abs(np.median(delta)) < 5.0


class TestHamming:
    def test_matrix_matches_bruteforce(self):
        rng = np.random.default_rng(1)
        a = rng.integers(0, 2 ** 32, (33, 8), dtype=np.uint32)
        b = rng.integers(0, 2 ** 32, (17, 8), dtype=np.uint32)
        got = np.asarray(ham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
        want = np.zeros((33, 17), np.int32)
        for i in range(33):
            for j in range(17):
                want[i, j] = bin(int.from_bytes(a[i].tobytes(), "little")
                                 ^ int.from_bytes(b[j].tobytes(), "little")).count("1")
        np.testing.assert_array_equal(got, want)


class TestFullExtractor:
    def test_extract_shapes_and_budget(self, test_image):
        orb = OrbConfig(n_features=500, n_levels=4)
        feats = extract_features_jit(jnp.asarray(test_image, jnp.float32), orb)
        cap = orb.max_keypoints
        assert feats.xy.shape == (cap, 2)
        assert feats.desc.shape == (cap, 8)
        n_valid = int(np.asarray(feats.valid).sum())
        assert n_valid > 300  # textured image should nearly fill the budget
        oct_ = np.asarray(feats.octave)[np.asarray(feats.valid)]
        assert oct_.max() == 3 and oct_.min() == 0

    def test_coordinates_are_level0(self, test_image):
        orb = OrbConfig(n_features=500, n_levels=4)
        feats = extract_features_jit(jnp.asarray(test_image, jnp.float32), orb)
        v = np.asarray(feats.valid)
        xy = np.asarray(feats.xy)[v]
        h, w = test_image.shape
        assert (xy[:, 0] >= 0).all() and (xy[:, 0] < w).all()
        assert (xy[:, 1] >= 0).all() and (xy[:, 1] < h).all()


class TestRealImageGolden:
    """Golden frontend parity on a REAL KITTI frame against the
    reference's OWN C++ extractor (pyORBExtractor/ORBextractor.cpp via
    the refbench C shim) — the check pyORBExtractor/test.py:28-55 runs,
    not just cv2 on synthetic texture."""

    REF_IMG = "/root/reference/pyORBExtractor/kitti06-436.png"

    @pytest.fixture(scope="class")
    def ref_extraction(self):
        import os
        import subprocess
        import sys

        if not os.path.exists(self.REF_IMG):
            pytest.skip("reference KITTI frame not present")
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        so = os.path.join(repo, ".bbuild", "liborb_ref.so")
        if not os.path.exists(so):
            os.makedirs(os.path.dirname(so), exist_ok=True)
            src = os.path.join(repo, "tools", "refbench", "orb_c_api.cpp")
            ref_cpp = "/root/reference/pyORBExtractor/ORBextractor.cpp"
            try:
                libs = subprocess.run(
                    ["pkg-config", "--libs", "opencv4"], check=True,
                    capture_output=True, text=True).stdout.split()
                subprocess.run(
                    ["g++", "-O2", "-fPIC", "-shared", "-std=c++14",
                     "-I/root/reference/pyORBExtractor",
                     "-I/usr/include/opencv4", src, ref_cpp, "-o", so]
                    + libs, check=True, capture_output=True)
            except (subprocess.CalledProcessError, FileNotFoundError) as e:
                pytest.skip(f"reference extractor unbuildable here: {e}")
        sys.path.insert(0, os.path.join(repo, "tools", "refbench"))
        from ref_frontend_bench import RefExtractor

        img = cv2.imread(self.REF_IMG, cv2.IMREAD_GRAYSCALE)
        ref = RefExtractor(2000, 1.2, 8, 20, 7)
        keys, desc = ref.operator_kd(img)
        ref_xy = np.array([[k[0], k[1]] for k in keys], np.float32)
        ref_oct = np.array([k[5] for k in keys], np.int32)
        return img, ref_xy, ref_oct, desc

    def test_keypoints_and_descriptors_match_reference_build(
            self, ref_extraction):
        from scipy.spatial import cKDTree

        img, ref_xy, ref_oct, ref_desc = ref_extraction
        orb = OrbConfig(n_features=2000)
        feats = extract_features_jit(jnp.asarray(img, jnp.float32), orb)
        v = np.asarray(feats.valid)
        our_xy = np.asarray(feats.xy)[v]
        our_oct = np.asarray(feats.octave)[v]
        our_desc = np.asarray(feats.desc)[v].view(np.uint8).reshape(-1, 32)

        # similar keypoint budget fill on the real frame
        assert abs(len(our_xy) - len(ref_xy)) < 0.15 * len(ref_xy)

        # spatial agreement: the quadtree vs bucketed-top-k spreaders
        # pick different NMS winners, but half the reference keypoints
        # must still be reproduced to sub-2px (measured ~53% at 1.5 px)
        tree = cKDTree(our_xy)
        d, idx = tree.query(ref_xy, k=1)
        assert (d <= 1.5).mean() > 0.45, (d <= 1.5).mean()

        # descriptor parity at co-located same-octave keypoints: the
        # rBRIEF bytes must match the reference build bit-for-bit up to
        # orientation-estimate noise (measured median 3, p90 9)
        close = (d <= 1.5) & (ref_oct == our_oct[idx])
        assert close.sum() > 500, int(close.sum())
        ham = np.unpackbits(
            ref_desc[close] ^ our_desc[idx[close]], axis=1).sum(1)
        assert np.median(ham) <= 6, np.median(ham)
        assert np.percentile(ham, 90) <= 16, np.percentile(ham, 90)
