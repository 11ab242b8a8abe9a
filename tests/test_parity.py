"""Device-parity helpers (pyorbslam_jax.utils.parity), the GPU guard and
the compile-cache rule.  CPU against CPU every comparison is exact; the
``gpu`` tests hold the card to the stated tolerances against the host."""

import os

import jax
import numpy as np
import pytest

import pyorbslam_jax
from pyorbslam_jax.config import CameraConfig, OrbConfig, SlamConfig
from pyorbslam_jax.ops.hamming import hamming_matrix
from pyorbslam_jax.parallel import dist_ba
from pyorbslam_jax.utils import parity


@pytest.fixture(scope="module")
def pair_and_cfg(data_cache_dir):
    from pyorbslam_jax.io.synthetic import generate_sequence

    seq = generate_sequence(
        n_frames=60, width=512, height=160, trajectory="straight",
        speed=0.8, seed=3, cache_dir=data_cache_dir,
    )
    cfg = SlamConfig(
        camera=CameraConfig(
            fx=float(seq.K[0, 0]), fy=float(seq.K[1, 1]),
            cx=float(seq.K[0, 2]), cy=float(seq.K[1, 2]),
            width=512, height=160, bf=seq.bf, th_depth=40.0),
        orb=OrbConfig(n_features=1000))
    return seq, cfg


@pytest.fixture(scope="module")
def cpu_frames(pair_and_cfg):
    seq, cfg = pair_and_cfg
    cpu = jax.devices("cpu")
    return [parity.stereo_frame_on(cpu[i], seq.left[0], seq.right[0], cfg)
            for i in (0, 1)]


class TestFrameParity:
    def test_cpu_against_cpu_is_exact(self, cpu_frames):
        rep = parity.compare_frames(*cpu_frames)
        assert rep["n_kp_a"] > 700
        assert rep["kp_share"] == 1.0
        assert rep["desc_max"] == 0
        assert rep["depth_share"] == 1.0 and rep["depth_rel_max"] == 0.0
        assert parity.failures("frame", rep) == []

    def test_perturbed_descriptors_are_rejected(self, cpu_frames):
        fa, fb = cpu_frames
        rng = np.random.default_rng(0)
        desc = fb.desc.copy()
        # flip 2 random bits in 60 % of the descriptors: median > 0
        rows = rng.random(len(desc)) < 0.6
        for _ in range(2):
            word = rng.integers(0, 8, len(desc))
            bit = rng.integers(0, 32, len(desc)).astype(np.uint32)
            desc[rows, word[rows]] ^= np.uint32(1) << bit[rows]
        rep = parity.compare_frames(fa, fb._replace(desc=desc))
        assert rep["kp_share"] == 1.0
        bad = parity.failures("frame", rep)
        assert any("desc_median" in b for b in bad), bad

    def test_moved_keypoints_are_rejected(self, cpu_frames):
        fa, fb = cpu_frames
        xy = fb.xy.copy()
        xy[: len(xy) // 20] += 1.0       # 5 % of the slots move a pixel
        rep = parity.compare_frames(fa, fb._replace(xy=xy))
        assert rep["kp_share"] < parity.KP_SHARE_MIN
        assert any("kp_share" in b for b in parity.failures("frame", rep))


class TestOptimizerParity:
    def test_pose_and_local_ba_cpu_against_cpu(self):
        cpu = jax.devices("cpu")
        rep = parity.pose_parity(cpu[0], cpu[1])
        assert rep == dict(n_obs=2000, t_m=0.0, r_rad=0.0)
        rep = parity.local_ba_parity(cpu[0], cpu[1])
        assert rep["t_m"] == 0.0 and rep["r_rad"] == 0.0
        assert rep["n_obs"] > 10000

    def test_pose_delta_resolves_small_rotations(self):
        from pyorbslam_jax.geometry import se3

        T = np.asarray(se3.exp_se3(np.array(
            [0.0, 3e-6, 0.0, 0.0, 0.0, 0.0], np.float32)), np.float64)
        t, r = parity.pose_delta(T, np.eye(4))
        assert t == 0.0 and abs(r - 3e-6) < 1e-7


def test_hamming_matrix_equals_numpy_popcount():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 2 ** 32, (256, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32)
    b[:5] = a[:5]                       # some zero distances
    got = np.asarray(hamming_matrix(a, b))
    ref = parity.hamming_reference(a, b)
    assert np.array_equal(got, ref)
    assert (np.diag(ref[:5, :5]) == 0).all()


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(parity.NotAGpu):
        parity.require_gpu(jax.devices("cpu"))
    with pytest.raises(parity.NotAGpu):
        parity.require_gpu([])


def test_compile_cache_dir_rule(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert pyorbslam_jax.compile_cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert pyorbslam_jax.compile_cache_dir() == os.path.join(repo, ".jax_cache")


def test_distributed_parity_helpers_on_cpu_mesh():
    """The 4-card comparisons of chip_smoke.py --four-cards, on four
    virtual CPU devices at a reduced size."""
    mesh = dist_ba.make_mesh(4)
    rep = parity.dist_ba_parity(
        mesh, prob=parity.global_ba_problem(16, 2048, 256), iters1=4)
    assert parity.failures("dist_ba", rep) == [], rep
    assert len(set(rep["shard_bytes"].values())) == 1     # even split
    assert rep["pnt_moved_median_m"] > 1e-3               # it solved
    rep = parity.dist_pose_graph_parity(mesh, parity.pose_graph_problem(48))
    assert parity.failures("dist_pose_graph", rep) == [], rep
    assert rep["t_correction_max_m"] > 0.1


@pytest.mark.gpu
class TestOnCard:
    """The card against the host CPU on identical inputs (chip_smoke.py's
    parity phase runs the same helpers at 1241x376)."""

    def test_frame_features(self, gpu_device, pair_and_cfg):
        seq, cfg = pair_and_cfg
        rep = parity.frame_parity(seq.left[0], seq.right[0], cfg,
                                  gpu_device, jax.devices("cpu")[0])
        assert parity.failures("frame", rep) == [], rep

    def test_hamming_exact(self, gpu_device):
        rep = parity.hamming_parity(gpu_device, 2048, 2048)
        assert rep["n_mismatch"] == 0

    def test_pose_and_local_ba(self, gpu_device):
        cpu = jax.devices("cpu")[0]
        rep = parity.pose_parity(gpu_device, cpu)
        assert parity.failures("pose", rep) == [], rep
        rep = parity.local_ba_parity(gpu_device, cpu)
        assert parity.failures("local_ba", rep) == [], rep
