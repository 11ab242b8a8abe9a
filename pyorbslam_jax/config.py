"""Typed configuration for the SLAM engine.

Honors the reference's YAML settings keys for parity
(reference: configs/KITTI00-02.yaml, consumed raw at System.py:33-34 and
Tracking.py:42-77) while adding the capacity/bucketing knobs a fixed-shape
XLA program needs (max keypoints per frame, max landmarks, BA problem
capacities, ...).
"""

from __future__ import annotations

import dataclasses
import math
import re
from typing import Optional

import numpy as np


def _parse_opencv_yaml(path: str) -> dict:
    """Parse an OpenCV-style YAML ("%YAML:1.0" header) settings file.

    PyYAML chokes on the "%YAML:1.0" directive and on OpenCV matrices; the
    reference files only use flat ``key: value`` pairs, so a tolerant
    line-parser covers them exactly.
    """
    out: dict = {}
    with open(path, "r") as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("%") or ":" not in line:
                continue
            key, val = line.split(":", 1)
            key, val = key.strip(), val.strip()
            if not val:
                continue
            try:
                out[key] = int(val)
            except ValueError:
                try:
                    out[key] = float(val)
                except ValueError:
                    out[key] = val
    return out


def load_settings(path: str) -> dict:
    return _parse_opencv_yaml(path)


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    fx: float = 707.0912
    fy: float = 707.0912
    cx: float = 601.8873
    cy: float = 183.1104
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    width: int = 1241
    height: int = 376
    fps: float = 10.0
    bf: float = 379.8145          # stereo baseline (m) times fx
    rgb: bool = True
    th_depth: float = 40.0        # close/far threshold, in baselines

    @property
    def baseline(self) -> float:
        return self.bf / self.fx

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )

    @property
    def depth_threshold(self) -> float:
        """Close-point depth cut: bf * ThDepth / fx (Tracking.py:42-77)."""
        return self.bf * self.th_depth / self.fx


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    n_features: int = 2000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    # --- capacity / layout knobs (new; fixed-shape XLA requirements) ---
    cell_size: int = 32           # FAST fallback-threshold cell (ref uses ~30: ORBextractor.cpp "const float W = 30")
    bucket_size: int = 16         # spatial-spread bucket for top-k distribution
    per_bucket_cap: int = 4       # max retained keypoints per bucket (quadtree stand-in)
    edge_threshold: int = 19      # reflected border (ORBextractor.cpp EDGE_THRESHOLD)
    patch_size: int = 31
    half_patch_size: int = 15
    # Atlas extraction: run both images' pyramids through whole-canvas
    # ops (ops/atlas.py) instead of per-level dispatches.  Identical
    # semantics (tests/test_atlas.py); ~2-3x fewer device kernels.
    use_atlas: bool = True

    @property
    def scale_factors(self) -> np.ndarray:
        return self.scale_factor ** np.arange(self.n_levels, dtype=np.float64)

    @property
    def level_sigma2(self) -> np.ndarray:
        s = self.scale_factors
        return (s * s).astype(np.float32)

    @property
    def inv_level_sigma2(self) -> np.ndarray:
        return (1.0 / self.level_sigma2).astype(np.float32)

    @property
    def features_per_level(self) -> np.ndarray:
        """Geometric per-level budget n*(1-1/s)/(1-(1/s)^L), remainder to the
        coarsest level (ORBextractor.cpp:436-446 semantics)."""
        factor = 1.0 / self.scale_factor
        n_desired = self.n_features * (1 - factor) / (1 - factor ** self.n_levels)
        per_level = []
        total = 0
        for _ in range(self.n_levels - 1):
            n = int(round(n_desired))
            per_level.append(n)
            total += n
            n_desired *= factor
        per_level.append(max(self.n_features - total, 0))
        return np.array(per_level, dtype=np.int32)

    @property
    def max_keypoints(self) -> int:
        """Fixed per-frame keypoint capacity (padded).  Round the total
        budget up to a multiple of 128 so descriptor/distance matrices have
        tile-friendly shapes."""
        n = int(self.features_per_level.sum())
        return int(-(-n // 128) * 128)


@dataclasses.dataclass(frozen=True)
class TrackingConfig:
    # Matching thresholds (ORBMatcher.py:3-5).  The reference's 64x48
    # feature grid and rotation-histogram length are deliberately NOT
    # knobs here: radius queries run as full masked projections and the
    # histogram length is a kernel constant (ops/matching.py) — see
    # PARITY.md.
    th_high: int = 100
    th_low: int = 50
    # Keyframe policy (Tracking.py:470-520): min/max frame gap between
    # keyframes; max_frames is set from camera fps at runtime
    min_frames: int = 0
    max_frames: int = 10
    # The reference's ASYNC LocalMapping stays busy digesting a new
    # keyframe for a few frame-times, which throttles insertion via the
    # bLocalMappingIdle clause (Tracking.py:487,505-519).  The
    # synchronous schedule models that latency explicitly: the mapper
    # counts as busy for this many frames after each keyframe.
    mapper_latency_frames: int = 3
    # Map/landmark capacities (fixed-shape stores)
    max_local_points: int = 8192  # local-map projection set capacity


@dataclasses.dataclass(frozen=True)
class BaConfig:
    # Motion-only pose optimization (Optimizer.py:123-208 semantics)
    pose_rounds: int = 4
    pose_iters_per_round: int = 10
    chi2_mono: float = 5.991
    chi2_stereo: float = 7.815
    # Local BA (Optimizer.py:210-366)
    local_ba_iters1: int = 5
    local_ba_iters2: int = 10
    # sanity cap on how far a LOCAL BA may move a free camera (meters);
    # a nominal local refinement never moves cameras meters — beyond
    # this the solve fed on corrupted geometry and the write-back is
    # rejected (global BA / pose graph corrections are uncapped)
    local_ba_max_move_m: float = 2.0
    # Capacity buckets (problem sizes are bucketed to bound recompiles).
    # max_local_kfs bounds the FREE cameras per local BA to the
    # strongest covisibles (the reference frees ALL covisibles,
    # Optimizer.py:211-236 — unbounded only because its covisibility is
    # naturally local; on corner-rich worlds with long tracks that
    # degenerates into a global BA per keyframe)
    max_local_kfs: int = 24
    max_local_points: int = 16384
    max_local_obs: int = 65536
    # Global BA
    gba_iters: int = 10
    # Pose graph
    pose_graph_iters: int = 20
    # above this many keyframes the essential graph solve switches from
    # the dense (7C x 7C) normal-matrix solver to matrix-free PCG
    pose_graph_cg_threshold: int = 384
    pose_graph_cg_iters: int = 96


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    orb: OrbConfig = dataclasses.field(default_factory=OrbConfig)
    tracking: TrackingConfig = dataclasses.field(default_factory=TrackingConfig)
    ba: BaConfig = dataclasses.field(default_factory=BaConfig)

    @staticmethod
    def from_yaml(path: str) -> "SlamConfig":
        """Build a config from a reference-format settings YAML
        (same keys as configs/KITTI*.yaml)."""
        s = _parse_opencv_yaml(path)
        cam = CameraConfig(
            fx=float(s["Camera.fx"]), fy=float(s["Camera.fy"]),
            cx=float(s["Camera.cx"]), cy=float(s["Camera.cy"]),
            k1=float(s.get("Camera.k1", 0.0)), k2=float(s.get("Camera.k2", 0.0)),
            p1=float(s.get("Camera.p1", 0.0)), p2=float(s.get("Camera.p2", 0.0)),
            width=int(s.get("Camera.width", 1241)),
            height=int(s.get("Camera.height", 376)),
            fps=float(s.get("Camera.fps", 10.0)),
            bf=float(s["Camera.bf"]),
            rgb=bool(s.get("Camera.RGB", 1)),
            th_depth=float(s.get("ThDepth", 40.0)),
        )
        orb = OrbConfig(
            n_features=int(s.get("ORBextractor.nFeatures", 2000)),
            scale_factor=float(s.get("ORBextractor.scaleFactor", 1.2)),
            n_levels=int(s.get("ORBextractor.nLevels", 8)),
            ini_th_fast=int(s.get("ORBextractor.iniThFAST", 20)),
            min_th_fast=int(s.get("ORBextractor.minThFAST", 7)),
        )
        fps = cam.fps if cam.fps > 0 else 30.0
        trk = TrackingConfig(max_frames=int(fps))
        return SlamConfig(camera=cam, orb=orb, tracking=trk)
