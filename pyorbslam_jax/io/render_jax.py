"""Device (JAX) port of the synthetic-world ray-caster.

The numpy renderer (`synthetic.render_view`) costs seconds per frame on
one CPU core for the 129-plane interior world — a 700-frame eval world
takes tens of CPU-minutes, and a KITTI-00-scale 2000-frame world hours.
This module renders the SAME scene description on the accelerator:

- pass 1: a `lax.fori_loop` over planes keeps the running nearest hit
  (depth, texture coords, pixel footprint) per pixel — O(H*W) carry, no
  (H, W, n_planes) materialization;
- pass 2: ONE trilinear mip sample for the winning plane per pixel,
  8 gathers into a flattened mip-atlas (all mip levels concatenated).

Pixel-exact parity with the numpy path is NOT guaranteed (f32 vs f64
ray math; one-pass running-min vs sequential masking resolves ties
identically but rounding can flip a borderline hit), so rendered worlds
carry a distinct stream-cache key — a world is rendered entirely by one
backend, never mixed.  Parity is tested statistically in
tests/test_render_jax.py (median |delta| below the u8 quantization
step).

Used by tools/prerender.py --backend jax and
SyntheticStream(render_backend="jax") to pre-render eval worlds on the
default JAX device.
"""

from __future__ import annotations

import functools
from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.io.synthetic import Plane, _mips_for


class ScenePack:
    """Scene constants staged once: per-plane geometry rows + the mip
    atlas (all levels of the box-filtered chain, flattened)."""

    def __init__(self, planes: List[Plane], tex: np.ndarray):
        P = len(planes)
        self.p0 = np.stack([p.p0 for p in planes]).astype(np.float32)
        self.n = np.stack([p.n for p in planes]).astype(np.float32)
        self.e1 = np.stack([p.e1 for p in planes]).astype(np.float32)
        self.e2 = np.stack([p.e2 for p in planes]).astype(np.float32)
        self.scale = np.asarray(
            [p.tex_scale for p in planes], np.float32)
        # inf extents (unbounded plane) -> huge finite: the inside test
        # then never rejects, matching the numpy branch skip
        self.ext1 = np.asarray(
            [min(p.ext1, 1e30) for p in planes], np.float32)
        self.ext2 = np.asarray(
            [min(p.ext2, 1e30) for p in planes], np.float32)
        self.n_planes = P

        mips = _mips_for(tex)
        self.n_levels = len(mips)
        self.sizes = np.asarray([m.shape[0] for m in mips], np.int32)
        offs = np.concatenate(
            [[0], np.cumsum([m.size for m in mips])]).astype(np.int32)
        self.offsets = offs[:-1]
        self.atlas = np.concatenate(
            [m.astype(np.float32).ravel() for m in mips])


@functools.partial(
    jax.jit, static_argnames=("width", "height", "n_levels"))
def _render(Twc, K4, width, height, n_levels,
            p0, nrm, e1, e2, scale, ext1, ext2,
            atlas, sizes, offsets):
    fx, fy, cx, cy = K4[0], K4[1], K4[2], K4[3]
    us = jnp.arange(width, dtype=jnp.float32)[None, :]
    vs = jnp.arange(height, dtype=jnp.float32)[:, None]
    dirs_c = jnp.stack([
        jnp.broadcast_to((us - cx) / fx, (height, width)),
        jnp.broadcast_to((vs - cy) / fy, (height, width)),
        jnp.ones((height, width), jnp.float32)], axis=-1)
    Rwc = Twc[:3, :3]
    o = Twc[:3, 3]
    dirs = dirs_c @ Rwc.T                       # (H, W, 3)
    dir_n2 = jnp.sum(dirs * dirs, axis=-1)      # (H, W)

    big = jnp.float32(np.inf)
    # carry: nearest hit's depth + texture-px coords + footprint-px
    init = (jnp.full((height, width), big),
            jnp.zeros((height, width), jnp.float32),
            jnp.zeros((height, width), jnp.float32),
            jnp.ones((height, width), jnp.float32))

    def body(i, carry):
        best_t, b_tu, b_tv, b_fp = carry
        denom = dirs @ nrm[i]                   # (H, W)
        num = jnp.dot(p0[i] - o, nrm[i])
        t = jnp.where(jnp.abs(denom) > 1e-9, num / denom, big)
        valid = (t > 0.05) & (t < 400.0) & (t < best_t)
        # rel = (o - p0) + t * dirs, projected on the in-plane axes
        rel0_e1 = jnp.dot(o - p0[i], e1[i])
        rel0_e2 = jnp.dot(o - p0[i], e2[i])
        tu_m = rel0_e1 + t * (dirs @ e1[i])     # meters along e1
        tv_m = rel0_e2 + t * (dirs @ e2[i])
        inside = (jnp.abs(tu_m) <= ext1[i]) & (jnp.abs(tv_m) <= ext2[i])
        hit = valid & inside
        fp = scale[i] * t * dir_n2 / (fx * jnp.abs(denom) + 1e-9)
        return (jnp.where(hit, t, best_t),
                jnp.where(hit, tu_m * scale[i], b_tu),
                jnp.where(hit, tv_m * scale[i], b_tv),
                jnp.where(hit, fp, b_fp))

    best_t, tu, tv, fp = jax.lax.fori_loop(
        0, p0.shape[0], body, init)

    # ---- pass 2: one trilinear mip sample for the winning plane ----
    lvl = jnp.clip(jnp.log2(jnp.maximum(fp, 1.0)), 0.0,
                   n_levels - 1.001)
    l0 = jnp.floor(lvl).astype(jnp.int32)
    fl = lvl - l0

    def sample(level_idx, u, v):
        size = sizes[level_idx]
        off = offsets[level_idx]
        s = jnp.exp2(-level_idx.astype(jnp.float32))
        u = u * s
        v = v * s
        sf = size.astype(jnp.float32)
        u = u - jnp.floor(u / sf) * sf          # mod size
        v = v - jnp.floor(v / sf) * sf
        u0f = jnp.floor(u)
        v0f = jnp.floor(v)
        fu = u - u0f
        fv = v - v0f
        u0 = u0f.astype(jnp.int32) % size
        v0 = v0f.astype(jnp.int32) % size
        u1 = (u0 + 1) % size
        v1 = (v0 + 1) % size

        def at(vv, uu):
            return atlas[off + vv * size + uu]

        a = at(v0, u0) * (1 - fu) + at(v0, u1) * fu
        b = at(v1, u0) * (1 - fu) + at(v1, u1) * fu
        return a * (1 - fv) + b * fv

    l1 = jnp.minimum(l0 + 1, n_levels - 1)
    vals = sample(l0, tu, tv) * (1 - fl) + sample(l1, tu, tv) * fl
    vals = vals / (1.0 + 0.0015 * best_t)       # depth cueing
    img = jnp.where(jnp.isfinite(best_t), vals, 90.0)
    # _to_u8 quantization on device: u8 is also a 4x cheaper readback
    return (jnp.clip(img, 0, 255) + 0.5).astype(jnp.uint8)


class JaxRenderer:
    """Stateful wrapper: stages the scene once, renders u8 frames."""

    def __init__(self, planes: List[Plane], tex: np.ndarray):
        pack = ScenePack(planes, tex)
        self._static = dict(n_levels=pack.n_levels)
        self._args = tuple(jnp.asarray(a) for a in (
            pack.p0, pack.n, pack.e1, pack.e2, pack.scale,
            pack.ext1, pack.ext2, pack.atlas, pack.sizes, pack.offsets))

    def render(self, Twc: np.ndarray, K: np.ndarray,
               width: int, height: int) -> np.ndarray:
        K4 = jnp.asarray(
            [K[0, 0], K[1, 1], K[0, 2], K[1, 2]], jnp.float32)
        out = _render(jnp.asarray(Twc, jnp.float32), K4,
                      width, height, self._static["n_levels"],
                      *self._args)
        return np.asarray(out)
