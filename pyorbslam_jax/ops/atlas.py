"""Atlas extraction: the whole ORB frontend as a handful of whole-canvas ops.

The per-level extractor (ops/extractor.py) is semantically exact but
launches 2 images x 8 levels x 6 stages ~ 100 small kernels per frame,
most of them on tiny levels where launch overhead, not work, sets the
cost.  This module packs both images' full pyramids (each level
carrying its own 19 px reflect border, exactly the reference's bordered
working images, ORBextractor.cpp ComputePyramid:1106-1132) into ONE canvas
and runs every dense stage once:

  * FAST-9/16 corner score            -> one pass over the canvas
  * 16 px detection-border masking    -> one static mask multiply
  * two-threshold cell fallback       -> one block-reduce (grid aligned:
        tile pitch is a multiple of cell_size and a single +shift pad
        aligns the canvas grid with every level's own cell grid)
  * 3x3 strict NMS                    -> one pass
  * per-bucket-cap + per-level top-k  -> one batched two-stage top-k
        (bucket candidates first, then (n_tiles, max_cand) top-k --
        never a full-image top-k)
  * IC-moment maps (cumsum windows)   -> one pass
  * Gaussian blur (+ u8 rounding, matching the reference's CV_8U
        working image)                -> one pass
  * rBRIEF sampling                   -> one gather

Equivalence with the per-level path is by construction (identical masks,
grids, budgets per level) and is asserted in tests/test_atlas.py.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from pyorbslam_jax.config import OrbConfig
from pyorbslam_jax.ops import fast as fast_ops
from pyorbslam_jax.ops import orb_descriptor as desc_ops
from pyorbslam_jax.ops import pyramid as pyr_ops
from pyorbslam_jax.ops.extractor import DETECT_BORDER, FrameFeatures, _pad_axis0

PAD = desc_ops.BORDER  # 19


class TileSpec(NamedTuple):
    image: int    # 0 = left, 1 = right
    level: int
    row0: int     # tile (padded image) origin in the canvas
    col0: int
    h: int        # level height/width (interior, without the 19px pad)
    w: int


class AtlasLayout(NamedTuple):
    tiles: Tuple[TileSpec, ...]
    canvas_h: int
    canvas_w: int
    shift: int                 # +shift pad aligns cell & bucket grids
    interior16: np.ndarray     # (canvas_h, canvas_w) f32 0/1: >=16px inside
    # selection plumbing (static):
    cand_idx: np.ndarray       # (n_tiles, max_cand) int32 into the flat
    #                            (n_buckets * cap) candidate arrays
    cand_valid: np.ndarray     # (n_tiles, max_cand) bool (rect may overhang)


@functools.lru_cache(maxsize=8)
def atlas_layout(
    height: int, width: int, scale_factor: float, n_levels: int,
    cell: int, bucket: int, cap: int,
) -> AtlasLayout:
    """Static canvas layout for a stereo pair's two pyramids.

    Tiles are stacked vertically, interleaved [L0, R0, L1, R1, ...], each
    at col0=0 with row pitch rounded up to a multiple of ``cell`` (which
    ``bucket`` divides), so one global +shift aligns the canvas cell AND
    bucket grids with every level's own origin-anchored grids.
    """
    assert cell % bucket == 0, "bucket must divide cell for shared alignment"
    sizes = pyr_ops.level_sizes(height, width, scale_factor, n_levels)
    shift = (-PAD) % cell
    assert (-PAD) % bucket == shift % bucket

    tiles: List[TileSpec] = []
    r = 0
    for l in range(n_levels):
        h, w = sizes[l]
        pitch = -(-(h + 2 * PAD) // cell) * cell
        for img in range(2):
            tiles.append(TileSpec(image=img, level=l, row0=r, col0=0, h=h, w=w))
            r += pitch
    canvas_h = -(-r // 8) * 8
    canvas_w = width + 2 * PAD

    interior16 = np.zeros((canvas_h, canvas_w), np.float32)
    for t in tiles:
        interior16[
            t.row0 + PAD + DETECT_BORDER: t.row0 + PAD + t.h - DETECT_BORDER,
            t.col0 + PAD + DETECT_BORDER: t.col0 + PAD + t.w - DETECT_BORDER,
        ] = 1.0

    # bucket-candidate gather map: the shifted canvas is (canvas_h+shift
    # rows rounded to bucket) x (canvas_w+shift ...); bucket (by, bx) holds
    # cap candidates at flat slot (by*wb + bx)*cap + j.
    hb = -(-(canvas_h + shift) // bucket)
    wb = -(-(canvas_w + shift) // bucket)
    max_cand = 0
    rects = []
    for t in tiles:
        # buckets that can contain this tile's surviving scores (the
        # interior16 region); grid-aligned by construction
        rb0 = (t.row0 + PAD + DETECT_BORDER + shift) // bucket
        rb1 = -(-(t.row0 + PAD + t.h - DETECT_BORDER + shift) // bucket)
        cb0 = (t.col0 + PAD + DETECT_BORDER + shift) // bucket
        cb1 = -(-(t.col0 + PAD + t.w - DETECT_BORDER + shift) // bucket)
        rects.append((rb0, rb1, cb0, cb1))
        max_cand = max(max_cand, (rb1 - rb0) * (cb1 - cb0) * cap)

    cand_idx = np.zeros((len(tiles), max_cand), np.int32)
    cand_valid = np.zeros((len(tiles), max_cand), bool)
    for ti, (rb0, rb1, cb0, cb1) in enumerate(rects):
        by, bx, j = np.meshgrid(
            np.arange(rb0, rb1), np.arange(cb0, cb1), np.arange(cap),
            indexing="ij",
        )
        flat = ((by * wb + bx) * cap + j).reshape(-1)
        cand_idx[ti, : flat.size] = flat
        cand_valid[ti, : flat.size] = True

    return AtlasLayout(
        tiles=tuple(tiles), canvas_h=canvas_h, canvas_w=canvas_w,
        shift=shift, interior16=interior16,
        cand_idx=cand_idx, cand_valid=cand_valid,
    )


def assemble_canvas(
    layout: AtlasLayout,
    levels_l: List[jnp.ndarray],
    levels_r: List[jnp.ndarray],
) -> jnp.ndarray:
    """Reflect-pad every level and concatenate the tiles into the canvas."""
    bands = []
    r = 0
    per_image = (levels_l, levels_r)
    for t in layout.tiles:
        if t.row0 > r:
            bands.append(jnp.zeros((t.row0 - r, layout.canvas_w), jnp.float32))
            r = t.row0
        tile = pyr_ops.reflect_pad(per_image[t.image][t.level], PAD)
        if tile.shape[1] < layout.canvas_w:
            tile = jnp.pad(tile, ((0, 0), (0, layout.canvas_w - tile.shape[1])))
        bands.append(tile)
        r += tile.shape[0]
    if r < layout.canvas_h:
        bands.append(jnp.zeros((layout.canvas_h - r, layout.canvas_w), jnp.float32))
    return jnp.concatenate(bands, axis=0)


def _cell_fallback_shifted(
    score: jnp.ndarray, ini_th: float, min_th: float, cell: int, shift: int
) -> jnp.ndarray:
    """cell_fallback_mask with the grid shifted so canvas cells coincide
    with each level's origin-anchored cells (pitch keeps levels aligned)."""
    padded = jnp.pad(score, ((shift, 0), (shift, 0)))
    out = fast_ops.cell_fallback_mask(padded, ini_th, min_th, cell)
    return out[shift:, shift:]


def _bucket_candidates(
    score: jnp.ndarray, bucket: int, cap: int, shift: int
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Per-bucket top-``cap`` over the shifted canvas.

    Returns (vals (n_buckets*cap,), pix (n_buckets*cap,) int32 flat canvas
    pixel index, -1 where the slot is empty/zero)."""
    h, w = score.shape
    padded = jnp.pad(score, ((shift, 0), (shift, 0)))
    hp, wp = padded.shape
    hb = -(-hp // bucket)
    wb = -(-wp // bucket)
    padded = jnp.pad(padded, ((0, hb * bucket - hp), (0, wb * bucket - wp)))
    blocks = (
        padded.reshape(hb, bucket, wb, bucket)
        .transpose(0, 2, 1, 3)
        .reshape(hb * wb, bucket * bucket)
    )
    vals, inner = jax.lax.top_k(blocks, cap)          # (B, cap)
    by = jnp.arange(hb * wb) // wb
    bx = jnp.arange(hb * wb) % wb
    ys = by[:, None] * bucket + inner // bucket - shift
    xs = bx[:, None] * bucket + inner % bucket - shift
    pix = ys * w + xs
    pix = jnp.where(vals > 0.0, pix, -1)
    return vals.reshape(-1), pix.reshape(-1).astype(jnp.int32)


def extract_features_atlas(
    left: jnp.ndarray, right: jnp.ndarray, orb: OrbConfig,
    levels_l: List[jnp.ndarray] = None, levels_r: List[jnp.ndarray] = None,
) -> Tuple[FrameFeatures, FrameFeatures]:
    """Both images' full ORB extraction as whole-canvas ops.

    Returns (left FrameFeatures, right FrameFeatures), each of capacity
    ``orb.max_keypoints`` — same contract as two extract_features calls.
    """
    h, w = left.shape
    layout = atlas_layout(
        h, w, orb.scale_factor, orb.n_levels,
        orb.cell_size, orb.bucket_size, orb.per_bucket_cap,
    )
    if levels_l is None:
        levels_l = pyr_ops.build_pyramid(left, orb.scale_factor, orb.n_levels)
    if levels_r is None:
        levels_r = pyr_ops.build_pyramid(right, orb.scale_factor, orb.n_levels)
    canvas = assemble_canvas(layout, levels_l, levels_r)

    # ---- dense stages, one pass each ----
    with jax.named_scope("fast_score"):
        score = fast_ops.fast_score_map(canvas)
    score = score * jnp.asarray(layout.interior16)
    score = _cell_fallback_shifted(
        score, float(orb.ini_th_fast), float(orb.min_th_fast),
        orb.cell_size, layout.shift,
    )
    score = fast_ops.nms3x3(score)

    # ---- selection: bucket candidates -> batched per-tile top-k ----
    vals, pix = _bucket_candidates(
        score, orb.bucket_size, orb.per_bucket_cap, layout.shift
    )
    tv = jnp.where(jnp.asarray(layout.cand_valid), vals[layout.cand_idx], 0.0)
    tp = jnp.where(jnp.asarray(layout.cand_valid), pix[layout.cand_idx], -1)

    budgets = orb.features_per_level
    kmax = int(budgets.max())
    top_v, top_i = jax.lax.top_k(tv, kmax)                   # (n_tiles, kmax)
    top_p = jnp.take_along_axis(tp, top_i, axis=1)
    ys = top_p // layout.canvas_w
    xs = top_p % layout.canvas_w
    valid = (top_v > 0.0) & (top_p >= 0)

    # ---- fold tiles into per-image slots FIRST (level-0 coords), so the
    # descriptor stages only touch the 2*sum(budgets) kept keypoints ----
    scale_factors = orb.scale_factors
    cap_total = orb.max_keypoints
    per_img = {0: [], 1: []}   # lists of per-tile dicts
    for ti, t in enumerate(layout.tiles):
        b = int(budgets[t.level])
        va = valid[ti, :b]
        cx = jnp.where(va, xs[ti, :b], PAD)
        cy = jnp.where(va, ys[ti, :b], PAD)
        lx = (cx - (t.col0 + PAD)).astype(jnp.float32)
        ly = (cy - (t.row0 + PAD)).astype(jnp.float32)
        s = jnp.float32(scale_factors[t.level])
        per_img[t.image].append(dict(
            cxy=jnp.stack([cx, cy], -1).astype(jnp.int32),
            xy0=jnp.stack([lx * s, ly * s], -1),
            resp=top_v[ti, :b], oct=jnp.full((b,), t.level, jnp.int32), va=va,
        ))

    def cat(key):
        return jnp.concatenate(
            [d[key] for d in per_img[0]] + [d[key] for d in per_img[1]], axis=0
        )

    cxy = cat("cxy")          # (2*sum(budgets), 2) canvas coords
    xy0 = cat("xy0")
    resp = cat("resp")
    octv = cat("oct")
    va = cat("va")
    n_half = sum(int(budgets[t.level]) for t in layout.tiles if t.image == 0)

    # ---- orientation + descriptors on the canvas, one call each ----
    blur = jnp.round(pyr_ops.gaussian_blur(canvas))  # CV_8U working image

    ang = desc_ops.ic_angles_at(canvas, cxy)
    with jax.named_scope("brief"):
        pat = jnp.asarray(desc_ops.brief_pattern(), jnp.float32)
        rad = jnp.radians(ang)
        a = jnp.cos(rad)[:, None]
        b_ = jnp.sin(rad)[:, None]
        px, py = pat[None, :, 0], pat[None, :, 1]
        rows = jnp.round(px * b_ + py * a).astype(jnp.int32)
        cols = jnp.round(px * a - py * b_).astype(jnp.int32)
        samp = desc_ops.gather_patches(blur, cxy, rows, cols, border=0)
        bits = (samp[:, 0::2] < samp[:, 1::2]).astype(jnp.uint32)
        words = bits.reshape(-1, 8, 32)
        shifts = jnp.arange(32, dtype=jnp.uint32)
        desc = jnp.sum(words << shifts[None, None, :], axis=-1,
                       dtype=jnp.uint32)

    out: List[FrameFeatures] = []
    for img, sl in ((0, slice(0, n_half)), (1, slice(n_half, None))):
        v = va[sl]
        out.append(
            FrameFeatures(
                xy=_pad_axis0(jnp.where(v[:, None], xy0[sl], 0.0), cap_total),
                response=_pad_axis0(resp[sl] * v, cap_total),
                angle=_pad_axis0(ang[sl] * v, cap_total),
                octave=_pad_axis0(octv[sl], cap_total),
                desc=_pad_axis0(desc[sl] * v[:, None].astype(jnp.uint32), cap_total),
                valid=_pad_axis0(v, cap_total),
            )
        )
    return out[0], out[1]
