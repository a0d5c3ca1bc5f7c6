"""A frozen copy of the port's ``voxelrt_torch/ops/accel.py``, taken when
the benchmark was defined, less what the plain reference does not call.

The acceleration structures of the traversal kernel, built on the host
(the PyTorch port's copy of voxelrt/ops/accel.py: host-side numpy, no JAX
import; the tables come out as numpy uint32 arrays and the renderer uploads
them).

v5 layout (rank-compressed; for grid_res = 128 — general powers of two up to
128 supported):

  * lod2_words    u32[res³/64/32]  one bit per 4³ cell, cell id z-major
                                   ((cz*R2 + cy)*R2 + cx, R2 = res/4)
  * solid_words   u32[same]        bit set when the cell's 64 voxels are ALL
                                   occupied — the kernel hits such a cell at
                                   its entry voxel with no mask fetch.
  * dist3_words   u32[res³/512/8]  4-bit chebyshev distance field over 8³
                                   cells (R3 = res/8): nibble = 0 when the
                                   cell contains any voxel, else the
                                   chebyshev distance (in 8³-cell units) to
                                   the nearest occupied cell, capped at 15.
                                   A value d ≥ 1 certifies the box of radius
                                   d-1 cells around the query cell empty, so
                                   the traversal kernel can skip straight to
                                   the box boundary — replacing the
                                   reference's LOD3..LOD6 pyramid walk
                                   (renderer/raytracer.py:9-15,110-118) with
                                   a single query per march step.
  * rank_base     u32[n lod2 words] number of MIXED (occupied, not solid)
                                   cells with id below each 32-cell word —
                                   rank(c) = rank_base[c>>5] +
                                   popcount(mixed_word & below-bits). Indexes
                                   the compressed mask tables.
  * mixed_lo/hi   u32[n_mixed]     64-bit voxel occupancy of each MIXED cell,
                                   rank order, local bit = (vz*4+vy)*4+vx.
                                   Real scenes have only a few thousand mixed
                                   cells (example6: 2697 of 32768), so a mask
                                   fetch is a short FULL static scan over
                                   ceil(n_mixed/128) vreg rows — no dynamic
                                   slices, no per-group reductions (the v4
                                   grouped-scan machinery measured ~65% of
                                   sorted-bounce kernel time, PERF_NOTES.md).
  * occ_morton    u32[n lod2 words] occupancy bits in MORTON cell-id order
                                   (bit i of word w = cell with morton code
                                   w*32+i occupied).
  * occ_rank_base u32[n lod2 words] prefix ranks over OCCUPIED cells in
                                   MORTON order — indexes the compressed
                                   color table.
  * cell_colors   u32[n_occ*64]    packed voxel words (r|g<<8|b<<16|mat<<24)
                                   of OCCUPIED cells only, MORTON-rank
                                   cell-major so a hit fetch is one lane
                                   read at occ_rank*64 + local (example6
                                   compresses 2 M voxel words → 403 K).
                                   Morton rank order keeps a 3-D-local hit
                                   set close together in the table.
  * palette mode  real scenes use few DISTINCT voxel words (example6: 771 —
                                   procedural palettes quantized to 8-bit
                                   channels). When a scene has ≤ 1024
                                   distinct words, cell_colors instead holds
                                   10-bit PALETTE INDICES packed 3 per word,
                                   22 words per cell (64 + 2 pad), and
                                   palette_words holds the ≤ 1024 distinct
                                   colors (exactly one (8,128) vreg slab).
                                   The hit fetch's slab scan walks a 2.9×
                                   smaller table (fewer distinct slabs per
                                   lock-step block) plus one fixed 8-round
                                   palette gather. palette_words is length 0
                                   when the scene exceeds 1024 distinct
                                   words (direct mode).

All tables are built host-side in numpy once per scene (the reference
rebuilds its texture + pyramid per prepare_data, renderer/voxel_world.py:89).
Table shapes depend on the scene's occupancy, so the traversal kernel
re-specializes per scene (one extra compile per scene, amortized over the
progressive render).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

DIST_CAP = 15  # 4-bit nibble maximum


class PallasTables(NamedTuple):
    lod2_words: np.ndarray  # u32 (n2w,) z-major cell bit order
    solid_words: np.ndarray  # u32 (n2w,) bit = cell fully occupied
    dist3_words: np.ndarray  # u32 (n3w,) packed 4-bit chebyshev distances
    rank_base: np.ndarray  # u32 (n2w,) mixed-cell prefix ranks
    occ_morton: np.ndarray  # u32 (n2w,) occupancy bits, morton cell order
    occ_rank_base: np.ndarray  # u32 (n2w,) occupied prefix ranks, morton
    mixed_lo: np.ndarray  # u32 (n_mixed padded,) rank order, bits 0-31
    mixed_hi: np.ndarray  # u32 (n_mixed padded,) rank order, bits 32-63
    cell_colors: np.ndarray  # u32 morton-rank cell-major: direct packed
    # words (64/cell) or, in palette mode, packed 10-bit indices (22/cell)
    palette_words: np.ndarray  # u32 (1024,) distinct colors, or (0,) direct
    sun_open_words: np.ndarray  # u32 (n2w,) bit = sun cone from this cell
    # provably escapes the voxel grid (see build_sun_open_bits); all-zero
    # until add_sun_open_table stamps a light direction
    grid_res: int


def _pack_bits(bits: np.ndarray) -> np.ndarray:
    bits = bits.astype(np.uint8).reshape(-1)
    pad = (-len(bits)) % 32
    if pad:
        bits = np.concatenate([bits, np.zeros(pad, np.uint8)])
    w = bits.reshape(-1, 32).astype(np.uint32)
    return (w << np.arange(32, dtype=np.uint32)).sum(
        axis=1, dtype=np.uint32
    )


def _pack_nibbles(vals: np.ndarray) -> np.ndarray:
    vals = vals.astype(np.uint32).reshape(-1)
    pad = (-len(vals)) % 8
    if pad:
        vals = np.concatenate([vals, np.full(pad, DIST_CAP, np.uint32)])
    w = vals.reshape(-1, 8)
    return (w << (4 * np.arange(8, dtype=np.uint32))).sum(
        axis=1, dtype=np.uint32
    )


def _pad_to(arr: np.ndarray, multiple: int) -> np.ndarray:
    n = max(len(arr), 1)  # at least one lane row even for empty tables
    pad = (-n) % multiple + (n - len(arr))
    if pad:
        arr = np.concatenate([arr, np.zeros(pad, arr.dtype)])
    return arr


def _part1by2(v: np.ndarray) -> np.ndarray:
    """Spread the low 10 bits of v 3 apart (Morton interleave helper)."""
    v = v.astype(np.uint32) & 0x3FF
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton3_np(x, y, z):
    return _part1by2(x) | (_part1by2(y) << 1) | (_part1by2(z) << 2)


def chebyshev_distance_field(occ: np.ndarray, cap: int = DIST_CAP) -> np.ndarray:
    """d[c] = 0 where occ, else chebyshev distance to nearest occupied cell,
    capped. Built by iterated 3³ dilation (the grid is at most 16³ cells)."""
    d = np.full(occ.shape, cap, np.uint8)
    cur = occ.astype(bool)
    d[cur] = 0
    for k in range(1, cap):
        if cur.all() or not cur.any():
            break
        p = np.pad(cur, 1, constant_values=False)
        dil = np.zeros_like(cur)
        for dz in range(3):
            for dy in range(3):
                for dx in range(3):
                    dil |= p[
                        dz : dz + occ.shape[0],
                        dy : dy + occ.shape[1],
                        dx : dx + occ.shape[2],
                    ]
        newly = dil & ~cur
        d[newly] = k
        cur = dil
    return d


def build_sun_open_bits(occupied_cells: np.ndarray, light_dir: np.ndarray,
                        cone_cos: float, max_steps: int = 96) -> np.ndarray:
    """Per-4³-cell SUN VISIBILITY certificate (TPU-native NEE accelerator;
    no reference counterpart — the reference traces every shadow ray,
    renderer/pathtracer.py:435-476).

    Returns bool (r2, r2, r2) [cz][cy][cx]: True certifies that a ray
    starting ANYWHERE in the cell, in ANY direction within the NEE sample
    cone (half-angle acos(cone_cos) around ``light_dir``), exits the voxel
    grid without touching an occupied voxel. The light direction is a
    per-scene constant (scene.set_directional_light), so the table is baked
    once and lets the traversal kernel retire most shadow rays the moment
    they stand in (or march into) a certified cell.

    Certificate: conservative chebyshev sphere-trace in cell units. At axis
    parameter s, every true cone point lies within chebyshev radius
    r(s) = 0.5 + k·s of the axis point (0.5 = origin anywhere in the cell,
    k = 2·sin(θ/2) = max direction deviation per unit s); a point in cell c
    is ≥ DT[c]−1 from the nearest occupied cell's box (DT = cell chebyshev
    distance transform), and a point m outside the grid boundary is ≥ m from
    every occupied cell. Advancing by δ = (F − r(s))/(1+k) keeps the whole
    segment certified (|axis step|_cheb ≤ δ, cone radius grows k·δ). A cell
    is open when the trace exits the grid along the dominant light axis with
    margin > r(s) (that margin then grows at |L_dom| ≥ 1/√3 > k per unit s,
    so it never closes again); it is NOT open when the margin dies or the
    step budget runs out — always conservative.
    """
    occ = occupied_cells.astype(bool)
    r2 = occ.shape[0]
    L = np.asarray(light_dir, np.float64)
    L = L / np.linalg.norm(L)
    k = math.sqrt(max(0.0, 2.0 * (1.0 - float(cone_cos))))
    if k >= 0.5:  # cone too wide for the dominant-axis escape argument
        return np.zeros(occ.shape, bool)
    dt = chebyshev_distance_field(occ, cap=r2 + 1).astype(np.float64)

    cz, cy, cx = np.indices(occ.shape, dtype=np.float64)
    # axis point in cell units, [z][y][x] arrays, vector components (x,y,z)
    q = np.stack([cx + 0.5, cy + 0.5, cz + 0.5], axis=0).reshape(3, -1)
    Lv = L.reshape(3, 1)
    s = np.zeros(q.shape[1])
    alive = ~occ.reshape(-1)  # only fully-empty cells can be certified
    open_ = np.zeros(q.shape[1], bool)
    dom = int(np.argmax(np.abs(L)))
    dom_sign = 1.0 if L[dom] >= 0 else -1.0
    eps = 1e-3
    for _ in range(max_steps):
        if not alive.any():
            break
        p = q + s * Lv
        r_s = 0.5 + k * s
        # clearance: inside → DT-1 at the containing cell; outside → margin
        # beyond the boundary (everything occupied is inside the grid)
        idx = np.clip(np.floor(p), 0, r2 - 1).astype(np.int64)
        f_in = dt[idx[2], idx[1], idx[0]] - 1.0
        m_out = np.maximum(np.maximum.reduce(-p), np.maximum.reduce(p - r2))
        inside = m_out < 0
        f = np.where(inside, f_in, np.maximum(m_out, 0.0))
        # escaped: out along the dominant axis with margin beyond the cone
        out_dom = dom_sign * p[dom] - (r2 if dom_sign > 0 else 0.0)
        esc = alive & (out_dom > r_s + eps)
        open_ |= esc
        alive &= ~esc
        margin = f - r_s - eps
        blocked = alive & (margin <= 0.05)
        alive &= ~blocked
        s = np.where(alive, s + margin / (1.0 + k), s)
    return open_.reshape(occ.shape)


def add_sun_open_table(tables: PallasTables, material_xyz: np.ndarray,
                       light_dir, cone_cos: float) -> PallasTables:
    """Stamp a light direction's sun-open certificate into the tables."""
    res = tables.grid_res
    r2 = res // 4
    occ = (material_xyz != 0).transpose(2, 1, 0)
    occ_cells = (
        occ.reshape(r2, 4, r2, 4, r2, 4)
        .transpose(0, 2, 4, 1, 3, 5)
        .reshape(r2, r2, r2, 64)
        .any(axis=-1)
    )
    bits = build_sun_open_bits(occ_cells, light_dir, cone_cos)
    words = _pad_to(_pack_bits(bits.reshape(-1)), 128)
    return tables._replace(sun_open_words=words)


def build_pallas_tables(material_xyz: np.ndarray, color_words_zyx: np.ndarray,
                        grid_res: int) -> PallasTables:
    """material_xyz: int8 [x][y][z]; color_words_zyx: u32 flat z-major
    ((z*res + y)*res + x) packed voxel words (world.device_arrays)."""
    res = grid_res
    r2 = res // 4
    occ = (material_xyz != 0).transpose(2, 1, 0)  # [z][y][x]

    # cells z-major: [cz, cy, cx, 64 local bits]
    cells = (
        occ.reshape(r2, 4, r2, 4, r2, 4)
        .transpose(0, 2, 4, 1, 3, 5)
        .reshape(r2 * r2 * r2, 64)
    )
    colors = (
        color_words_zyx.reshape(r2, 4, r2, 4, r2, 4)
        .transpose(0, 2, 4, 1, 3, 5)
        .reshape(r2 * r2 * r2, 64)
    )
    occupied = cells.any(axis=1)
    solid = cells.all(axis=1)
    mixed = occupied & ~solid
    lod2 = _pack_bits(occupied)  # z-major bit order (march query)
    solid_w = _pack_bits(solid)

    # Prefix ranks per 32-cell word (exclusive cumulative counts).
    n_words = len(lod2)

    def prefix_ranks(flags: np.ndarray) -> np.ndarray:
        per_word = _pad_to(flags.astype(np.uint32), 32).reshape(-1, 32)
        return np.concatenate(
            [[0], np.cumsum(per_word.sum(axis=1))[:-1]]
        ).astype(np.uint32)[:n_words]

    rank_base = prefix_ranks(mixed)

    # Compressed mask table: MIXED cells only, rank (= z-major id) order.
    mixed_words = _pack_bits(cells[mixed]).reshape(-1, 2) if mixed.any() else \
        np.zeros((0, 2), np.uint32)
    mixed_lo = mixed_words[:, 0].copy() if len(mixed_words) else \
        np.zeros(0, np.uint32)
    mixed_hi = mixed_words[:, 1].copy() if len(mixed_words) else \
        np.zeros(0, np.uint32)

    # Compressed color table: OCCUPIED cells in MORTON rank order (morton
    # code is a bijection on the power-of-two cube, so scatter by code).
    cz_, cy_, cx_ = np.indices((r2, r2, r2), dtype=np.uint32)
    code = morton3_np(cx_, cy_, cz_).reshape(-1)  # z-major id -> morton code
    occ_m = np.zeros_like(occupied)
    occ_m[code] = occupied
    colors_m = np.zeros_like(colors)
    colors_m[code] = colors
    occ_morton = _pack_bits(occ_m)
    occ_rank_base = prefix_ranks(occ_m)
    colors_occ = colors_m[occ_m].reshape(-1)

    # Palette compression of the color table (see module docstring): most
    # scenes quantize to few distinct packed words, so store 10-bit indices
    # (3 per u32, 22 words/cell) + a one-slab palette instead of raw words.
    palette, inv = np.unique(colors_occ, return_inverse=True) if \
        len(colors_occ) else (np.zeros(1, np.uint32), np.zeros(0, np.int64))
    if len(palette) <= 1024:
        idx = inv.astype(np.uint32).reshape(-1, 64)
        idx = np.concatenate(
            [idx, np.zeros((len(idx), 2), np.uint32)], axis=1
        ).reshape(-1, 22, 3)
        cell_color_tbl = (
            idx[..., 0] | (idx[..., 1] << 10) | (idx[..., 2] << 20)
        ).reshape(-1).astype(np.uint32)
        palette_words = np.zeros(1024, np.uint32)
        palette_words[: len(palette)] = palette
    else:
        cell_color_tbl = colors_occ
        palette_words = np.zeros(0, np.uint32)

    r3 = res // 8
    occ3 = (
        occ.reshape(r3, 8, r3, 8, r3, 8)
        .transpose(0, 2, 4, 1, 3, 5)
        .reshape(r3, r3, r3, 512)
        .any(axis=-1)
    )
    dist3 = _pack_nibbles(chebyshev_distance_field(occ3))

    return PallasTables(
        lod2_words=_pad_to(lod2, 128),
        solid_words=_pad_to(solid_w, 128),
        dist3_words=_pad_to(dist3, 128),
        rank_base=_pad_to(rank_base, 128),
        occ_morton=_pad_to(occ_morton, 128),
        occ_rank_base=_pad_to(occ_rank_base, 128),
        mixed_lo=_pad_to(mixed_lo, 128),
        mixed_hi=_pad_to(mixed_hi, 128),
        cell_colors=_pad_to(cell_color_tbl, 1024),
        palette_words=palette_words,
        sun_open_words=np.zeros(len(_pad_to(lod2, 128)), np.uint32),
        grid_res=res,
    )
