"""Closest-hit voxel traversal with in-kernel sun-cone NEE: kernel B1, the
PyTorch/CUDA port of voxelrt/ops/dda_pallas.py (``raytrace_pallas``).

Same per-ray semantics as the JAX kernel (renderer/raytracer.py:72-155 and
its TPU redesign): the AABB clip, the distance-field / free-X-slab march,
the rank-compressed mask fetch with a whole-cell in-register DDA, the face
normal flipped toward the ray, the hit colour word (direct or palette
mode), and in NEE mode the retired primary's sun-cone shadow ray. The TPU
kernel's lock-step blocks, ray queues, refill rounds, march unroll and
fetch deferral only schedule that per-ray sequence (the JAX package tests
the queued and plain forms bitwise equal), so both versions here run it per
ray: the CUDA kernel (csrc/dda.cu) over a device-built list of the alive
rays, one thread per ray, with the NEE shadow rays gathered into a second
list and traced in a second launch; the plain twin below as a masked loop
over the still-active rays.

One departure from the JAX kernel, in both versions: where a ray's position
has rounded past a cell face that its cell index has not crossed, the exit
through that face lies behind the ray; the JAX kernel then steps no axis and
the ray stalls in place until its advance budget runs out (it comes back as
a hit with a zero normal and colour 0 at its last position, which the
renderer shades into NaN). Here such an axis steps too (``<=`` where the
JAX kernel tests ``==``); where every exit lies ahead the two agree.

The sun-open certificate (``DeviceTables.sun_open_words``, one bit per 4^3
cell: the whole sun cone escapes the grid from anywhere in the cell) retires
shadow rays early, with the JAX kernel's verdicts:

* at every advance, before the occupancy test, a live in-bounds ray standing
  in a certified cell retires as a miss: every ray with ``use_sun_open``
  (the explicit sun-shadow dispatch), the NEE shadow rays unless
  ``sun_mode='off'``;
* at conversion, with ``nee_src_open``, an NEE shadow ray whose AABB clip
  misses the grid or whose entry cell is certified is 'visible' without a
  march.

Shadow mode (``any_hit=True, fetch_colors=False``, the explicit sun-shadow
dispatch of ``nee_in_kernel=False``) runs the same march and in-cell DDA
without normal tracking or the colour fetch and returns the distance only:
finite on the first occupied voxel of the ray's path (or when the advance
budget runs out), inf otherwise.

``raytrace`` sends CPU tensors to the twin and launches the kernel on CUDA
tensors. There is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from voxelrt_torch.ops import _cuda
from voxelrt_torch.ops.v3 import V3
from voxelrt_torch.utils import profiling

BIG = 3.0e38
EPS = 1e-6
RESOLVE_STEPS = 9
M32 = 0xFFFFFFFF


class DeviceTables(NamedTuple):
    """ops.accel.PallasTables uploaded as int32 tensors (u32 bit patterns)."""

    lod2_words: torch.Tensor
    solid_words: torch.Tensor
    dist3_words: torch.Tensor
    rank_base: torch.Tensor
    occ_morton: torch.Tensor
    occ_rank_base: torch.Tensor
    mixed_lo: torch.Tensor
    mixed_hi: torch.Tensor
    cell_colors: torch.Tensor
    palette_words: torch.Tensor  # (0,) in direct mode
    sun_open_words: torch.Tensor  # sun-open bit per 4^3 cell (LOD2 layout)
    grid_res: int


def upload_tables(tables, device) -> DeviceTables:
    """Host PallasTables (numpy u32) -> DeviceTables on ``device``."""
    def up(a):
        return torch.from_numpy(a.astype("uint32").view("int32").copy()).to(
            device)

    return DeviceTables(
        up(tables.lod2_words), up(tables.solid_words), up(tables.dist3_words),
        up(tables.rank_base), up(tables.occ_morton), up(tables.occ_rank_base),
        up(tables.mixed_lo), up(tables.mixed_hi), up(tables.cell_colors),
        up(tables.palette_words), up(tables.sun_open_words),
        int(tables.grid_res))


class PallasTraceResult(NamedTuple):
    """In shadow mode only ``distance`` is filled; the rest is None."""

    distance: torch.Tensor  # f32, inf = miss
    ipos: V3  # int32 components
    normal: V3  # f32 components
    iters: torch.Tensor  # int32 advance count
    color_word: torch.Tensor  # int32 bits of r|g<<8|b<<16|mat<<24 (0 unless hit)
    active: torch.Tensor  # int32: 1 = unfinished (advance budget hit)
    nee_visible: torch.Tensor | None = None  # int32 in-kernel NEE verdict
    # int32 (3,) on the rays' device: alive rays traced, NEE shadow rays
    # marched, NEE shadow rays settled at conversion (``nee_src_open``)
    counts: torch.Tensor | None = None


# the counter names of ``counts``' three entries
B1_COUNTS = ("b1.alive", "b1.nee_listed", "b1.nee_settled")


# --- plain twin ---------------------------------------------------------------


def _popcount(v):
    """Popcount of int64 tensors holding u32 values."""
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & M32) >> 24


def _as_i32(v):
    """int64 u32 bit pattern -> the signed int32 value (still int64)."""
    v = v & M32
    return v - ((v >> 31) << 32)


def _pack_word(px, py, pz, nx, ny, nz):
    w = ((px + 1) | ((py + 1) << 8) | ((pz + 1) << 16)
         | ((nx.to(torch.int64) + 1) << 24) | ((ny.to(torch.int64) + 1) << 26)
         | ((nz.to(torch.int64) + 1) << 28))
    return _as_i32(w)


def _unpack_word(w):
    return ((w & 255) - 1, ((w >> 8) & 255) - 1, ((w >> 16) & 255) - 1,
            (((w >> 24) & 3) - 1).to(torch.float32),
            (((w >> 26) & 3) - 1).to(torch.float32),
            (((w >> 28) & 3) - 1).to(torch.float32))


def _sel(m, a, b):
    return torch.where(m, a, b)


def _init_rays(res, o, d, tmin, tmax, any_hit=False):
    """Ray/AABB clip + entry state (dda_pallas.py init_rays); ``any_hit``
    starts with a zero normal, as the shadow mode tracks none."""
    ox, oy, oz = o
    dx, dy, dz = d
    fres = float(res)
    inv = [1.0 / torch.clamp(torch.abs(c), min=1e-20) for c in d]
    sgn = [torch.sign(c) for c in d]

    def slab(o_, d_, inv_, s_):
        w = _sel(d_ == 0.0, 0.0, inv_)
        sg = _sel(s_ < 0, -1.0, 1.0)
        a = (0.0 - o_) * w * sg
        b = (fres - o_) * w * sg
        deg = d_ == 0.0
        lo = _sel(deg, -BIG, torch.minimum(a, b))
        hi = _sel(deg, BIG, torch.maximum(a, b))
        return lo, hi, deg & ((o_ < 0.0) | (o_ > fres))

    lx, hx, xo = slab(ox, dx, inv[0], sgn[0])
    ly, hy, yo = slab(oy, dy, inv[1], sgn[1])
    lz, hz, zo = slab(oz, dz, inv[2], sgn[2])
    near = torch.maximum(torch.maximum(lx, ly), lz)
    far_box = torch.minimum(torch.minimum(hx, hy), hz)
    alive = ((near <= far_box) & ~(xo | yo | zo) & (tmin < far_box)
             & (tmax > near))
    t0 = torch.maximum(near, tmin)
    te = t0 + EPS
    q = [oc + dc * te for oc, dc in zip(o, d)]
    p0 = [torch.clamp(torch.floor(qc), 0.0, fres - 1.0) for qc in q]
    far = torch.minimum(tmax, far_box) - EPS
    idist = [torch.abs(qc - fres * 0.5) for qc in q]
    mx = torch.maximum(torch.maximum(idist[0], idist[1]), idist[2])
    n0 = [_sel(alive, (ic == mx).to(torch.float32), 0.0) for ic in idist]
    if any_hit:
        n0 = [torch.zeros_like(c) for c in n0]
    ip = [_sel(alive, pc.to(torch.int64), -1) for pc in p0]
    ray = dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz, ivx=inv[0],
               ivy=inv[1], ivz=inv[2], sx=sgn[0], sy=sgn[1], sz=sgn[2],
               far=far)
    z = torch.zeros_like(ip[0])
    st = dict(t=_sel(alive, t0, BIG), word=_pack_word(*ip, *n0), adv=z,
              active=alive, hit=torch.zeros_like(alive),
              exh=torch.zeros_like(alive))
    return ray, st


def _box_exit(r, t, lo, ext):
    f = [(r[o] + r[dd] * t) - l_ for o, dd, l_ in
         zip(("ox", "oy", "oz"), ("dx", "dy", "dz"), lo)]
    tt = []
    for fc, e, dd, iv in zip(f, ext, ("dx", "dy", "dz"),
                             ("ivx", "ivy", "ivz")):
        dist = _sel(r[dd] > 0.0, e - fc, fc)
        tt.append(_sel(r[dd] == 0.0, BIG, dist * r[iv]))
    mint = torch.clamp(torch.minimum(torch.minimum(tt[0], tt[1]), tt[2]),
                       min=0.0)
    return f, tt, mint


def _resolve(T, r, s, px, py, pz, nx, ny, nz, w2, cw, cb):
    """Fetch + whole-cell in-register DDA (dda_pallas.py fetch_and_resolve)
    for rays standing at an occupied 4^3 cell."""
    ws = T["solid"][cw]
    base = T["rankb"][cw]
    solid = ((ws >> cb) & 1) != 0
    below = ((w2 & ~ws) & M32) & ((1 << cb) - 1)
    rank = torch.clamp(base + _popcount(below), max=T["mlo"].shape[0] - 1)
    mlo = _sel(solid, -1, T["mlo"][rank])
    mhi = _sel(solid, -1, T["mhi"][rank])
    rt = s["t"]
    far = r["far"]
    cb3 = [px & ~3, py & ~3, pz & ~3]
    f0 = [(r[o] + r[dd] * rt) - pc.to(torch.float32) for o, dd, pc in
          zip(("ox", "oy", "oz"), ("dx", "dy", "dz"), (px, py, pz))]
    tm = [_sel(r[dd] == 0.0, BIG, rt + _sel(r[dd] > 0.0, 1.0 - fc, fc) * r[iv])
          for fc, dd, iv in zip(f0, ("dx", "dy", "dz"), ("ivx", "ivy", "ivz"))]
    p = [px, py, pz]
    nrm = [nx, ny, nz]
    moving = torch.ones_like(solid)
    rhit = torch.zeros_like(solid)
    steps = torch.zeros_like(px)
    for k in range(RESOLVE_STEPS + 1):
        local = ((p[2] & 3) * 4 + (p[1] & 3)) * 4 + (p[0] & 3)
        mword = _sel(local < 32, mlo, mhi)
        occ0 = ((mword >> (local & 31)) & 1) != 0
        in_far = rt <= far
        hit_now = moving & occ0 & in_far
        rhit = rhit | hit_now
        moving = moving & ~hit_now & in_far
        if k == RESOLVE_STEPS:
            break
        mint_abs = torch.maximum(
            torch.minimum(torch.minimum(tm[0], tm[1]), tm[2]), rt)
        axes = [tc <= mint_abs for tc in tm]
        an = [a.to(torch.float32) * r[sg] for a, sg in
              zip(axes, ("sx", "sy", "sz"))]
        rt = _sel(moving, mint_abs, rt)
        tm = [_sel(moving & a, tc + r[iv], tc) for a, tc, iv in
              zip(axes, tm, ("ivx", "ivy", "ivz"))]
        p = [_sel(moving, pc + ac.to(torch.int64), pc) for pc, ac in zip(p, an)]
        nrm = [_sel(moving, ac, nc) for ac, nc in zip(an, nrm)]
        steps = steps + moving.to(torch.int64)
        exited = ((p[0] & ~3) != cb3[0]) | ((p[1] & ~3) != cb3[1]) | (
            (p[2] & ~3) != cb3[2])
        moving = moving & ~exited
    return rt, p, nrm, rhit, steps


def _march(T, r, s, px, py, pz, w2):
    """Empty-space advance (dda_pallas.py march_candidates)."""
    res = T["res"]
    r3 = res >> 3
    fres = float(res)
    c3 = [px >> 3, py >> 3, pz >> 3]
    c3i = (c3[2] * r3 + c3[1]) * r3 + c3[0]
    w3 = T["dist3"][c3i >> 3]
    d3 = (w3 >> ((c3i & 7) * 4)) & 15
    skip = d3 >= 1
    rad = d3 - 1
    loA = [_sel(skip, (cc - rad) * 8, pc & ~3).to(torch.float32)
           for cc, pc in zip(c3, (px, py, pz))]
    extA = _sel(skip, (2 * rad + 1) * 8, 4).to(torch.float32)
    fA, tA, mintA = _box_exit(r, s["t"], loA, (extA, extA, extA))
    loB = [torch.zeros_like(loA[0]), (py & ~3).to(torch.float32),
           (pz & ~3).to(torch.float32)]
    four = torch.full_like(extA, 4.0)
    fB, tB, mintB = _box_exit(r, s["t"], loB,
                              (torch.full_like(extA, fres), four, four))
    useB = (w2 == 0) & (mintB > mintA)
    lo = [_sel(useB, b, a) for a, b in zip(loA, loB)]
    ext = [_sel(useB, b, extA) for b in (torch.full_like(extA, fres), four,
                                         four)]
    f = [_sel(useB, b, a) for a, b in zip(fA, fB)]
    tt = [_sel(useB, b, a) for a, b in zip(tA, tB)]
    mint = _sel(useB, mintB, mintA)
    e = [torch.clamp(torch.floor(fc + mint * r[dd]), min=0.0)
         for fc, dd in zip(f, ("dx", "dy", "dz"))]
    e = [torch.minimum(ec, xc - 1.0) for ec, xc in zip(e, ext)]
    # <= and not ==: an exit behind the ray (mint clamped to 0) steps too,
    # else a ray whose position rounded past a face its cell index has not
    # crossed stalls (csrc/dda.cu, march step)
    an = [(tc <= mint).to(torch.float32) * r[sg] for tc, sg in
          zip(tt, ("sx", "sy", "sz"))]
    nap = [((lc + ec) + ac).to(torch.int64) for lc, ec, ac in zip(lo, e, an)]
    return s["t"] + mint, nap, an


def _step(T, r, s, max_advances, sun):
    """One advance of every ray in ``s``; ``sun``: retire live rays that
    stand in a sun-open cell as misses first (dda_pallas.py:482-496)."""
    res = T["res"]
    r2 = res >> 2
    px, py, pz, nx, ny, nz = _unpack_word(s["word"])
    inb = ((px >= 0) & (px < res) & (py >= 0) & (py < res) & (pz >= 0)
           & (pz < res))
    # t at BIG: a zero direction, which crosses no face; a miss, not a
    # spin to the advance cap (csrc/dda.cu, step)
    live = ~(s["t"] > r["far"]) & (s["t"] < BIG) & inb
    if sun:
        li = torch.nonzero(live).squeeze(1)
        cell = ((pz[li] >> 2) * r2 + (py[li] >> 2)) * r2 + (px[li] >> 2)
        esc = ((T["sun"][cell >> 5] >> (cell & 31)) & 1) != 0
        live[li[esc]] = False
    out = dict(s)
    out["t"] = _sel(live, s["t"], BIG)
    out["active"] = live.clone()
    li = torch.nonzero(live).squeeze(1)
    if li.numel() == 0:
        return out
    sub = {k: v[li] for k, v in r.items()}
    ss = {k: v[li] for k, v in s.items()}
    lpx, lpy, lpz, lnx, lny, lnz = px[li], py[li], pz[li], nx[li], ny[li], \
        nz[li]
    cell = ((lpz >> 2) * r2 + (lpy >> 2)) * r2 + (lpx >> 2)
    cw = cell >> 5
    cb = cell & 31
    w2 = T["lod2"][cw]
    occ2 = ((w2 >> cb) & 1) != 0

    o_t = ss["t"].clone()
    o_p = [lpx.clone(), lpy.clone(), lpz.clone()]
    o_n = [lnx.clone(), lny.clone(), lnz.clone()]
    hit1 = torch.zeros_like(occ2)
    steps = torch.zeros_like(lpx)

    ai = torch.nonzero(occ2).squeeze(1)
    if ai.numel():
        ra = {k: v[ai] for k, v in sub.items()}
        sa = {k: v[ai] for k, v in ss.items()}
        rt, p, nrm, rhit, st_ = _resolve(
            T, ra, sa, lpx[ai], lpy[ai], lpz[ai], lnx[ai], lny[ai], lnz[ai],
            w2[ai], cw[ai], cb[ai])
        o_t[ai] = rt
        for c in range(3):
            o_p[c][ai] = p[c]
            o_n[c][ai] = nrm[c]
        hit1[ai] = rhit
        steps[ai] = st_
    mi = torch.nonzero(~occ2).squeeze(1)
    if mi.numel():
        rm = {k: v[mi] for k, v in sub.items()}
        sm = {k: v[mi] for k, v in ss.items()}
        nat, nap, an = _march(T, rm, sm, lpx[mi], lpy[mi], lpz[mi], w2[mi])
        o_t[mi] = nat
        for c in range(3):
            o_p[c][mi] = nap[c]
            o_n[c][mi] = an[c]
    if T.get("any_hit"):
        o_n = [torch.zeros_like(c) for c in o_n]
    o_adv = ss["adv"] + (~occ2).to(torch.int64) + steps
    exhausted = o_adv >= max_advances
    out["t"][li] = o_t
    out["word"][li] = _pack_word(*o_p, *o_n)
    out["adv"][li] = o_adv
    out["hit"][li] = ss["hit"] | hit1
    out["exh"][li] = ss["exh"] | (exhausted & ~hit1)
    out["active"][li] = ~hit1 & ~exhausted
    return out


def _run(T, ray, st, max_advances, sun=False):
    """Step every still-active ray until all retire; returns the final
    state (``st`` is left as it is)."""
    st = {k: v.clone() for k, v in st.items()}
    idx = torch.nonzero(st["active"]).squeeze(1)
    while idx.numel():
        r = {k: v[idx] for k, v in ray.items()}
        s = {k: v[idx] for k, v in st.items()}
        s = _step(T, r, s, max_advances, sun)
        for k in st:
            st[k][idx] = s[k]
        idx = idx[s["active"]]
    return st


def _hit_color(T, px, py, pz, hit):
    def part1by2(v):
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    out = torch.zeros_like(px)
    hi = torch.nonzero(hit).squeeze(1)
    if hi.numel() == 0:
        return out
    x, y, z = px[hi], py[hi], pz[hi]
    mcell = part1by2(x >> 2) | (part1by2(y >> 2) << 1) | (part1by2(z >> 2) << 2)
    mw = mcell >> 5
    mb = mcell & 31
    wm = T["occm"][mw] & M32
    occ_rank = T["occb"][mw] + _popcount(wm & ((1 << mb) - 1))
    local = ((z & 3) * 4 + (y & 3)) * 4 + (x & 3)
    if T["palette"].shape[0]:
        q = (local * 171) >> 9
        col = T["colors"][occ_rank * 22 + q]
        slot = local - 3 * q
        out[hi] = T["palette"][(col >> (10 * slot)) & 1023]
    else:
        out[hi] = T["colors"][occ_rank * 64 + local]
    return out


SUN_MODES = ("all", "half", "off")


def _check_mode(any_hit, fetch_colors, nee, use_sun_open, sun_mode):
    if any_hit != (not fetch_colors):
        raise ValueError("B1 has two modes: closest hit with the colour fetch "
                         "(any_hit=False, fetch_colors=True) and shadow "
                         "(any_hit=True, fetch_colors=False)")
    if any_hit and nee is not None:
        raise ValueError("in-kernel NEE requires the closest-hit mode")
    if use_sun_open and nee is not None:
        raise ValueError("in-kernel NEE reads the sun-open table by sun_mode; "
                         "use_sun_open is for shadow-ray dispatches")
    if sun_mode not in SUN_MODES:
        raise ValueError(f"sun_mode must be one of {SUN_MODES}")


def _table_dict(tables: DeviceTables, any_hit):
    T = dict(lod2=tables.lod2_words, solid=tables.solid_words,
             dist3=tables.dist3_words, rankb=tables.rank_base,
             occm=tables.occ_morton, occb=tables.occ_rank_base,
             mlo=tables.mixed_lo, mhi=tables.mixed_hi,
             colors=tables.cell_colors, palette=tables.palette_words,
             sun=tables.sun_open_words)
    T = {k: v.to(torch.int64) for k, v in T.items()}
    T["res"] = tables.grid_res
    T["any_hit"] = any_hit
    return T


def _trace_primaries(tables, origin, direction, tmin, tmax, max_advances,
                     alive, any_hit, use_sun_open):
    """The primaries' march: returns (T, ray, final state). The state's
    ``adv`` holds each ray's advance count, which shadow mode does not
    return."""
    n = origin.x.shape[0]
    dev = origin.x.device
    T = _table_dict(tables, any_hit)
    tmin = torch.as_tensor(tmin, dtype=torch.float32, device=dev).expand(n)
    tmax = torch.as_tensor(tmax, dtype=torch.float32, device=dev).expand(n)
    ray, st = _init_rays(tables.grid_res, tuple(origin), tuple(direction),
                         tmin, tmax, any_hit)
    if alive is not None:
        st["active"] = st["active"] & (alive != 0)
    return T, ray, _run(T, ray, st, max_advances, use_sun_open)


def raytrace_plain(tables: DeviceTables, origin: V3, direction: V3, tmin,
                   tmax, max_advances: int = 512, nee=None, alive=None,
                   any_hit=False, fetch_colors=True, use_sun_open=False,
                   sun_mode="half", nee_src_open=False) -> PallasTraceResult:
    """Plain PyTorch twin of B1 (see ``raytrace`` for the arguments)."""
    _check_mode(any_hit, fetch_colors, nee, use_sun_open, sun_mode)
    n = origin.x.shape[0]
    dev = origin.x.device
    T, ray, st = _trace_primaries(tables, origin, direction, tmin, tmax,
                                  max_advances, alive, any_hit, use_sun_open)
    n_alive = n if alive is None else int((alive != 0).sum())
    counts = [n_alive, 0, 0]
    if any_hit:
        dist = _sel(st["t"] >= BIG, float("inf"), st["t"])
        if alive is not None:
            dist = _sel(alive == 0, float("inf"), dist)
        return PallasTraceResult(dist, None, None, None, None, None,
                                 counts=_counts(counts, dev))
    px, py, pz, hnx, hny, hnz = _unpack_word(st["word"])
    flip = ((direction.x * hnx + direction.y * hny) + direction.z * hnz) > 0.0
    nrm = [_sel(flip, -c, c) for c in (hnx, hny, hnz)]
    dist = _sel(st["t"] >= BIG, float("inf"), st["t"])
    color = _hit_color(T, px, py, pz, st["hit"])
    iters = st["adv"]
    act = (st["active"] | st["exh"]).to(torch.int32)
    vis = None
    if nee is not None:
        vis, counts[1], counts[2] = _nee_plain(
            T, ray, st, nrm, nee, max_advances, alive, sun_mode != "off",
            nee_src_open)
    if alive is not None:
        dead = alive == 0
        dist = _sel(dead, float("inf"), dist)
        px, py, pz = (_sel(dead, -1, c) for c in (px, py, pz))
        nrm = [_sel(dead, 0.0, c) for c in nrm]
        iters = _sel(dead, 0, iters)
        color = _sel(dead, 0, color)
        act = _sel(dead, 0, act)
        if vis is not None:
            vis = _sel(dead, 0, vis)
    return PallasTraceResult(
        distance=dist,
        ipos=V3(px.to(torch.int32), py.to(torch.int32), pz.to(torch.int32)),
        normal=V3(*nrm),
        iters=iters.to(torch.int32),
        color_word=color.to(torch.int32),
        active=act,
        nee_visible=vis,
        counts=_counts(counts, dev),
    )


def _counts(counts, dev):
    return torch.tensor(counts, dtype=torch.int32).to(dev)


def _nee_plain(T, ray, st, nrm, nee, max_advances, alive, sun, src_open):
    """The retired primaries' sun-cone shadow rays (dda_pallas.py
    nee_conv_data) and their visibility verdicts; ``sun``: the per-advance
    sun-open early-out, ``src_open``: the conversion-time one
    (dda_pallas.py nee_instant). Returns (verdicts, rays marched, rays
    settled at conversion)."""
    scal = nee["scalars"]
    L, X, Y = scal[0:3], scal[3:6], scal[6:9]
    cone_cos, epsg, shadow_tmin = scal[9], scal[10], scal[11]
    t = st["t"]
    alt = nee["alt_t"]
    have_vox = st["hit"] & (t < BIG)
    use_alt = torch.isfinite(alt) & (alt < _sel(have_vox, t, BIG))
    surf = have_vox | use_alt
    if alive is not None:
        surf = surf & (alive != 0)
    fny = _sel(ray["dy"] > 0.0, -1.0, 1.0)
    sn = [_sel(use_alt, 0.0, nrm[0]), _sel(use_alt, fny, nrm[1]),
          _sel(use_alt, 0.0, nrm[2])]
    stt = _sel(use_alt, alt, t)
    sp = [(ray[o] + ray[dd] * stt) + sc * epsg for o, dd, sc in
          zip(("ox", "oy", "oz"), ("dx", "dy", "dz"), sn)]
    uu1, uu2 = nee["u0"], nee["u1"]
    cos_t = (1.0 - uu1) + uu1 * cone_cos
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    phi = 6.2831854820251465 * uu2
    cphi = torch.cos(phi) * sin_t
    sphi = torch.sin(phi) * sin_t
    ld = [(cphi * X[c] + sphi * Y[c]) + cos_t * L[c] for c in range(3)]
    ndl = (ld[0] * sn[0] + ld[1] * sn[1]) + ld[2] * sn[2]
    conv = surf & (ndl > -1e-3)
    vis = torch.zeros_like(t, dtype=torch.int32)
    ci = torch.nonzero(conv).squeeze(1)
    if ci.numel() == 0:
        return vis, 0, 0
    n = ci.numel()
    dev = t.device
    sray, sst = _init_rays(
        T["res"], tuple(c[ci] for c in sp), tuple(c[ci] for c in ld),
        shadow_tmin.expand(n), torch.full((n,), BIG, dtype=torch.float32,
                                          device=dev))
    settled = torch.zeros(n, dtype=torch.bool, device=dev)
    if src_open:
        # the AABB clip misses the grid, or the entry cell is sun-open
        r2 = T["res"] >> 2
        px, py, pz = _unpack_word(sst["word"])[:3]
        cell = ((pz >> 2) * r2 + (py >> 2)) * r2 + (px >> 2)
        cell = _sel(sst["active"], cell, 0)
        open_ = ((T["sun"][cell >> 5] >> (cell & 31)) & 1) != 0
        settled = ~sst["active"] | open_
        sst["active"] = sst["active"] & ~settled
    sst = _run(T, sray, sst, max_advances, sun)
    vis[ci] = (settled | (~sst["hit"] & ~sst["exh"])).to(torch.int32)
    n_settled = int(settled.sum())
    return vis, n - n_settled, n_settled


# --- wrapper ------------------------------------------------------------------


def nee_scalars(light_dir, tangent, bitangent, cone_cos, eps_grid,
                shadow_tmin, device):
    """The in-kernel NEE's launch scalars [L, X, Y, cone_cos, eps_grid,
    shadow_tmin] as one float32 tensor of 12 (the ``scalars`` of
    :func:`nee_params`). A Python number becomes a device fill, not a
    host-to-device copy."""
    def one(c):
        if isinstance(c, torch.Tensor):
            return c.to(device=device, dtype=torch.float32).reshape(())
        return torch.full((), float(c), dtype=torch.float32, device=device)

    vals = [one(c) for v in (light_dir, tangent, bitangent) for c in v]
    vals += [one(v) for v in (cone_cos, eps_grid, shadow_tmin)]
    return torch.stack(vals)


def nee_params(u, alt_t, light_dir, tangent, bitangent, cone_cos, eps_grid,
               shadow_tmin, device):
    """Pack the in-kernel NEE inputs: per-ray cone uniforms ``u`` = (u0, u1)
    and floor crossing ``alt_t`` (grid units, inf = none), plus the launch
    scalars of :func:`nee_scalars` (dda_pallas.py raytrace_pallas
    ``nee=``)."""
    return dict(u0=u[0], u1=u[1], alt_t=alt_t, scalars=nee_scalars(
        light_dir, tangent, bitangent, cone_cos, eps_grid, shadow_tmin,
        device))


def raytrace(tables: DeviceTables, origin: V3, direction: V3, tmin, tmax,
             max_advances: int = 512, nee=None, alive=None, any_hit=False,
             fetch_colors=True, use_sun_open=False, sun_mode="half",
             nee_src_open=False) -> PallasTraceResult:
    """Trace rays in grid space [0, res)^3 (B1).

    origin/direction: V3 of (N,) f32; tmin: a float, the same for every ray;
    tmax: a float or (N,) f32. ``nee`` (from :func:`nee_params`) turns on
    in-kernel NEE and fills ``nee_visible``. ``alive``: optional (N,)
    bool/int mask; dead rays return the canonical miss (distance inf, ipos
    -1, normal 0, iters 0, color 0, active 0, nee_visible 0).
    ``any_hit=True, fetch_colors=False`` is the shadow mode: only
    ``distance`` comes back (inf for a dead ray).

    The sun-open early-outs (the JAX kernel's, with its verdicts):
    ``use_sun_open`` retires every ray standing in a sun-open cell as a miss
    (shadow rays inside the sun cone only); ``sun_mode`` does the same for
    the NEE shadow rays unless it is 'off' ('all' and 'half' both check
    every advance here); ``nee_src_open`` settles an NEE shadow ray whose
    clip misses the grid or whose entry cell is sun-open as visible at
    conversion. CPU tensors run the plain twin; CUDA tensors launch the
    kernel, with no host synchronisation: ``counts`` stays on the card.

    The dispatch is the span ``kernels.b1``; its counters are ``b1.rays``
    (the rays handed to it) and B1's own ``counts``: ``b1.alive``,
    ``b1.nee_listed`` and ``b1.nee_settled``, kept on the card."""
    dev = origin.x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    with profiling.span("kernels.b1"):
        trace = raytrace_plain if dev.type == "cpu" else _raytrace_cuda
        tr = trace(tables, origin, direction, tmin, tmax, max_advances, nee,
                   alive, any_hit, fetch_colors, use_sun_open, sun_mode,
                   nee_src_open)
        if profiling.recording():
            profiling.count("b1.rays", origin.x.shape[0], any_hit=any_hit)
            for i, name in enumerate(B1_COUNTS):
                profiling.count(name, tr.counts[i], any_hit=any_hit)
    return tr


def _raytrace_cuda(tables, origin, direction, tmin, tmax, max_advances, nee,
                   alive, any_hit, fetch_colors, use_sun_open, sun_mode,
                   nee_src_open) -> PallasTraceResult:
    """B1 on the card (see ``raytrace``)."""
    dev = origin.x.device
    _check_mode(any_hit, fetch_colors, nee, use_sun_open, sun_mode)
    n = origin.x.shape[0]
    f32, i32 = torch.float32, torch.int32
    for name, c in zip(("ox", "oy", "oz", "dx", "dy", "dz"),
                       (*origin, *direction)):
        _cuda.require(c, name, f32, dev, (n,))
    for name in DeviceTables._fields[:-1]:
        _cuda.require(getattr(tables, name), name, i32, dev)
    if not isinstance(tmax, torch.Tensor):
        tmax = torch.full((n,), float(tmax), dtype=f32, device=dev)
    _cuda.require(tmax, "tmax", f32, dev, (n,))
    if alive is not None:
        if alive.dtype != torch.bool:
            alive = alive != 0
        _cuda.require(alive, "alive", torch.bool, dev, (n,))
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    nee_args = [None] * 4
    nee_rays = nee_idx = None
    if nee is not None:
        for name in ("u0", "u1", "alt_t"):
            _cuda.require(nee[name], name, f32, dev, (n,))
        _cuda.require(nee["scalars"], "nee scalars", f32, dev, (12,))
        nee_args = [nee["u0"], nee["u1"], nee["alt_t"], nee["scalars"]]
        nee_rays = torch.empty(6 * n, dtype=f32, device=dev)
        nee_idx = torch.empty(n, dtype=i32, device=dev)
    out_t = torch.empty(n, dtype=f32, device=dev)
    if any_hit:
        ipos, nrm, iters, color, act = [None] * 3, [None] * 3, None, None, None
    else:
        ipos = [torch.empty(n, dtype=i32, device=dev) for _ in range(3)]
        nrm = [torch.empty(n, dtype=f32, device=dev) for _ in range(3)]
        iters, color, act = (torch.empty(n, dtype=i32, device=dev)
                             for _ in range(3))
    vis = torch.empty(n, dtype=i32, device=dev) if nee is not None else None
    alive_list = torch.empty(n, dtype=i32, device=dev)
    counts = torch.zeros(3, dtype=i32, device=dev)
    pal = tables.palette_words if tables.palette_words.shape[0] else None

    fn = _cuda.lib("dda").traverse
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 6
                   + [ctypes.c_float] + [ctypes.c_void_p] * 2
                   + [ctypes.c_void_p] * 19 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    err = fn(*(ptr(getattr(tables, f)) for f in DeviceTables._fields[:9]),
             ptr(pal), ptr(tables.sun_open_words), tables.grid_res,
             max_advances, *(ptr(c) for c in (*origin, *direction)),
             float(tmin), ptr(tmax), ptr(alive),
             *(ptr(a) for a in nee_args), ptr(out_t),
             *(ptr(c) for c in ipos), *(ptr(c) for c in nrm), ptr(iters),
             ptr(color), ptr(act), ptr(vis), ptr(alive_list), ptr(counts),
             ptr(nee_rays), ptr(nee_idx), int(any_hit), int(use_sun_open),
             int(sun_mode != "off"), int(nee_src_open), n,
             _cuda.stream_ptr(dev))
    _cuda.check(err, "traverse")
    if n:
        _cuda.LAUNCHES["traverse_compact"] += 1
        _cuda.LAUNCHES["traverse"] += 1
        if any_hit:
            _cuda.LAUNCHES["traverse_shadow"] += 1
        if nee is not None:
            _cuda.LAUNCHES["traverse_nee"] += 1
    if any_hit:
        return PallasTraceResult(out_t, None, None, None, None, None,
                                 counts=counts)
    return PallasTraceResult(distance=out_t, ipos=V3(*ipos), normal=V3(*nrm),
                             iters=iters, color_word=color, active=act,
                             nee_visible=vis, counts=counts)
