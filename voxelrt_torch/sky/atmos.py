"""Physical sky + volumetric clouds (the PyTorch port of
voxelrt/sky/atmos.py): the precompute and the fetches.

Precompute, three stages as in the JAX package (SURVEY.md 2.7):
  A. transmittance: the 256x128 parity LUT, and the fixed-step quadrature
     ``sun_transmittance`` that the other stages evaluate per query;
  B. the cloud layer march, accumulated over N passes;
  C. the skybox scattering with the single-bounce multiple-scattering
     approximation (ms_energy = 5.3), and the cloud composite.

``prepare_sky`` loads a cache file when one matches the config and the light
(``.skycache/`` under the working directory, then the repo-shipped
``data/skycache/``) and otherwise computes the sky on the render device and
writes ``sky_<key>.npz`` in the JAX package's format under its ``_cache_key``,
so either package reads the other's files. The random draws follow the JAX
package's key derivation exactly (``PRNGKey(1234)``, ``fold_in(key, 1000 +
ci)`` per 16,384-texel chunk, then per stage, pass and step), so both
packages compute the same sky up to float32 rounding.

How it runs in eager PyTorch: the JAX package jits one chunk and loops over
the chunks; here chunks are independent, so several go through each tensor
op at once along a leading axis with per-chunk keys (the 16,384 texels stay
the unit of the draws). Every function takes SoA ``V3`` vectors whose
components have the shape ``B + (n,)`` (B: leading batch axes, n: lanes per
key) and a key whose two words have shape B. The procedural cloud field
depends only on integer texel coordinates and is periodic in 256, so it is
evaluated once into a 256x256 table and gathered, as a user cloud texture
is.

Fetches always take the kernel path of the JAX package: both skybox maps
are bf16-packed (ops/texfetch.pack_rgb_bf16), and also interleaved into one
16-byte-a-texel table; the stochastic escape-sky fetch reads one texel per
ray through kernel B2, the jittered 4-corner fetch (``sky_fetch='bilinear'``)
and the transmittance lookup go through kernel B3 at directions, which
projects each direction onto the map in the kernel. The JAX package's
texel-sort routing of the escape fetch (atmos.py:692-747, 812-844) is a pure
permutation of the fetches, so the port fetches in ray order with identical
per-ray results.
"""

from __future__ import annotations

import hashlib
import os
import time
from typing import Any, NamedTuple

import numpy as np
import torch

from voxelrt_torch import resolve_device
from voxelrt_torch.ops import prng
from voxelrt_torch.ops.sampling import (PI, dot, mix, normalize,
                                        sample_cone_oriented, saturate)
from voxelrt_torch.ops.texfetch import (bilinear_fetch_dirs,
                                        bilinear_fetch_dirs2,
                                        interleave_words, pack_rgb_bf16,
                                        point_fetch_words, project_sky_soa,
                                        unpack_words_rgb_soa)
from voxelrt_torch.ops.v3 import V3, map1, splat

# --- constants (renderer/atmos.py:37-83) -----------------------------------

AIR_NUM_DENSITY = 2.5035422e25
OZONE_PEAK = 8e-6
OZONE_NUM_DENSITY = AIR_NUM_DENSITY * 0.012588 * OZONE_PEAK
OZONE_CROSS_SEC = (
    np.array([4.51103766177301e-21, 3.2854797958699e-21, 1.96774621921165e-22])
    * 0.0001
)

RAYLEIGH_COEFF = np.array([0.00000519673, 0.0000121427, 0.0000296453])
MIE_COEFF = 8.6e-6
OZONE_COEFF = OZONE_CROSS_SEC * OZONE_NUM_DENSITY

# (3 species rows) -> transposed to (3 color, 3 species) like the reference.
EXTINC_MAT = np.stack(
    [RAYLEIGH_COEFF, np.full(3, MIE_COEFF * 1.11), OZONE_COEFF]
).T.astype(np.float32)
SCATTER_MAT = np.stack(
    [RAYLEIGH_COEFF, np.full(3, MIE_COEFF), np.zeros(3)]
).T.astype(np.float32)

SCALE_HEIGHT_RAYL = 8500.0
SCALE_HEIGHT_MIE = 1200.0
MIE_G = 0.75

PLANET_R = 6371e3
ATMOS_HEIGHT = 110e3

CLOUD_HEIGHT = 1000.0 + 1e3
CLOUD_THICKNESS = 170.0 * 2.0
CLOUD_DENSITY = 0.27
CLOUD_EXTINC = 0.075
CLOUD_SCATTER = CLOUD_EXTINC

CAM_POS = np.array([0.0, PLANET_R + 1e3, 0.0], np.float32)

TRANS_QUAD_STEPS = 16  # quadrature steps replacing the 128-step LUT march
CHUNK = 16384  # texels per key of the precompute (atmos.py:986)
SKY_SEED = 1234  # the precompute's root key (atmos.py:915, 965)


class SkyData(NamedTuple):
    skybox_scattering: Any  # (S, S, 3) f32, host numpy
    skybox_transmittance: Any  # (S, S, 3) f32, host numpy
    cloud_ambient: Any  # (3,)
    trans_lut: Any  # (256, 128, 3)
    packed_scatt: torch.Tensor | None = None  # int32 bf16-packed words
    packed_trans: torch.Tensor | None = None
    packed_st: torch.Tensor | None = None  # both, interleave_words


def _mat3vec(m, v: V3) -> V3:
    """Explicit 3x3 @ V3, in the JAX package's order of operations."""
    return V3(*(float(m[i, 0]) * v.x + float(m[i, 1]) * v.y
                + float(m[i, 2]) * v.z for i in range(3)))


def _f32(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


# --- geometry helpers -------------------------------------------------------


def rsi(pos: V3, dir: V3, r):
    """Ray-sphere intersection (renderer/atmos.py:9-15); returns (near, far),
    (-1, -1) on miss."""
    b = _fdot(pos, dir)
    # b*b - |pos|^2 cancels badly in float32 (both near 4e13 at sea level, an
    # ulp of 4e6 m^2), so it is formed with one rounding, in float64: what the
    # fused multiply-add gives that XLA emits for this expression.
    bd = b.to(torch.float64)
    discr = (bd * bd - _fdot(pos, pos).to(torch.float64)).to(torch.float32) \
        + r * r
    miss = discr < 0.0
    sq = _sqrt(torch.clamp(discr, min=0.0))
    near = torch.where(miss, -1.0, -b - sq)
    far = torch.where(miss, -1.0, -b + sq)
    return near, far


def rayleigh_phase(cos_theta):
    return 3.0 / (16.0 * PI) * (1.0 + cos_theta * cos_theta)


def mie_phase(cos_theta, g):
    return (1 - g * g) / (
        4.0 * PI * torch.pow(
            torch.clamp(1.0 + g * g - 2 * g * cos_theta, min=1e-8), 1.5)
    )


def _fma(a: V3, b: V3, c) -> V3:
    """a + b * c with one rounding: formed in float64, then rounded to
    float32, as the fused multiply-add XLA emits for it in the JAX package's
    sky functions."""
    c = c.to(torch.float64) if isinstance(c, torch.Tensor) else float(c)
    return V3(*((ai.to(torch.float64) + bi.to(torch.float64) * c)
                .to(torch.float32) for ai, bi in zip(a, b)))


def _fdot(a: V3, b: V3):
    """a . b as XLA's reduction in the JAX package forms it: the x product
    rounded, then the y and z products each added with a fused multiply-add
    (one rounding each)."""
    (ax, ay, az), (bx, by, bz) = ((c.to(torch.float64) for c in v)
                                  for v in (a, b))
    s = (ax * bx).to(torch.float32).to(torch.float64)
    s = (s + ay * by).to(torch.float32).to(torch.float64)
    return (s + az * bz).to(torch.float32)


def _sqrt(x):
    """float32 square root, correctly rounded as XLA's and CUDA's are:
    PyTorch's vectorised CPU kernel is not (it misses the nearest float on
    about 13% of float32 inputs on an AVX-512 host), so it is taken in
    float64 and rounded once."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def get_elevation(pos: V3):
    """Height above the planet as XLA compiles it: a fused dot product and a
    correctly rounded square root."""
    return _sqrt(_fdot(pos, pos)) - PLANET_R


def get_ozone_density(h):
    """renderer/atmos.py:500-518."""
    h_km = h * 0.001
    a = h_km - 25.0
    peak_rel_sqr = a * a
    d = (1.0 - 0.375) * torch.exp(peak_rel_sqr / -49.0)
    d = d + 0.375 * torch.exp(peak_rel_sqr / -256.0)
    c = h_km - 15.0
    d = d + torch.clamp(-0.000015 * (c * c * c), min=0.0)
    return d * 4.0


def get_density(h):
    """The three species densities (Rayleigh, Mie, ozone) at elevation h
    (renderer/atmos.py:520-523), as a tuple of tensors shaped like h."""
    h = torch.clamp(h, min=0.0)
    return (torch.exp(h / -SCALE_HEIGHT_RAYL),
            torch.exp(h / -SCALE_HEIGHT_MIE),
            get_ozone_density(h))


def _optical_depth_march(p0: V3, step: V3, step_delta, steps: int,
                         offset_first: bool):
    """Sum of density * step_delta at ``steps`` points; the i-th point is
    ``p0 + step * i`` (``offset_first``) or p0 advanced i times by step."""
    od = None
    p = p0
    for i in range(steps):
        if offset_first:
            p = p0 + step * float(i)
        dens = get_density(get_elevation(p))
        term = [d * step_delta for d in dens]
        od = term if od is None else [a + b for a, b in zip(od, term)]
        if not offset_first:
            p = p + step
    return V3(*od), p


def sun_transmittance(pos: V3, dir: V3, steps: int = TRANS_QUAD_STEPS) -> V3:
    """Transmittance from ``pos`` along ``dir`` to the top of the atmosphere:
    midpoint quadrature of the optical-depth integral the LUT bakes
    (renderer/atmos.py:475-498), including the below-horizon zeroing."""
    _, far = rsi(pos, dir, PLANET_R + ATMOS_HEIGHT)
    step_delta = torch.clamp(far, min=0.0) / steps
    p0 = pos + dir * (0.5 * step_delta)
    step = dir * step_delta
    od, _ = _optical_depth_march(p0, step, step_delta, steps, True)
    trans = map1(torch.exp, -_mat3vec(EXTINC_MAT, od))
    near_p, _ = rsi(pos, dir, PLANET_R)
    below = near_p > 0.0
    return map1(lambda c: torch.where(below, 0.0, c), trans)


# --- parity LUT (renderer/atmos.py:462-498) ---------------------------------


def generate_transmittance_lut(device=None):
    """Exact port of the 256x128 LUT bake, 128-step march; (256, 128, 3).
    ``device=None`` is the CUDA card (raises without one)."""
    device = resolve_device(device)
    x = torch.arange(256, dtype=torch.float32, device=device)
    y = torch.arange(128, dtype=torch.float32, device=device)
    cos_theta = ((x[:, None] / 256.0) * 2.0 - 1.0).expand(256, 128)
    h = (ATMOS_HEIGHT * y[None, :] / 128.0).expand(256, 128)
    theta = torch.acos(torch.clamp(cos_theta, -1.0, 1.0))
    zero = torch.zeros((256, 128), dtype=torch.float32, device=device)
    ray_dir = V3(torch.sin(theta), cos_theta, zero)
    ray_pos = V3(zero, PLANET_R + h, zero)
    return torch.stack(get_ray_transmittance(ray_pos, ray_dir), dim=-1)


def get_ray_transmittance(ray_pos: V3, ray_dir: V3) -> V3:
    """renderer/atmos.py:475-498 (128 steps, the reference's start offset)."""
    steps = 128
    fsteps = 1.0 / steps
    _, far = rsi(ray_pos, ray_dir, PLANET_R + ATMOS_HEIGHT)
    step_delta = far * fsteps
    ray_step = ray_dir * step_delta
    p = ray_pos + ray_step * (
        0.5 * (torch.clamp(ray_dir.y, min=0.0) * 0.5 + 0.5))
    od, p = _optical_depth_march(p, ray_step, step_delta, steps, False)
    trans = map1(torch.exp, -_mat3vec(EXTINC_MAT, od))
    near_p, _ = rsi(p, ray_dir, PLANET_R)
    below = near_p > 0.0
    return map1(lambda c: torch.where(below, 0.0, c), trans)


def read_trans_lut(lut, cos_theta, h):
    """renderer/atmos.py:458-460: nearest LUT read (test/parity path only;
    the precompute uses sun_transmittance)."""
    cu = torch.clamp(((cos_theta * 0.5 + 0.5) * 256).to(torch.int64), 0, 255)
    hv = torch.clamp((h / ATMOS_HEIGHT * 128).to(torch.int64), 0, 127)
    return lut.reshape(-1, 3)[cu * 128 + hv]


# --- procedural cloud density field -----------------------------------------


def _hash01(ix, iy, ch: int):
    """Integer lattice -> [0, 1) hash, periodic in 256 (uint32 arithmetic in
    int64 tensors, masked after every product)."""
    m = prng.M32
    x = (ix & 255).to(torch.int64)
    y = (iy & 255).to(torch.int64)
    n = (x + y * 57 + ch * 131) & m
    n = ((n << 13) & m) ^ n
    nn = (n * n) & m
    inner = (((nn * 15731) & m) + 789221) & m
    n = (((n * inner) & m) + 1376312589) & m
    return (n & 0x7FFFFFFF).to(torch.float32) / float(0x7FFFFFFF)


def _value_noise(px, py, freq, ch):
    """Bilinear value noise on a lattice of period 256/freq (freq = 2^k)."""
    sx = px / (256.0 / freq)
    sy = py / (256.0 / freq)
    ix = torch.floor(sx).to(torch.int64)
    iy = torch.floor(sy).to(torch.int64)
    fx = sx - ix
    fy = sy - iy
    fx = fx * fx * (3.0 - 2.0 * fx)
    fy = fy * fy * (3.0 - 2.0 * fy)
    per = int(freq)
    ix0, iy0 = torch.remainder(ix, per), torch.remainder(iy, per)
    ix1, iy1 = torch.remainder(ix + 1, per), torch.remainder(iy + 1, per)
    a = _hash01(ix0, iy0, ch)
    b = _hash01(ix1, iy0, ch)
    c = _hash01(ix0, iy1, ch)
    d = _hash01(ix1, iy1, ch)
    return mix(mix(a, b, fx), mix(c, d, fx), fy)


def cloud_texture_channels(cx, cy):
    """The procedural stand-in for the 256x256 cloud texture: two density
    layers (x, y) and a coverage channel (z), all in [0, 1]."""
    px = cx.to(torch.float32)
    py = cy.to(torch.float32)

    def fbm(ch, octaves=4, lac=2.0, gain=0.55):
        amp, freq, total, norm = 1.0, 4.0, 0.0, 0.0
        for o in range(octaves):
            total = total + amp * _value_noise(px, py, freq, ch * 8 + o)
            norm += amp
            amp *= gain
            freq *= lac
        return total / norm

    low = saturate(fbm(0) * 1.9 - 0.45)
    high = saturate(fbm(1) * 1.9 - 0.55)
    coverage = saturate(fbm(2, octaves=3) * 1.6 - 0.15)
    return low, high, coverage


class CloudTable(NamedTuple):
    """The cloud density field as gather tables over the 256x256 texel
    lattice: ``words[t]`` is CLOUD_DENSITY * coverage * lower-band density of
    texel t = cx * 256 + cy, ``words[65536 + t]`` the same with the
    upper-band density, each channel thresholded at 0.7 first. ``wrap``: the
    lattice index wraps (the procedural field is periodic in 256); a user
    texture clamps instead (atmos.py:318-321)."""

    words: torch.Tensor  # (131072,) f32
    wrap: bool


_PROCEDURAL: dict = {}


def cloud_table(tex=None, device=None) -> CloudTable:
    """The CloudTable of a user cloud texture ((256, 256, 3) floats in
    [0, 1]) or, with None, of the procedural field (cached per device).
    ``device=None`` is the CUDA card (raises without one)."""
    device = resolve_device(device)
    if isinstance(tex, CloudTable):
        return tex
    if tex is None:
        if device not in _PROCEDURAL:
            c = torch.arange(256, device=device)
            ch = cloud_texture_channels(c[:, None].expand(256, 256),
                                        c[None, :].expand(256, 256))
            _PROCEDURAL[device] = _table_of(ch, True)
        return _PROCEDURAL[device]
    t3 = _f32(tex, device).reshape(256, 256, 3)
    return _table_of((t3[..., 0], t3[..., 1], t3[..., 2]), False)


def _table_of(channels, wrap) -> CloudTable:
    tx, ty, tz = (torch.where(c < 0.7, 0.0, c).reshape(-1) for c in channels)
    return CloudTable(torch.cat([CLOUD_DENSITY * tz * tx,
                                 CLOUD_DENSITY * tz * ty]), wrap)


def sample_cloud_density(ray_pos: V3, tex=None, relative_height=None):
    """renderer/atmos.py:195-224; same tiling, texel quantization, 0.7
    thresholds, height bands and layer gate. ``tex``: a CloudTable, a user
    cloud texture, or None for the built-in procedural field.
    ``relative_height``: the elevation of ``ray_pos`` where the caller has it
    already."""
    tab = cloud_table(tex, ray_pos.x.device)
    tile_size = 29000.0
    px = ray_pos.x + tile_size * 0.65
    pz = ray_pos.z + tile_size * 0.65
    u = torch.remainder(px, tile_size) / tile_size
    v = torch.remainder(pz, tile_size) / tile_size
    cx = (u * 256).to(torch.int32)
    cy = (v * 256).to(torch.int32)
    if relative_height is None:
        relative_height = get_elevation(ray_pos)
    if tab.wrap:
        flat = (cx & 255) * 256 + (cy & 255)
    else:
        flat = torch.clamp(cx, 0, 255) * 256 + torch.clamp(cy, 0, 255)
    upper = relative_height >= CLOUD_HEIGHT + CLOUD_THICKNESS * 0.65
    dens = tab.words[flat + upper.to(torch.int32) * 65536]
    in_layer = (relative_height > CLOUD_HEIGHT) & (
        relative_height < CLOUD_HEIGHT + CLOUD_THICKNESS)
    return torch.where(in_layer, dens, 0.0)


# --- cloud scattering (renderer/atmos.py:226-349) ---------------------------


def cloud_phase(cos_theta, an):
    """renderer/atmos.py:262-267: 3-lobe HG mix."""
    peak = mie_phase(cos_theta, 0.92 * an)
    front = mie_phase(cos_theta, 0.4 * an)
    back = mie_phase(cos_theta, -0.55 * an)
    return mix(mix(front, back, 0.5), peak, 0.15)


def clouds_shadow_od(ray_origin: V3, ray_dir: V3, dither, steps=8, tex=None):
    """renderer/atmos.py:231-260: exponential-stride shadow march."""
    exponent = 1.6
    step_delta = 24.0 / steps
    od = None
    ray_pos = ray_origin
    ray_step = ray_dir * step_delta
    for _ in range(steps):
        ray_step = ray_step * exponent
        step_delta = step_delta * exponent
        dithered = _fma(ray_pos, ray_step, dither)
        rel_h = get_elevation(dithered)
        in_layer = (rel_h >= CLOUD_HEIGHT) & (
            rel_h <= CLOUD_HEIGHT + CLOUD_THICKNESS)
        term = torch.where(
            in_layer, sample_cloud_density(dithered, tex, rel_h) * step_delta,
            0.0)
        od = term if od is None else od + term
        ray_pos = ray_pos + ray_step
    return od


def clouds_scattering(cfg, ray_origin: V3, ray_dir: V3, sun_dir, sun_col,
                      sun_cone_cos_theta_max, dither, key, cloud_ambient,
                      tex=None):
    """renderer/atmos.py:269-349: one ``cfg.cloud_steps``-step cloud march
    pass. ``ray_dir`` and ``dither`` have the shape B + (n,), the key words
    the shape B. Returns (in_scatter V3, transmittance, weighted_dist).
    The sun-sample loop is an extra axis before the lanes."""
    steps = cfg.cloud_steps
    n_sun = cfg.cloud_sun_samples
    fsteps = 1.0 / steps
    dev = ray_dir.x.device
    n = ray_dir.x.shape[-1]
    tab = cloud_table(tex, dev)
    sun = splat(_f32(sun_dir, dev))
    sun_col = splat(_f32(sun_col, dev))
    cloud_ambient = splat(_f32(cloud_ambient, dev))

    _, bottom_far = rsi(ray_origin, ray_dir, PLANET_R + CLOUD_HEIGHT)
    _, top_far = rsi(ray_origin, ray_dir,
                     PLANET_R + CLOUD_HEIGHT + CLOUD_THICKNESS)

    step_delta = (top_far - bottom_far) * fsteps
    ray_step = ray_dir * step_delta
    start = _fma(ray_origin, ray_dir, bottom_far)
    pos0 = _fma(start, ray_step, dither)
    off = start - ray_origin
    dist0 = _sqrt(_fdot(off, off))
    one = torch.ones((), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    up = V3(zero, one, zero)
    octaves = torch.tensor([1.0, 0.5, 0.25, 0.125], dtype=torch.float32,
                           device=dev)
    an = octaves[:, None, None]  # (4, n_sun, n) with the lanes
    an1 = octaves[:, None]
    ray_dir_s = map1(lambda c: c.unsqueeze(-2), ray_dir)
    dither_s = dither.unsqueeze(-2)

    in_scatter = V3(*(torch.zeros_like(ray_dir.x) for _ in range(3)))
    transmittance = torch.ones_like(ray_dir.x)
    weighted_dist = torch.zeros_like(ray_dir.x)
    weight_sum = torch.zeros_like(ray_dir.x)
    for i in range(steps):
        ray_pos = _fma(pos0, ray_step, float(i))
        distance_traveled = dist0 + step_delta * float(i + 1)

        density = sample_cloud_density(ray_pos, tab)
        live = (density > 0.0) & (transmittance > 1e-4)

        step_od = CLOUD_EXTINC * density * step_delta
        step_trans = saturate(torch.exp(-step_od))
        step_weight = (1.0 - step_trans) / CLOUD_EXTINC
        visible = transmittance * step_weight

        ki = prng.fold_in(key, i)
        u_sun = prng.uniform(ki, (n_sun, n, 2), dev)
        # Batched sun samples: B + (n_sun, n).
        sdirs = sample_cone_oriented(sun_cone_cos_theta_max, sun,
                                     (u_sun[..., 0], u_sun[..., 1]))
        posb = map1(lambda c: c.unsqueeze(-2), ray_pos)
        cos_theta = dot(ray_dir_s, sdirs)
        sun_od = clouds_shadow_od(posb, sdirs, dither_s,
                                  steps=cfg.cloud_shadow_steps, tex=tab)
        sun_atmos_trans = sun_transmittance(posb, sdirs)
        # 4 multiple-scattering octaves (Wrenninge): B + (4, n_sun, n)
        phase = cloud_phase(cos_theta.unsqueeze(-3), an)
        amount = an * CLOUD_SCATTER * phase * torch.exp(
            -sun_od.unsqueeze(-3) * CLOUD_EXTINC * an)
        scatter_add = V3(*(
            torch.sum(amount * t.unsqueeze(-3), dim=(-3, -2))
            * (c / n_sun) * visible
            for t, c in zip(sun_atmos_trans, sun_col)))

        ambient_od = clouds_shadow_od(ray_pos, up, dither,
                                      steps=cfg.cloud_shadow_steps, tex=tab)
        amb_amount = torch.sum(
            an1 * (CLOUD_SCATTER / (4.0 * PI))
            * torch.exp(-ambient_od.unsqueeze(-2) * CLOUD_EXTINC * an1),
            dim=-2)
        scatter_add = scatter_add + cloud_ambient * (visible * amb_amount)

        in_scatter = in_scatter + map1(
            lambda c: torch.where(live, c, 0.0), scatter_add)
        transmittance = torch.where(live, transmittance * step_trans,
                                    transmittance)
        weighted_dist = weighted_dist + distance_traveled * transmittance
        weight_sum = weight_sum + transmittance
    weighted_dist = weighted_dist / torch.clamp(weight_sum, min=1e-20)
    return in_scatter, transmittance, weighted_dist


# --- atmospheric scattering (renderer/atmos.py:355-425) ---------------------


def _ms_dirs(n_ms):
    """The fixed multiple-scattering directions (renderer/atmos.py:404-405)."""
    out = []
    for j in range(n_ms):
        u0 = (j + 0.5) / n_ms
        u1 = (j * 1.618033988749) % 1.0
        ax = u0 * 2.0 * np.pi
        ay = u1 * 2.0 - 1.0
        g = np.array([np.sin(ax), np.cos(ax)]) * np.sqrt(max(1.0 - ay * ay, 0.0))
        v = np.array([g[0], g[1], ay])
        out.append(v / np.linalg.norm(v))
    return np.asarray(out, np.float32)


def atmospheric_scattering(cfg, ray_origin: V3, ray_dir: V3, sun_dir, sun_col,
                           sun_cone_cos_theta_max, key, depth=0, steps=None):
    """Single + approximate multiple scattering march
    (renderer/atmos.py:356-425). ``ray_origin``/``ray_dir`` have components
    of shape B + (n,), the key words the shape B. ``depth`` is static; depth
    2 contributes nothing. Sun cone samples are an extra axis before the
    lanes; the multiple-scattering recursion flattens its fixed directions
    into the lanes of the depth-1 call, as the JAX package does (its draws
    depend on that layout). Returns (in_scatter, transmittance) V3s."""
    dev = ray_dir.x.device
    shape = torch.broadcast_shapes(ray_origin.x.shape, ray_dir.x.shape)
    ray_origin = map1(lambda c: c.expand(shape), ray_origin)
    ray_dir = map1(lambda c: c.expand(shape), ray_dir)
    n = shape[-1]
    if steps is None:
        steps = cfg.sky_steps
    if depth > 1:
        z = torch.zeros(shape, dtype=torch.float32, device=dev)
        o = torch.ones(shape, dtype=torch.float32, device=dev)
        return V3(z, z, z), V3(o, o, o)
    sun = splat(_f32(sun_dir, dev))
    sun_col_v = splat(_f32(sun_col, dev))

    air_near, air_far = rsi(ray_origin, ray_dir, PLANET_R + ATMOS_HEIGHT)
    planet_near, _ = rsi(ray_origin, ray_dir, PLANET_R)
    air_far = torch.where(planet_near > 0.0,
                          torch.minimum(air_far, planet_near), air_far)

    fsteps = 1.0 / steps
    step_delta = (air_far - torch.clamp(air_near, min=0.0)) * fsteps
    ray_step = ray_dir * step_delta
    pos0 = ray_origin + ray_step * 0.5

    n_sun = cfg.sky_sun_samples
    n_ms = cfg.sky_ms_samples
    ms_energy = 5.3  # renderer/atmos.py:400
    rc = splat(_f32(RAYLEIGH_COEFF, dev))
    ray_dir_s = map1(lambda c: c.unsqueeze(-2), ray_dir)
    if depth == 0:
        ms = _f32(_ms_dirs(n_ms), dev)  # (n_ms, 3)
        ms_v = V3(ms[:, 0:1], ms[:, 1:2], ms[:, 2:3])  # (n_ms, 1) each
        flat = shape[:-1] + (n_ms * n,)
        dirf = map1(lambda c: c.expand(shape[:-1] + (n_ms, n)).reshape(flat),
                    ms_v)
        ph_ms = mie_phase(dot(ray_dir_s, ms_v), MIE_G)

    in_scatter = V3(*(torch.zeros(shape, dtype=torch.float32, device=dev)
                      for _ in range(3)))
    transmittance = V3(*(torch.ones(shape, dtype=torch.float32, device=dev)
                         for _ in range(3)))
    kd = prng.fold_in(key, depth)
    for i in range(steps):
        ray_pos = pos0 + ray_step * float(i)
        density = get_density(get_elevation(ray_pos))
        step_od = _mat3vec(EXTINC_MAT, V3(*(d * step_delta for d in density)))
        step_trans = map1(lambda c: saturate(torch.exp(-c)), step_od)
        visible = V3(*(
            t * saturate((1.0 - st) / torch.clamp(so, min=1e-20))
            for t, st, so in zip(transmittance, step_trans, step_od)))

        ki = prng.fold_in(kd, i)
        u_sun = prng.uniform(ki, (n_sun, n, 2), dev)
        sdirs = sample_cone_oriented(sun_cone_cos_theta_max, sun,
                                     (u_sun[..., 0], u_sun[..., 1]))
        del u_sun
        cos_theta = dot(ray_dir_s, sdirs)
        ph_r = rayleigh_phase(cos_theta)
        ph_m = mie_phase(cos_theta, MIE_G)
        posb = map1(lambda c: c.unsqueeze(-2), ray_pos)
        sun_trans = sun_transmittance(posb, sdirs)  # B + (n_sun, n)
        del sdirs
        # sum over the sun samples of sun_trans * phase, per species.
        sum_r = map1(lambda c: torch.sum(c * ph_r, dim=-2), sun_trans)
        sum_m = map1(lambda c: torch.sum(c * ph_m, dim=-2), sun_trans)
        del sun_trans, ph_r, ph_m, cos_theta
        common = sun_col_v * visible / n_sun
        w_r = density[0] * step_delta
        w_m = density[1] * step_delta
        in_scatter = in_scatter + rc * common * sum_r * w_r
        in_scatter = in_scatter + MIE_COEFF * common * sum_m * w_m

        if depth == 0:
            # Flatten (n_ms, n) into the lanes of one depth-1 call.
            posf = map1(
                lambda c: c.unsqueeze(-2).expand(shape[:-1] + (n_ms, n))
                .reshape(flat), ray_pos)
            amb_scatter, _ = atmospheric_scattering(
                cfg, posf, dirf, sun_dir, sun_col, sun_cone_cos_theta_max,
                prng.fold_in(ki, 100), depth + 1, cfg.sky_ms_steps)
            amb = map1(lambda c: c.reshape(shape[:-1] + (n_ms, n)),
                       amb_scatter)
            amb_sum = map1(lambda c: torch.sum(c, dim=-2), amb)
            amb_sum_m = map1(lambda c: torch.sum(c * ph_ms, dim=-2), amb)
            in_scatter = in_scatter + ms_energy * rc * amb_sum * visible \
                * w_r / n_ms
            in_scatter = in_scatter + ms_energy * MIE_COEFF * amb_sum_m \
                * visible * w_m / n_ms

        transmittance = transmittance * step_trans
    below = planet_near > 0.0
    transmittance = map1(lambda c: torch.where(below, 0.0, c), transmittance)
    return in_scatter, transmittance


# --- skybox parameterization (renderer/atmos.py:427-455) --------------------
# project_sky_soa lives in ops/texfetch.py beside the kernel entries that
# fold it in.


def project_sky(d, skybox_res):
    """project_sky_soa on a packed (..., 3) direction tensor -> (..., 2)."""
    u, v = project_sky_soa(V3(d[..., 0], d[..., 1], d[..., 2]), skybox_res)
    return torch.stack([u, v], dim=-1)


def unproject_sky(u, v, skybox_res) -> V3:
    """The direction of the skybox coordinate (u, v) in [0, 1]^2."""
    fres = 1.0 / skybox_res
    cx = (u - 0.5 * fres) / (1.0 - fres)
    cy = (v - 0.5 * fres) / (1.0 - fres)
    a = 1.0 - 2.0 * cy
    b = 2.0 * cy - 1.0
    cy = torch.where(cy < 0.5, -(a * a), b * b)
    azimuth = cx * 2.0 * PI - PI
    elevation = cy * 0.5 * PI
    ce = torch.cos(elevation)
    se = torch.sin(elevation)
    ca = torch.cos(azimuth)
    sa = torch.sin(azimuth)
    return normalize(V3(ce * sa, se, -ce * ca))


def _bilinear_wrap(img, fx, fy, res):
    """Bilinear fetch with % wraparound on both axes (atmos.py:97-113), on an
    unpacked (res, res, C) f32 map."""
    ix = torch.floor(fx).to(torch.int64)
    iy = torch.floor(fy).to(torch.int64)
    gx = fx - ix
    gy = fy - iy
    flat = img.reshape(-1, img.shape[-1])

    def fetch(ax, ay):
        return flat[torch.remainder(ax, res) * res + torch.remainder(ay, res)]

    bl = fetch(ix, iy)
    br = fetch(ix + 1, iy)
    tl = fetch(ix, iy + 1)
    tr = fetch(ix + 1, iy + 1)
    return mix(mix(bl, br, gx[..., None]), mix(tl, tr, gx[..., None]),
               gy[..., None])


def _sample_skybox_stochastic(cfg, sky: SkyData, d: V3, u3: V3, want_trans):
    """Stochastic-bilinear skybox fetch (atmos.py:637-754): ONE of the 4
    bilinear corners per ray, picked with probability equal to its bilinear
    weight (unbiased), read through kernel B2."""
    res = cfg.skybox_res
    su, sv = project_sky_soa(d, res)
    fx = su * res - 0.5
    fy = sv * res - 0.5
    finite = torch.isfinite(fx) & torch.isfinite(fy)
    fx = torch.clamp(torch.where(finite, fx, 0.0), -1.0e6, 1.0e6)
    fy = torch.clamp(torch.where(finite, fy, 0.0), -1.0e6, 1.0e6)
    ix = torch.floor(fx)
    iy = torch.floor(fy)
    px = ix.to(torch.int32) + (u3.x < (fx - ix)).to(torch.int32)
    py = iy.to(torch.int32) + (u3.y < (fy - iy)).to(torch.int32)
    tex = torch.remainder(px, res) * res + torch.remainder(py, res)
    wid = (tex * 2).to(torch.int32)
    scatt = V3(*unpack_words_rgb_soa(*point_fetch_words(sky.packed_scatt,
                                                        wid)))
    if not want_trans:
        return scatt, None
    trans = V3(*unpack_words_rgb_soa(*point_fetch_words(sky.packed_trans,
                                                        wid)))
    return scatt, trans


def sample_skybox(cfg, sky: SkyData, d: V3, u3: V3, want_trans=True):
    """renderer/atmos.py:94-115: the escape-sky fetch. ``sky_fetch`` picks
    the estimator: 'stochastic' (one corner through B2) or 'bilinear' (the
    reference's direction jitter and a 4-corner fetch of both maps through
    B3 at directions, both maps in one launch), in ray order. Returns
    (scatt, trans) V3s, trans None when ``want_trans`` is False."""
    if cfg.sky_fetch == "stochastic":
        return _sample_skybox_stochastic(cfg, sky, d, u3, want_trans)
    res = cfg.skybox_res
    if not want_trans:
        return _v3(bilinear_fetch_dirs(sky.packed_scatt, d, res, u3)), None
    scatt, trans = bilinear_fetch_dirs2(sky.packed_scatt, sky.packed_trans,
                                        sky.packed_st, d, res, u3)
    return _v3(scatt), _v3(trans)


def _v3(rgb) -> V3:
    return V3(rgb[:, 0], rgb[:, 1], rgb[:, 2])


def sample_skybox_transmittance(cfg, sky: SkyData, d: V3) -> V3:
    """renderer/atmos.py:117-131: bilinear transmittance lookup through
    kernel B3 at directions."""
    return _v3(bilinear_fetch_dirs(sky.packed_trans, d, cfg.skybox_res))


# --- the precompute, end to end ---------------------------------------------


def _texel_dirs(cfg, chunk_idx, chunk, device) -> V3:
    """Directions of the texels of chunk(s) ``chunk_idx`` (an int, or an
    int64 tensor of shape B): components of shape B + (chunk,)."""
    res = cfg.skybox_res
    start = torch.as_tensor(chunk_idx, dtype=torch.int64,
                            device=device)[..., None] * chunk
    lin = start + torch.arange(chunk, dtype=torch.int64, device=device)
    u = (lin // res).to(torch.float32)
    v = (lin % res).to(torch.float32)
    return unproject_sky((u + 0.5) / res, (v + 0.5) / res, res)


def _cache_key(cfg, sun_dir, sun_col, cos_max, cloud_tex=None):
    h = hashlib.sha1()
    fields = (
        cfg.skybox_res, cfg.sky_steps, cfg.sky_sun_samples, cfg.sky_ms_samples,
        cfg.sky_ms_steps, cfg.cloud_steps, cfg.cloud_sun_samples,
        cfg.cloud_shadow_steps, cfg.cloud_accum_passes, cfg.use_clouds,
        TRANS_QUAD_STEPS, 3,  # version
    )
    h.update(repr(fields).encode())
    h.update(np.asarray(sun_dir, np.float32).tobytes())
    h.update(np.asarray(sun_col, np.float32).tobytes())
    h.update(np.float32(cos_max).tobytes())
    if cloud_tex is not None:
        h.update(np.asarray(cloud_tex, np.float32).tobytes())
    return h.hexdigest()[:16]


def make_sky(scatt, trans, ambient, lut, device) -> SkyData:
    """SkyData from host maps, with the bf16-packed words on ``device``."""
    def packed(img):
        words = pack_rgb_bf16(np.asarray(img, np.float32)).view(np.int32)
        return torch.from_numpy(words.copy()).to(device)

    ps, pt = packed(scatt), packed(trans)
    return SkyData(np.asarray(scatt, np.float32), np.asarray(trans, np.float32),
                   np.asarray(ambient, np.float32), np.asarray(lut, np.float32),
                   ps, pt, interleave_words(ps, pt))


def _cache_paths(cfg, sun_dir, sun_col, cos_max, cache_dir, cloud_tex):
    """(the working cache's path, the repo-shipped path) of this sky."""
    name = f"sky_{_cache_key(cfg, sun_dir, sun_col, cos_max, cloud_tex)}.npz"
    shipped = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        os.pardir, "data", "skycache", name,
    )
    return os.path.join(cache_dir, name), shipped


def load_sky(cfg, sun_dir, sun_col, cos_max, device, cache_dir=".skycache",
             cloud_tex=None) -> SkyData | None:
    """The cache-lookup half of prepare_sky (atmos.py:941-962): the cached
    sky for this config and light, or None when no file matches."""
    for path in _cache_paths(cfg, sun_dir, sun_col, cos_max, cache_dir,
                             cloud_tex):
        if os.path.exists(path):
            with np.load(path) as z:
                return make_sky(z["scatt"], z["trans"], z["ambient"], z["lut"],
                                device)
    return None


def _chunks_per_batch(cfg, n_chunks, chunk, device) -> int:
    """How many chunks go through each tensor op at once. The widest tensors
    are the depth-1 march's: n_ms * n_sun lanes per texel, about 40 float32
    temporaries of them alive at the peak."""
    lanes = chunk * max(cfg.sky_ms_samples * cfg.sky_sun_samples,
                        4 * cfg.cloud_sun_samples, 1)
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        budget = int(free * 0.5) // (4 * 40)
    else:
        budget = 1 << 22
    return max(1, min(n_chunks, budget // lanes))


def prepare_sky(cfg, sun_dir, sun_col, cos_max, quiet=False,
                cache_dir=".skycache", cloud_tex=None, device=None,
                stats=None) -> SkyData:
    """Stages A+B+C (renderer/pathtracer.py:314-323, scene.py:199-253) in one
    deterministic, disk-cached precompute on ``device`` (None: the CUDA
    card, raising without one). ``cloud_tex``:
    optional (256, 256, 3) [0, 1] cloud texture (Scene.set_cloud_texture)
    replacing the procedural density field; hashed into the cache key.
    ``stats``: an optional dict that receives ``cache_hit`` and, on a miss,
    the seconds of each stage (``lut_s``, ``cloud_s``, ``sky_s``, each closed
    by a device synchronize) and ``chunks_per_batch``, the number of
    16,384-texel chunks that went through each tensor op at once (sized to
    the device's memory; the result does not depend on it)."""
    device = resolve_device(device)
    stats = {} if stats is None else stats
    sky = load_sky(cfg, sun_dir, sun_col, cos_max, device, cache_dir,
                   cloud_tex)
    stats["cache_hit"] = sky is not None
    if sky is not None:
        return sky

    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    res = cfg.skybox_res
    key = prng.key(SKY_SEED)
    sun_dir = np.asarray(sun_dir, np.float32)
    sun_col = np.asarray(sun_col, np.float32)
    cos_max = float(np.float32(cos_max))

    if not quiet:
        print("Generating atmosphere LUT")
    t0 = clock()
    lut = generate_transmittance_lut(device)
    stats["lut_s"] = clock() - t0

    # Cloud ambient (renderer/atmos.py:134-138).
    amb_origin = CAM_POS + np.array([0.0, CLOUD_HEIGHT, 0.0], np.float32)
    amb_pos = map1(lambda c: c.reshape(1), splat(_f32(amb_origin, device)))
    up = map1(lambda c: c.reshape(1), splat(_f32([0.0, 1.0, 0.0], device)))
    amb_scatter, _ = atmospheric_scattering(
        cfg, amb_pos, up, sun_dir, sun_col, cos_max, prng.fold_in(key, 0))
    cloud_ambient = torch.stack([c[0] for c in amb_scatter])

    tab = cloud_table(cloud_tex, device)
    n_texels = res * res
    chunk = min(n_texels, CHUNK)
    n_chunks = (n_texels + chunk - 1) // chunk
    group = _chunks_per_batch(cfg, n_chunks, chunk, device)
    stats["chunks_per_batch"] = group
    cam = splat(_f32(CAM_POS, device))
    passes = cfg.cloud_accum_passes

    scatt = torch.zeros((n_chunks * chunk, 3), dtype=torch.float32,
                        device=device)
    trans = torch.zeros_like(scatt)
    stats["cloud_s"] = stats["sky_s"] = 0.0
    t_start = time.perf_counter()
    for c0 in range(0, n_chunks, group):
        ci = torch.arange(c0, min(c0 + group, n_chunks), dtype=torch.int64,
                          device=device)
        kc = prng.fold_in(key, 1000 + ci)
        dirs = _texel_dirs(cfg, ci, chunk, device)

        # Stage B: cloud accumulation (always runs: the cloud transmittance
        # multiplies into the sky transmittance unconditionally).
        t0 = clock()
        k = prng.fold_in(kc, 1)
        acc_s = acc_t = acc_d = 0.0
        for p in range(passes):
            kp = prng.fold_in(k, p)
            dither = prng.uniform(prng.fold_in(kp, 1), (chunk,), device)
            s, t, dist = clouds_scattering(
                cfg, cam, dirs, sun_dir, sun_col, cos_max, dither,
                prng.fold_in(kp, 2), cloud_ambient, tex=tab)
            acc_s = acc_s + s * 1.2 / passes
            acc_t = acc_t + saturate(t) / passes
            acc_d = acc_d + dist / passes
        cloud_s, cloud_t, cloud_d = acc_s, acc_t, acc_d
        t1 = clock()
        stats["cloud_s"] += t1 - t0

        # Stage C: skybox scattering + composite (renderer/atmos.py:160-189).
        k = prng.fold_in(kc, 2)
        sky_total_s, sky_total_t = atmospheric_scattering(
            cfg, cam, dirs, sun_dir, sun_col, cos_max, prng.fold_in(k, 1))
        cloud_pos = cam + dirs * torch.clamp(cloud_d, min=0.0)
        sky_fc_s, sky_fc_t = atmospheric_scattering(
            cfg, cloud_pos, dirs, sun_dir, sun_col, cos_max,
            prng.fold_in(k, 2))
        trans_to_cloud = sky_total_t / map1(
            lambda c: torch.clamp(c, min=1e-20), sky_fc_t)
        in_scattering = sky_total_s
        if cfg.use_clouds:
            in_scattering = in_scattering - sky_fc_s * map1(
                saturate, trans_to_cloud * torch.clamp(1.0 - cloud_t, min=0.0))
            in_scattering = in_scattering + cloud_s * map1(saturate,
                                                           trans_to_cloud)
        out_trans = sky_total_t * cloud_t
        lo, hi = c0 * chunk, (c0 + len(ci)) * chunk
        scatt[lo:hi] = torch.stack(in_scattering, dim=-1).reshape(-1, 3)
        trans[lo:hi] = torch.stack(out_trans, dim=-1).reshape(-1, 3)
        stats["sky_s"] += clock() - t1
        if not quiet:
            print(f"  skybox {c0 + len(ci)}/{n_chunks} "
                  f"({time.perf_counter() - t_start:.1f}s)")

    scatt_np = scatt[:n_texels].reshape(res, res, 3).cpu().numpy()
    trans_np = trans[:n_texels].reshape(res, res, 3).cpu().numpy()
    ambient_np = cloud_ambient.cpu().numpy()
    lut_np = lut.cpu().numpy()
    os.makedirs(cache_dir, exist_ok=True)
    cache_path = _cache_paths(cfg, sun_dir, sun_col, cos_max, cache_dir,
                              cloud_tex)[0]
    # written under another name first: a reader never sees half a file
    tmp = f"{cache_path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, scatt=scatt_np, trans=trans_np,
                            ambient=ambient_np, lut=lut_np)
    os.replace(tmp, cache_path)
    return make_sky(scatt_np, trans_np, ambient_np, lut_np, device)
