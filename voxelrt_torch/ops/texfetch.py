"""Skybox texel fetches from bf16-packed RGB maps: kernels B2 (point fetch)
and B3 (bilinear fetch), the PyTorch/CUDA port of voxelrt/ops/texfetch.py.

Packing: texel t -> word[2t] = bf16(r) << 16 | bf16(g), word[2t+1] =
bf16(b) << 16, held as int32 words. bf16 (≈0.4% relative precision) is ample
for the smooth sky maps; the reference itself keeps its transmittance LUT in
f16 (renderer/atmos.py:64).

B3 has three entries: ``bilinear_fetch_packed`` at texel-space coordinates
(the JAX kernel's interface), and ``bilinear_fetch_dirs`` (one map) and
``bilinear_fetch_dirs2`` (both maps, from the 16-byte-a-texel table of
``interleave_words``) at directions, which fold the sky's projection
(``texel_coords``) into the kernel.

Each wrapper sends CPU tensors to its plain PyTorch twin and launches the
CUDA kernel (csrc/texfetch.cu) on CUDA tensors; there is no fallback from
one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from voxelrt_torch.ops import _cuda
from voxelrt_torch.ops.sampling import PI
from voxelrt_torch.ops.v3 import V3, vnormalize


def pack_rgb_bf16(img: np.ndarray) -> np.ndarray:
    """f32 (..., 3) image -> flat u32[2 * n_texels] (round-to-nearest-even),
    padded to a multiple of 1024 words."""
    flat = np.asarray(img, np.float32).reshape(-1, 3)
    bits = flat.view(np.uint32)
    rne = ((bits >> 16) & 1) + np.uint32(0x7FFF)
    b16 = (bits + rne) >> 16
    w0 = (b16[:, 0] << 16) | b16[:, 1]
    w1 = b16[:, 2] << 16
    words = np.stack([w0, w1], axis=1).reshape(-1).astype(np.uint32)
    pad = (-len(words)) % 1024
    if pad:
        words = np.concatenate([words, np.zeros(pad, np.uint32)])
    return words


def interleave_words(packed_scatt, packed_trans):
    """Both sky maps' packed words in one table, 16 bytes a texel: the
    scattering map's two words, then the transmittance map's two."""
    if packed_scatt.shape != packed_trans.shape:
        raise ValueError("the two maps' packed words differ in length")
    return torch.stack([packed_scatt.view(-1, 2), packed_trans.view(-1, 2)],
                       dim=1).reshape(-1)


def unpack_words_rgb_soa(w0, w1):
    """Decode pack_rgb_bf16 word pairs (int32) to (r, g, b) f32 tensors."""
    r = (w0 & -65536).view(torch.float32)
    g = (w0 << 16).view(torch.float32)
    b = (w1 & -65536).view(torch.float32)
    return r, g, b


# --- B2: point fetch ---------------------------------------------------------


def point_fetch_words_plain(packed_words, texel_word_idx):
    """Plain twin of B2: the two packed words of one texel per lane."""
    idx = texel_word_idx.long()
    return packed_words[idx], packed_words[idx + 1]


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_DIRS_ARGS = [_P] * 4 + [_LL] * 3 + [_P] * 3 + [_LL] * 3 + [_P, _LL, _I, _P]
# argument types of the C entry points (csrc/texfetch.cu)
_ARGTYPES = {
    "point_fetch_words": [_P] * 4 + [_LL, _P],
    "bilinear_fetch_packed": [_P] * 4 + [_LL, _I, _P],
    "bilinear_fetch_dirs": _DIRS_ARGS,
    "bilinear_fetch_dirs2": _DIRS_ARGS,
}


@functools.cache
def _entry(name):
    """The C entry point ``name``, its argument types set once."""
    fn = getattr(_cuda.lib("texfetch"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    return fn


def point_fetch_words(packed_words, texel_word_idx):
    """Fetch word pairs (w0, w1) = packed rgb of one texel per lane.

    packed_words: int32 (2 * n_texels padded,); texel_word_idx: (N,) int32
    EVEN word index (2 * texel id), pre-wrapped by the caller. Returns two
    (N,) int32 tensors holding the packed words exactly as stored."""
    dev = packed_words.device
    if dev.type == "cpu":
        return point_fetch_words_plain(packed_words, texel_word_idx)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _cuda.require(packed_words, "packed_words", torch.int32, dev)
    n = texel_word_idx.shape[0]
    _cuda.require(texel_word_idx, "texel_word_idx", torch.int32, dev, (n,))
    w0 = torch.empty(n, dtype=torch.int32, device=dev)
    w1 = torch.empty(n, dtype=torch.int32, device=dev)
    _cuda.check(_entry("point_fetch_words")(
        packed_words.data_ptr(), texel_word_idx.data_ptr(), w0.data_ptr(),
        w1.data_ptr(), n, _cuda.stream_ptr(dev)), "point_fetch_words")
    _cuda.LAUNCHES["point_fetch"] += 1
    return w0, w1


# --- B3: bilinear fetch ------------------------------------------------------


def bilinear_fetch_packed_plain(packed_words, fx, fy, res: int):
    """Plain twin of B3 (same operation order as the CUDA kernel)."""
    fx = torch.clamp(torch.where(torch.isfinite(fx), fx, 0.0), -1.0e6, 1.0e6)
    fy = torch.clamp(torch.where(torch.isfinite(fy), fy, 0.0), -1.0e6, 1.0e6)
    ix = torch.floor(fx)
    iy = torch.floor(fy)
    gx = fx - ix
    gy = fy - iy
    ixi = ix.to(torch.int64)
    iyi = iy.to(torch.int64)
    acc = [torch.zeros_like(fx) for _ in range(3)]
    for cx, cy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        wx = gx if cx else 1.0 - gx
        wy = gy if cy else 1.0 - gy
        w = wx * wy
        ax = torch.remainder(ixi + cx, res)
        ay = torch.remainder(iyi + cy, res)
        wid = (ax * res + ay) * 2
        rgb = unpack_words_rgb_soa(packed_words[wid], packed_words[wid + 1])
        acc = [a + w * c for a, c in zip(acc, rgb)]
    return torch.stack(acc, dim=-1)


def _require_map(words, name, dev, res, words_per_texel):
    _cuda.require(words, name, torch.int32, dev)
    if words.shape[0] < words_per_texel * res * res:
        raise ValueError(f"{name} is smaller than a res x res map")


def bilinear_fetch_packed(packed_words, fx, fy, res: int):
    """Bilinear wraparound fetch of an rgb texture packed by pack_rgb_bf16.

    fx/fy: (N,) f32 texel-space coordinates (uv*res - 0.5); non-finite
    coordinates clamp to 0. Returns (N, 3) f32."""
    dev = packed_words.device
    if dev.type == "cpu":
        return bilinear_fetch_packed_plain(packed_words, fx, fy, res)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _require_map(packed_words, "packed_words", dev, res, 2)
    n = fx.shape[0]
    _cuda.require(fx, "fx", torch.float32, dev, (n,))
    _cuda.require(fy, "fy", torch.float32, dev, (n,))
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    _cuda.check(_entry("bilinear_fetch_packed")(
        packed_words.data_ptr(), fx.data_ptr(), fy.data_ptr(), out.data_ptr(),
        n, res, _cuda.stream_ptr(dev)), "bilinear_fetch_packed")
    _cuda.LAUNCHES["bilinear_fetch"] += 1
    return out.t()


# --- B3 at directions: the sky's projection folded into the kernel -----------


def project_sky_soa(d: V3, skybox_res):
    """Hillaire EGSR 2020 equal-area-ish mapping -> (u, v) in [0,1]
    (voxelrt/sky/atmos.py project_sky_soa)."""
    fres = 1.0 / skybox_res
    inv = torch.rsqrt(torch.clamp(d.x * d.x + d.z * d.z, min=1e-20))
    azimuth = PI + torch.atan2(d.x * inv, -(d.z * inv))
    elevation = PI * 0.5 - torch.acos(torch.clamp(d.y, -1.0, 1.0))
    cx = azimuth / (2.0 * PI)
    cy = 0.5 + 0.5 * torch.sign(elevation) * torch.sqrt(
        2.0 / PI * torch.abs(elevation))
    return cx * (1.0 - fres) + 0.5 * fres, cy * (1.0 - fres) + 0.5 * fres


def texel_coords(d: V3, res: int, u3: V3 | None = None):
    """Texel-space coordinates (fx, fy) of direction ``d`` on a res x res
    sky map; with ``u3``, of the reference's jittered direction
    vnormalize(d + u3 * 0.0015) (the bilinear escape fetch). What the
    direction entries compute in their kernel (csrc/sky_project.cuh)."""
    if u3 is not None:
        d = vnormalize(d + u3 * 0.0015)
    su, sv = project_sky_soa(d, res)
    return su * res - 0.5, sv * res - 0.5


def bilinear_fetch_dirs_plain(packed_words, d: V3, res: int,
                              u3: V3 | None = None):
    """Plain twin of ``bilinear_fetch_dirs``: ``texel_coords``, then B3's
    plain twin."""
    fx, fy = texel_coords(d, res, u3)
    return bilinear_fetch_packed_plain(packed_words, fx, fy, res)


def bilinear_fetch_dirs2_plain(packed_scatt, packed_trans, d: V3, res: int,
                               u3: V3):
    """Plain twin of ``bilinear_fetch_dirs2``, on the two maps' own packed
    words: ``texel_coords``, then B3's plain twin on each map."""
    fx, fy = texel_coords(d, res, u3)
    return (bilinear_fetch_packed_plain(packed_scatt, fx, fy, res),
            bilinear_fetch_packed_plain(packed_trans, fx, fy, res))


def _vec_args(v: V3, name, dev, n):
    """Pointers and element strides of a V3's three (n,) float32 component
    views, which the kernel reads in place."""
    for c, t in zip("xyz", v):
        if (not isinstance(t, torch.Tensor) or t.device != dev
                or t.dtype != torch.float32 or tuple(t.shape) != (n,)):
            raise ValueError(f"{name}.{c} must be a float32 ({n},) tensor on "
                             f"{dev}")
    return [t.data_ptr() for t in v], [t.stride(0) for t in v]


def _launch_dirs(name, words, dev, d: V3, u3: V3 | None, res: int,
                 n_maps: int):
    """Launch the direction entry ``name`` on the table ``words``; returns
    its (3 * n_maps, N) output."""
    n = d.x.shape[0]
    dp, ds = _vec_args(d, "d", dev, n)
    up, us = _vec_args(u3, "u3", dev, n) if u3 is not None else (
        [None] * 3, [0] * 3)
    out = torch.empty((3 * n_maps, n), dtype=torch.float32, device=dev)
    _cuda.check(_entry(name)(words.data_ptr(), *dp, *ds, *up, *us,
                             out.data_ptr(), n, res, _cuda.stream_ptr(dev)),
                name)
    _cuda.LAUNCHES[name] += 1
    return out


def bilinear_fetch_dirs(packed_words, d: V3, res: int, u3: V3 | None = None):
    """B3 at directions: one packed map fetched at ``texel_coords(d, res,
    u3)``, the projection done in the kernel. ``d`` (and ``u3``): V3s of
    (N,) float32 views, any stride. Returns (N, 3) f32."""
    dev = packed_words.device
    if dev.type == "cpu":
        return bilinear_fetch_dirs_plain(packed_words, d, res, u3)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _require_map(packed_words, "packed_words", dev, res, 2)
    return _launch_dirs("bilinear_fetch_dirs", packed_words, dev, d, u3, res,
                        1).t()


def bilinear_fetch_dirs2(packed_scatt, packed_trans, words_st, d: V3,
                         res: int, u3: V3):
    """Both sky maps at the jittered directions' ``texel_coords`` in one
    launch. ``words_st`` is ``interleave_words(packed_scatt,
    packed_trans)``: the kernel reads it (one 16-byte load a corner), the
    plain twin on CPU tensors the two maps' own words. Returns ((N, 3)
    scattering, (N, 3) transmittance) f32."""
    dev = words_st.device
    if dev.type == "cpu":
        return bilinear_fetch_dirs2_plain(packed_scatt, packed_trans, d, res,
                                          u3)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _require_map(words_st, "words_st", dev, res, 4)
    if words_st.data_ptr() % 16:
        raise ValueError("words_st must be 16-byte aligned")
    out = _launch_dirs("bilinear_fetch_dirs2", words_st, dev, d, u3, res, 2)
    return out[:3].t(), out[3:].t()
