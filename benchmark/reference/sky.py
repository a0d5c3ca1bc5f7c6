"""The escape sky's fetches, plain PyTorch: a frozen copy of the plain
twins of the port's kernels B2 and B3 (``voxelrt_torch/ops/texfetch.py``)
and of the fetch half of ``voxelrt_torch/sky/atmos.py``, taken when the
benchmark was defined, with the loading of a shipped sky map. The maps are
packed to bf16 words here, from the raw file, as the port packs them.
Imports nothing of the port.
"""

from __future__ import annotations

import hashlib
import os
from typing import NamedTuple

import numpy as np
import torch

from .sampling import PI
from .v3 import V3, vnormalize

TRANS_QUAD_STEPS = 16  # part of the sky file's cache key


class SkyData(NamedTuple):
    """The two bf16-packed sky maps, as int32 words on the render device."""

    packed_scatt: torch.Tensor
    packed_trans: torch.Tensor


def load_sky(cfg, sky_dir, sun_dir, sun_col, cos_max, device) -> SkyData:
    """The sky map of this config and light from ``sky_dir``, packed."""
    path = os.path.join(sky_dir, "sky_%s.npz" % _cache_key(
        cfg, sun_dir, sun_col, cos_max))
    with np.load(path) as z:
        scatt, trans = z["scatt"], z["trans"]

    def packed(img):
        words = pack_rgb_bf16(np.asarray(img, np.float32)).view(np.int32)
        return torch.from_numpy(words.copy()).to(device)

    return SkyData(packed(scatt), packed(trans))


def sample_skybox_transmittance(cfg, sky: SkyData, d: V3) -> V3:
    """Bilinear transmittance lookup at directions (B3's plain twin)."""
    fx, fy = texel_coords(d, cfg.skybox_res)
    return _v3(bilinear_fetch_packed_plain(sky.packed_trans, fx, fy,
                                           cfg.skybox_res))


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


def unpack_words_rgb_soa(w0, w1):
    """Decode pack_rgb_bf16 word pairs (int32) to (r, g, b) f32 tensors."""
    r = (w0 & -65536).view(torch.float32)
    g = (w0 << 16).view(torch.float32)
    b = (w1 & -65536).view(torch.float32)
    return r, g, b


def point_fetch_words_plain(packed_words, texel_word_idx):
    """Plain twin of B2: the two packed words of one texel per lane."""
    idx = texel_word_idx.long()
    return packed_words[idx], packed_words[idx + 1]


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
    scatt = V3(*unpack_words_rgb_soa(*point_fetch_words_plain(sky.packed_scatt,
                                                        wid)))
    if not want_trans:
        return scatt, None
    trans = V3(*unpack_words_rgb_soa(*point_fetch_words_plain(sky.packed_trans,
                                                        wid)))
    return scatt, trans


def _v3(rgb) -> V3:
    return V3(rgb[:, 0], rgb[:, 1], rgb[:, 2])


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
