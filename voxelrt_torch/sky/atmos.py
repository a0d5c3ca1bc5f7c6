"""Physical sky, fetch half (the PyTorch port of the sampling side of
voxelrt/sky/atmos.py).

The precompute (transmittance quadrature, atmospheric and cloud scattering)
is not ported yet: a sky comes from a cache file written by the JAX
package's ``prepare_sky`` (``.skycache/`` under the working directory, then
the repo-shipped ``data/skycache/``), keyed by the same ``_cache_key``, or
from :func:`voxelrt_torch.interop.from_jax_arrays`. When no cache file
matches, :func:`load_sky` raises ``NotImplementedError``.

Fetches always take the kernel path of the JAX package: both skybox maps
are bf16-packed (ops/texfetch.pack_rgb_bf16); the stochastic escape-sky
fetch reads one texel per ray through kernel B2 and the transmittance
lookup is a bilinear fetch through kernel B3. The JAX package's texel-sort
routing of the escape fetch (atmos.py:692-747) is a pure permutation of the
fetches, so the port fetches in ray order with identical per-ray results.
"""

from __future__ import annotations

import hashlib
import os
from typing import Any, NamedTuple

import numpy as np
import torch

from voxelrt_torch.ops.sampling import PI, mix
from voxelrt_torch.ops.texfetch import (bilinear_fetch_packed,
                                        pack_rgb_bf16, point_fetch_words,
                                        unpack_words_rgb_soa)
from voxelrt_torch.ops.v3 import V3

TRANS_QUAD_STEPS = 16  # part of the cache key (atmos.py:96)


class SkyData(NamedTuple):
    skybox_scattering: Any  # (S, S, 3) f32, host numpy
    skybox_transmittance: Any  # (S, S, 3) f32, host numpy
    cloud_ambient: Any  # (3,)
    trans_lut: Any  # (256, 128, 3)
    packed_scatt: torch.Tensor | None = None  # int32 bf16-packed words
    packed_trans: torch.Tensor | None = None


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

    return SkyData(np.asarray(scatt, np.float32), np.asarray(trans, np.float32),
                   np.asarray(ambient, np.float32), np.asarray(lut, np.float32),
                   packed(scatt), packed(trans))


def load_sky(cfg, sun_dir, sun_col, cos_max, device, cache_dir=".skycache",
             cloud_tex=None) -> SkyData:
    """The cached sky for this config and light (atmos.py:941-962)."""
    key_str = _cache_key(cfg, sun_dir, sun_col, cos_max, cloud_tex)
    name = f"sky_{key_str}.npz"
    shipped = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        os.pardir, "data", "skycache", name,
    )
    for path in (os.path.join(cache_dir, name), shipped):
        if os.path.exists(path):
            with np.load(path) as z:
                return make_sky(z["scatt"], z["trans"], z["ambient"], z["lut"],
                                device)
    raise NotImplementedError(
        f"no cached sky {name} for this config and light: the sky "
        "precompute is not ported yet; render the scene once "
        "with the JAX package to write the cache, or hand the sky over with "
        "voxelrt_torch.interop.from_jax_arrays")


# --- skybox parameterization (renderer/atmos.py:427-455) --------------------


def project_sky_soa(d: V3, skybox_res):
    """Hillaire EGSR 2020 equal-area-ish mapping -> (u, v) in [0,1]."""
    fres = 1.0 / skybox_res
    inv = torch.rsqrt(torch.clamp(d.x * d.x + d.z * d.z, min=1e-20))
    azimuth = PI + torch.atan2(d.x * inv, -(d.z * inv))
    elevation = PI * 0.5 - torch.acos(torch.clamp(d.y, -1.0, 1.0))
    cx = azimuth / (2.0 * PI)
    cy = 0.5 + 0.5 * torch.sign(elevation) * torch.sqrt(
        2.0 / PI * torch.abs(elevation))
    return cx * (1.0 - fres) + 0.5 * fres, cy * (1.0 - fres) + 0.5 * fres


def project_sky(d, skybox_res):
    """project_sky_soa on a packed (..., 3) direction tensor -> (..., 2)."""
    u, v = project_sky_soa(V3(d[..., 0], d[..., 1], d[..., 2]), skybox_res)
    return torch.stack([u, v], dim=-1)


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


def sample_skybox(cfg, sky: SkyData, d: V3, u3: V3, want_trans=True):
    """Stochastic-bilinear skybox fetch (atmos.py:637-754): ONE of the 4
    bilinear corners per ray, picked with probability equal to its bilinear
    weight (unbiased), read through kernel B2. Returns (scatt, trans) V3s,
    trans None when ``want_trans`` is False."""
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


def sample_skybox_transmittance(cfg, sky: SkyData, d: V3) -> V3:
    """renderer/atmos.py:117-131: bilinear transmittance lookup through
    kernel B3."""
    res = cfg.skybox_res
    su, sv = project_sky_soa(d, res)
    fx = (su * res - 0.5).contiguous()
    fy = (sv * res - 0.5).contiguous()
    out = bilinear_fetch_packed(sky.packed_trans, fx, fy, res)
    return V3(out[:, 0], out[:, 1], out[:, 2])
