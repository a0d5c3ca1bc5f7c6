"""Carry the JAX package's scene state over to the port, from numpy arrays.

``from_jax_arrays`` takes the fields of the JAX package's ``SceneData`` and
``RenderParams`` as numpy arrays (``np.asarray`` of each JAX array; this
module never imports JAX) and returns the port's ``SceneData`` and
``RenderParams`` on ``device``; ``render_state_from_jax`` does the same for
a ``RenderState`` (its ReSTIR reservoirs included), ``reservoir_from_jax``
for one reservoir dict, ``sky_from_jax_arrays`` for a ``SkyData`` alone. Tests
use them to feed both packages the same inputs, the sky included (each
package computes its own otherwise, equal only up to float32 rounding and
the cloud texels that flip with it). In the other direction a sky travels as
the cache file: ``sky.atmos.prepare_sky`` writes ``sky_<key>.npz`` in the JAX
package's format and under its key.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from voxelrt_torch.ops.accel import PallasTables
from voxelrt_torch.ops.dda_kernel import upload_tables
from voxelrt_torch.ops.texfetch import interleave_words
from voxelrt_torch.render.pathtracer import RenderParams, SceneData
from voxelrt_torch.render.pipeline import RenderState
from voxelrt_torch.sky.atmos import SkyData


def _i32(a, device):
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a).astype(np.uint32)).view(
            np.int32).copy()).to(device)


def sky_from_jax_arrays(sky: dict, device) -> SkyData:
    """sky: mapping of the JAX package's SkyData fields as numpy arrays.
    The bf16-packed words are taken over when the mapping has them (the JAX
    package packs them only on its kernel path) and packed from the maps
    otherwise; both give the same words, and both interleave them into the
    port's two-map table."""
    from voxelrt_torch.sky.atmos import make_sky

    if sky.get("packed_scatt") is None or sky.get("packed_trans") is None:
        return make_sky(sky["skybox_scattering"], sky["skybox_transmittance"],
                        sky["cloud_ambient"], sky["trans_lut"], device)
    ps = _i32(sky["packed_scatt"], device)
    pt = _i32(sky["packed_trans"], device)
    return SkyData(
        np.asarray(sky["skybox_scattering"], np.float32),
        np.asarray(sky["skybox_transmittance"], np.float32),
        np.asarray(sky["cloud_ambient"], np.float32),
        np.asarray(sky["trans_lut"], np.float32), ps, pt,
        interleave_words(ps, pt))


def from_jax_arrays(scene: dict, params: dict, device):
    """scene: mapping with ``occ_words``, ``voxels``, ``mat_params``,
    ``tables`` (a mapping of the PallasTables fields, ``grid_res``
    included) and ``sky`` (a mapping of the SkyData fields with the
    bf16-packed ``packed_scatt``/``packed_trans`` words, or None);
    params: mapping of the RenderParams fields. Returns
    (SceneData, RenderParams)."""
    device = torch.device(device)
    t = scene["tables"]
    tables = PallasTables(**{f: (int(t[f]) if f == "grid_res"
                                 else np.asarray(t[f], np.uint32))
                             for f in PallasTables._fields})
    sky = None
    if scene.get("sky") is not None:
        sky = sky_from_jax_arrays(scene["sky"], device)
    sd = SceneData(
        occ_words=_i32(scene["occ_words"], device),
        voxels=_i32(scene["voxels"], device),
        mat_params=torch.tensor(np.asarray(scene["mat_params"], np.float32),
                                device=device),
        sky=sky,
        tables=upload_tables(tables, device),
    )
    p = {}
    for f in RenderParams._fields:
        a = np.asarray(params[f])
        dt = torch.int32 if np.issubdtype(a.dtype, np.integer) else \
            torch.float32
        p[f] = torch.tensor(a.astype(np.int32 if dt == torch.int32
                                     else np.float32), device=device)
    return sd, RenderParams(**p)


def reservoir_from_jax(res: dict, device) -> dict:
    """res: mapping of one of the JAX package's reservoir dicts (an input
    reservoir image or a storage slot) as numpy arrays. The u32
    ``rc_mat_info`` words become int64, every other field keeps its dtype.
    Returns the port's reservoir dict on ``device``."""
    out = {}
    for k, a in res.items():
        a = np.asarray(a)
        if k == "rc_mat_info":
            a = a.astype(np.int64)
        out[k] = torch.tensor(a, device=device)
    return out


def render_state_from_jax(state: dict, device) -> RenderState:
    """state: mapping of the JAX package's RenderState fields as numpy
    arrays, ``reservoirs`` a pair of reservoir dicts or None. The u32
    ``gbuff_mat_id`` and ``rc_mat_info`` words become int64, the f16
    normals stay f16, ``spp`` and ``frame`` become ints. Returns the port's
    RenderState on ``device``."""
    out = {}
    for f in dataclasses.fields(RenderState):
        if f.name == "reservoirs":
            slots = state.get("reservoirs")
            out[f.name] = None if slots is None else tuple(
                reservoir_from_jax(slot, device) for slot in slots)
            continue
        a = np.asarray(state[f.name])
        if f.name in ("spp", "frame"):
            out[f.name] = int(a)
        elif f.name == "gbuff_mat_id":
            out[f.name] = torch.tensor(a.astype(np.int64), device=device)
        else:
            out[f.name] = torch.tensor(a, device=device)
    return RenderState(**out)
