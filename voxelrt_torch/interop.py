"""Carry the JAX package's scene state over to the port, from numpy arrays.

``from_jax_arrays`` takes the fields of the JAX package's ``SceneData`` and
``RenderParams`` as numpy arrays (``np.asarray`` of each JAX array; this
module never imports JAX) and returns the port's ``SceneData`` and
``RenderParams`` on ``device``; ``render_state_from_jax`` does the same for
a ``RenderState``. Tests use them to feed both packages the same inputs; it is also how a sky that the JAX package precomputed reaches the
port before the sky precompute is ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from voxelrt_torch.ops.accel import PallasTables
from voxelrt_torch.ops.dda_kernel import upload_tables
from voxelrt_torch.render.pathtracer import RenderParams, SceneData
from voxelrt_torch.render.pipeline import RenderState
from voxelrt_torch.sky.atmos import SkyData


def _i32(a, device):
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a).astype(np.uint32)).view(
            np.int32).copy()).to(device)


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
        s = scene["sky"]
        sky = SkyData(
            np.asarray(s["skybox_scattering"], np.float32),
            np.asarray(s["skybox_transmittance"], np.float32),
            np.asarray(s["cloud_ambient"], np.float32),
            np.asarray(s["trans_lut"], np.float32),
            _i32(s["packed_scatt"], device), _i32(s["packed_trans"], device))
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


def render_state_from_jax(state: dict, device) -> RenderState:
    """state: mapping of the JAX package's RenderState fields as numpy
    arrays (``reservoirs`` is not carried). The u32 ``gbuff_mat_id`` words
    become int64, the f16 normals stay f16, ``spp`` and ``frame`` become
    ints. Returns the port's RenderState on ``device``."""
    out = {}
    for f in dataclasses.fields(RenderState):
        a = np.asarray(state[f.name])
        if f.name in ("spp", "frame"):
            out[f.name] = int(a)
        elif f.name == "gbuff_mat_id":
            out[f.name] = torch.tensor(a.astype(np.int64), device=device)
        else:
            out[f.name] = torch.tensor(a, device=device)
    return RenderState(**out)
