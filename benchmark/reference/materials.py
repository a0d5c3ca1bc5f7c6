"""The Disney material palette (128 slots of 14 parameters) and its row
fetch: a frozen copy of the port's ``voxelrt_torch/materials.py`` and
``ops/lookup.py``'s ``lookup_onehot``, taken when the benchmark was
defined. Imports nothing of the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

N_SLOTS = 128
# Default slot values (renderer/materials.py:49-63): white base, specular
# 0.04, roughness 0.9, everything else zero.
_DEFAULT_ROW = (1.0, 1.0, 1.0, 0.0, 0.0, 0.04, 0.0, 0.9, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

# Curated palette, same values as the reference's default_material_set.csv
# (IDs documented at renderer/materials.py:12-45):
#  id   base rgb   subs met  spec tint rough aniso sheen stint cc  ccg  ior-1
_DEFAULT_SET = [
    (10, 1, 1, 1, 0.0, 0.0, 0.30, 0.0, 0.60, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),   # rough concrete
    (11, 1, 1, 1, 0.0, 0.0, 0.30, 0.0, 0.20, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),   # smooth concrete
    (20, 1, 1, 1, 0.9, 0.0, 0.50, 0.2, 0.04, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),   # silicate
    (21, 1, 1, 1, 0.5, 0.0, 0.35, 0.0, 0.22, 0.0, 0.0, 0.0, 0.6, 0.8, 0.0),   # smooth ceramic
    (22, 1, 1, 1, 0.5, 0.0, 0.35, 0.0, 0.80, 0.0, 0.0, 0.0, 0.6, 0.8, 0.0),   # rough ceramic
    (30, 1, 1, 1, 0.3, 0.0, 0.20, 0.0, 0.60, 0.0, 0.4, 0.5, 0.0, 0.0, 0.0),   # bark
    (31, 1, 1, 1, 0.3, 0.0, 0.50, 0.0, 0.50, 0.0, 0.4, 0.0, 0.0, 0.0, 0.0),   # wood plank
    (32, 1, 1, 1, 0.3, 0.0, 0.50, 0.0, 0.50, 0.0, 0.4, 0.0, 0.6, 0.7, 0.0),   # coated plank
    (40, 1, 1, 1, 0.4, 0.0, 0.30, 0.9, 0.20, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),   # smooth plastic
    (41, 1, 1, 1, 0.4, 0.0, 0.30, 0.9, 0.60, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),   # rough plastic
    (50, 1, 1, 1, 0.0, 1.0, 0.80, 0.0, 0.40, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),   # rough metal
    (51, 1, 1, 1, 0.0, 1.0, 0.80, 0.0, 0.11, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),   # smooth metal
    (52, 1, 1, 1, 0.0, 1.0, 0.80, 0.0, 1.00, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),   # mirror
    (53, 1, 1, 1, 0.0, 1.0, 0.80, 0.0, 0.40, 0.8, 0.0, 0.0, 0.0, 0.0, 0.0),   # brushed metal
    (54, 1, 1, 1, 0.0, 0.7, 0.80, 0.0, 0.30, 0.0, 0.0, 0.0, 0.7, 0.9, 0.0),   # car paint
    (80, 1, 1, 1, 0.9, 0.0, 0.04, 0.0, 0.80, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),   # plant
    (81, 1, 1, 1, 0.9, 0.0, 0.30, 0.0, 0.40, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),   # light skin
    (82, 1, 1, 1, 0.95, 0.0, 0.00, 0.0, 0.40, 0.0, 0.9, 0.4, 0.0, 0.0, 0.0),  # cloth
]


def lookup_onehot(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(R, C) table, (...,) int idx -> (..., C); zeros where idx is outside
    [0, R)."""
    r = table.shape[0]
    valid = (idx >= 0) & (idx < r)
    rows = table[idx.long().clamp(0, r - 1)]
    return torch.where(valid[..., None], rows,
                       torch.zeros((), dtype=table.dtype, device=table.device))


class Material(NamedTuple):
    """Batched Disney material parameters (renderer/bsdf.py:26-37); every
    field is an (N,) tensor except ``base_col``, a V3 (or (N, 3) tensor)."""

    base_col: object
    subsurface: torch.Tensor
    metallic: torch.Tensor
    specular: torch.Tensor
    specular_tint: torch.Tensor
    roughness: torch.Tensor
    anisotropic: torch.Tensor
    sheen: torch.Tensor
    sheen_tint: torch.Tensor
    clearcoat: torch.Tensor
    clearcoat_gloss: torch.Tensor
    ior_minus_one: torch.Tensor


def fetch_material(params: torch.Tensor, mat_id: torch.Tensor,
                   albedo=None) -> Material:
    """Fetch materials from a (128, 14) palette tensor for (N,) ids; the
    per-voxel color always overrides base_col
    (renderer/math_utils.py:245-247, renderer/pathtracer.py:429).

    Ids outside [0, 128) read an all-zero row, as the JAX package's one-hot
    lookup does."""
    p = lookup_onehot(params, mat_id)
    base = p[:, 0:3] if albedo is None else albedo
    return Material(
        base_col=base,
        subsurface=p[:, 3],
        metallic=p[:, 4],
        specular=p[:, 5],
        specular_tint=p[:, 6],
        roughness=p[:, 7],
        anisotropic=p[:, 8],
        sheen=p[:, 9],
        sheen_tint=p[:, 10],
        clearcoat=p[:, 11],
        clearcoat_gloss=p[:, 12],
        ior_minus_one=p[:, 13],
    )


class MaterialList:
    """128-slot palette as a (128, 14) parameter matrix (host numpy)."""

    def __init__(self, rows=None):
        params = np.tile(np.asarray(_DEFAULT_ROW, np.float32), (N_SLOTS, 1))
        for row in rows if rows is not None else _DEFAULT_SET:
            idx = int(row[0])
            params[idx] = np.asarray(row[1:], np.float32)
        self.params_np = params

    def params(self, device) -> torch.Tensor:
        return torch.as_tensor(self.params_np, device=device)
