"""Voxel world: dense grid storage + occupancy mip pyramid (the PyTorch
port's copy of voxelrt/world.py, host-side numpy; no JAX import).

TPU-native redesign of renderer/voxel_world.py and the pyramid *build* half
of renderer/raytracer.py:46-70. The reference stores color as u8x3 + material
as i8 fields with a [-64, 64) offset and bakes them into an rgba8 texture each
frame; we keep host-side numpy arrays for scene construction (the Scene API
mutates them) and upload immutable device tensors once at prepare time.

The occupancy pyramid build needs no atomics here: LOD k is an 8-way
reduce-any over LOD k-1 (a reshape + any), replacing the reference's
``ti.atomic_or`` scatter loop. The pyramid is packed into one u32 bitfield
with the same intra-LOD linearization (z-major: idx = (z*r + y)*r + x,
renderer/raytracer.py:33-38) so the traversal bit math matches. Note: the
reference's cross-LOD base offset formula ((n<<1) - ((n<<1)>>lod),
renderer/raytracer.py:32) over-allocates (it assumes each LOD halves rather
than eighths) and only works because Taichi pads dense fields to powers of
two; we use the exact packed bases sum((res>>i)**3).
"""

from __future__ import annotations

import numpy as np


def build_occupancy_pyramid(occupied_xyz: np.ndarray, n_lods: int) -> np.ndarray:
    """Build the packed u32 occupancy bitfield from a bool grid.

    occupied_xyz: (res, res, res) bool indexed [x, y, z] in grid space
    [0, res). Returns uint32 words; bit ``idx & 31`` of word ``idx >> 5``
    holds cell ``idx`` (renderer/raytracer.py:40-44).
    """
    res = occupied_xyz.shape[0]
    levels = []
    cur = np.ascontiguousarray(occupied_xyz.transpose(2, 1, 0))  # -> [z, y, x]
    levels.append(cur)
    for _ in range(1, n_lods):
        r = cur.shape[0] // 2
        cur = cur.reshape(r, 2, r, 2, r, 2).any(axis=(1, 3, 5))
        levels.append(cur)
    flat_bits = np.concatenate([lv.reshape(-1) for lv in levels]).astype(np.uint8)
    pad = (-len(flat_bits)) % 32
    if pad:
        flat_bits = np.concatenate([flat_bits, np.zeros(pad, dtype=np.uint8)])
    words = flat_bits.reshape(-1, 32)
    shifts = (np.uint32(1) << np.arange(32, dtype=np.uint32)).astype(np.uint32)
    return (words.astype(np.uint32) * shifts).sum(axis=1).astype(np.uint32)


def _round_half_away(x: np.ndarray) -> np.ndarray:
    """GLSL-style round (half away from zero), matching ti.round
    (scene.py:131-137)."""
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


class VoxelWorld:
    """Host-side dense voxel grid (renderer/voxel_world.py:5-25).

    Scene construction is vectorized: ``set_voxels`` accepts arrays of
    indices so ported example scenes run at numpy speed instead of the
    per-voxel device calls the Taichi DSL JIT-compiles.
    """

    def __init__(self, voxel_size: float, grid_res: int, voxel_edges: float):
        self.voxel_size = float(voxel_size)
        self.voxel_inv_size = 1.0 / voxel_size
        self.grid_res = int(grid_res)
        self.grid_offset = -(self.grid_res // 2)  # voxel_world.py:14
        self.voxel_edges = float(voxel_edges)
        self.n_lods = int(np.log2(self.grid_res))
        # Storage indexed [x + off, y + off, z + off] like the offset fields
        # at voxel_world.py:16-18.
        self.material = np.zeros((grid_res,) * 3, dtype=np.int8)
        self.color = np.zeros((grid_res,) * 3 + (3,), dtype=np.uint8)

    # -- Scene-construction API ------------------------------------------

    def _to_storage_idx(self, idx):
        idx = np.atleast_2d(np.asarray(idx, dtype=np.float64))
        ridx = _round_half_away(idx).astype(np.int64)
        sidx = ridx - self.grid_offset
        inside = np.all((sidx >= 0) & (sidx < self.grid_res), axis=-1)
        return sidx, inside

    def set_voxels(self, idx, mat, color):
        """Vectorized set_voxel (renderer/pathtracer.py:1325-1328).

        idx: (N, 3) or (3,) voxel coords in [-res/2, res/2); mat: scalar or
        (N,) material ids; color: (3,) or (N, 3) floats in [0, 1].
        Writes are applied in order; the last write to a cell wins.
        """
        sidx, inside = self._to_storage_idx(idx)
        n = sidx.shape[0]
        mat = np.broadcast_to(np.asarray(mat), (n,)).astype(np.int8)
        color = np.broadcast_to(np.asarray(color, dtype=np.float64), (n, 3))
        c8 = (np.clip(color, 0.0, 1.0) * 255).astype(np.uint8)
        sidx = sidx[inside]
        self.material[sidx[:, 0], sidx[:, 1], sidx[:, 2]] = mat[inside]
        self.color[sidx[:, 0], sidx[:, 1], sidx[:, 2]] = c8[inside]

    def get_voxels(self, idx):
        """Vectorized get_voxel (renderer/pathtracer.py:1330-1334)."""
        sidx, inside = self._to_storage_idx(idx)
        ci = np.clip(sidx, 0, self.grid_res - 1)
        mat = np.where(
            inside, self.material[ci[:, 0], ci[:, 1], ci[:, 2]], 0
        ).astype(np.int32)
        col = (
            self.color[ci[:, 0], ci[:, 1], ci[:, 2]].astype(np.float32) / 255.0
        ) * inside[:, None]
        return mat, col

    # -- Derived data ------------------------------------------------------

    def device_arrays(self):
        """Scene data for rendering, as host numpy arrays:

          occ_words  u32[(sum lod cells + 31)//32]  packed occupancy pyramid
          voxels     u32[res³] z-major              r | g<<8 | b<<16 | mat<<24

        The packed word mirrors the rgba8 texture bake the reference performs
        each frame (renderer/voxel_world.py:69-87) — one gather fetches both
        albedo and material id. The renderer uploads what it needs.
        """
        from voxelrt_torch.utils.native import build_occupancy

        occ = build_occupancy(self.material, self.grid_res, self.n_lods)
        c = self.color.astype(np.uint32)
        m = self.material.astype(np.uint8).astype(np.uint32)
        packed = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16) | (m << 24)
        packed_zyx = np.ascontiguousarray(packed.transpose(2, 1, 0)).reshape(-1)
        return {"occ_words": occ, "voxels": packed_zyx}
