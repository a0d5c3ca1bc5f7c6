"""The scene as the example script defines it, recorded without the port.

An example script (``examples/<name>.py``) builds its scene at import
through ``_common.make_scene`` and fills it in ``initialize_voxels()`` (or
``initialize()`` then ``draw()``). ``record_example`` runs the script
against :class:`RecordedScene`, a plain recorder of the Scene API's calls
with the same semantics as the port's ``Scene`` and ``VoxelWorld``: voxel
indices rounded half away from zero, colours clipped and stored as 8 bits,
the last write to a cell winning, and ``get_voxel`` reading back what was
stored. The camera is the Scene's default pose with GL-style matrices.
Imports nothing of the port.
"""

from __future__ import annotations

import importlib
import math
import os
import sys

import numpy as np

GRID_RES = 128
FOV = math.radians(50.0)
Z_NEAR, Z_FAR = 0.01, 10.0
CAMERA_POS = (0.4, 0.5, 2.0)
LOOK_AT = (0.0, 0.0, 0.0)
UP = (0.0, 1.0, 0.0)


def _round_half_away(x):
    return np.where(x >= 0, np.floor(x + 0.5), np.ceil(x - 0.5))


class RecordedScene:
    """The state that the example's Scene calls leave: the dense voxel
    grid (material and 8-bit colour, indexed [x, y, z] + res/2), the floor,
    the sun, the background and the sky flags."""

    def __init__(self, voxel_edges=0.06, exposure=3, image_res=None, **_):
        self.voxel_edges = float(voxel_edges)
        self.exposure = float(exposure)
        self.material = np.zeros((GRID_RES,) * 3, dtype=np.int8)
        self.color = np.zeros((GRID_RES,) * 3 + (3,), dtype=np.uint8)
        d = np.array([1.0, 1.0, 1.0])
        self.light_direction = d / np.linalg.norm(d)
        self.light_cone_cos_theta_max = math.cos(0.1 * 0.5)
        self.light_color = np.zeros(3)
        self.floor_height = 0.0
        self.floor_color = np.ones(3)
        self.floor_material = 1
        self.background_color = np.zeros(3)
        self.use_physical_sky = False
        self.use_clouds = False

    def _storage_idx(self, idx):
        idx = np.atleast_2d(np.asarray(idx, dtype=np.float64))
        sidx = _round_half_away(idx).astype(np.int64) + GRID_RES // 2
        inside = np.all((sidx >= 0) & (sidx < GRID_RES), axis=-1)
        return sidx, inside

    def set_voxel(self, idx, mat, color):
        sidx, inside = self._storage_idx(idx)
        n = sidx.shape[0]
        mat = np.broadcast_to(np.asarray(mat), (n,)).astype(np.int8)
        color = np.broadcast_to(np.asarray(color, dtype=np.float64), (n, 3))
        c8 = (np.clip(color, 0.0, 1.0) * 255).astype(np.uint8)
        s = sidx[inside]
        self.material[s[:, 0], s[:, 1], s[:, 2]] = mat[inside]
        self.color[s[:, 0], s[:, 1], s[:, 2]] = c8[inside]

    def get_voxel(self, idx):
        idx = np.asarray(idx, dtype=np.float64)
        single = idx.ndim == 1
        sidx, inside = self._storage_idx(idx)
        ci = np.clip(sidx, 0, GRID_RES - 1)
        mat = np.where(inside, self.material[ci[:, 0], ci[:, 1], ci[:, 2]],
                       0).astype(np.int32)
        col = (self.color[ci[:, 0], ci[:, 1], ci[:, 2]].astype(np.float32)
               / 255.0) * inside[:, None]
        if single:
            return int(mat[0]), col[0]
        return mat, col

    def set_floor(self, height, color, material=1):
        self.floor_height = float(height)
        self.floor_color = np.asarray(color, dtype=np.float64)
        self.floor_material = int(material)

    def set_directional_light(self, direction, direction_noise, color):
        d = np.asarray(direction, dtype=np.float64)
        self.light_direction = d / np.linalg.norm(d)
        self.light_cone_cos_theta_max = math.cos(direction_noise * 0.5)
        self.light_color = np.asarray(color, dtype=np.float64)

    def set_background_color(self, color):
        self.background_color = np.asarray(color, dtype=np.float64)

    def set_use_physical_sky(self, use):
        self.use_physical_sky = bool(use)

    def set_use_clouds(self, use):
        self.use_clouds = bool(use)

    def packed_voxels(self):
        """u32[res³], z-major: r | g<<8 | b<<16 | mat<<24."""
        c = self.color.astype(np.uint32)
        m = self.material.astype(np.uint8).astype(np.uint32)
        packed = c[..., 0] | (c[..., 1] << 8) | (c[..., 2] << 16) | (m << 24)
        return np.ascontiguousarray(packed.transpose(2, 1, 0)).reshape(-1)


def record_example(examples_dir, name):
    """Run ``examples_dir/<name>.py`` against the recorder; returns the
    :class:`RecordedScene` it filled. The module is imported afresh, so
    its module-level random generators start from their seeds."""
    if examples_dir not in sys.path:
        sys.path.insert(0, examples_dir)
    import _common

    saved = _common.make_scene
    _common.make_scene = lambda argv=None, **kw: RecordedScene(**kw)
    sys.modules.pop(name, None)
    try:
        mod = importlib.import_module(name)
        if hasattr(mod, "initialize_voxels"):
            mod.initialize_voxels()
        else:
            mod.initialize()
            if hasattr(mod, "draw"):
                mod.draw()
        scene = mod.scene
    finally:
        _common.make_scene = saved
        sys.modules.pop(name, None)
    if not isinstance(scene, RecordedScene):
        raise TypeError(f"{name} did not build its scene through make_scene")
    return scene


def _normalize(v):
    return v / np.sqrt(np.sum(v ** 2))


def camera_matrices(aspect):
    """GL perspective and look-at (column-vector convention) of the
    Scene's default camera, float32: (proj, view)."""
    f = 1.0 / math.tan(FOV * 0.5)
    proj = np.zeros((4, 4), dtype=np.float32)
    proj[0, 0] = f / aspect
    proj[1, 1] = f
    proj[2, 2] = (Z_FAR + Z_NEAR) / (Z_NEAR - Z_FAR)
    proj[2, 3] = 2.0 * Z_FAR * Z_NEAR / (Z_NEAR - Z_FAR)
    proj[3, 2] = -1.0
    eye = np.asarray(CAMERA_POS, dtype=np.float64)
    fwd = _normalize(np.asarray(LOOK_AT, dtype=np.float64) - eye)
    s = _normalize(np.cross(fwd, _normalize(np.asarray(UP, np.float64))))
    u = np.cross(s, fwd)
    view = np.eye(4, dtype=np.float32)
    view[0, :3] = s
    view[1, :3] = u
    view[2, :3] = -fwd
    view[0, 3] = -np.dot(s, eye)
    view[1, 3] = -np.dot(u, eye)
    view[2, 3] = np.dot(fwd, eye)
    return proj, view


def examples_dir(repo_root):
    return os.path.join(repo_root, "examples")
