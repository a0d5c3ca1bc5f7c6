"""A frozen copy of the port's ``voxelrt_torch/ops/transforms.py``, taken when
the benchmark was defined, less what the plain reference does not call.

Screen/view/world space transforms (renderer/space_transformations.py);
the PyTorch port of voxelrt/ops/transforms.py.

Matrices follow the OpenGL column-vector convention: ``clip = P @ V @
world``, NDC in [-1, 1], screen coords in [0, 1]. Matrix entries are 0-d
float32 tensors and every product is written out as explicit multiply-adds
in the JAX package's order.
"""

from __future__ import annotations

import torch

from .v3 import V3


def apply_mat4(m, v3, w):
    """Apply a 4x4 matrix to packed (..., 3) points with homogeneous w."""
    out = [
        m[i, 0] * v3[..., 0] + m[i, 1] * v3[..., 1] + m[i, 2] * v3[..., 2]
        + m[i, 3] * w
        for i in range(4)
    ]
    return torch.stack(out, dim=-1)


def screen_to_view(uv, depth, inv_proj):
    """renderer/space_transformations.py:14-20 — depth is non-linear [0,1]."""
    ndc = torch.stack(
        [uv[..., 0] * 2.0 - 1.0, uv[..., 1] * 2.0 - 1.0,
         torch.broadcast_to(depth, uv[..., 0].shape) * 2.0 - 1.0],
        dim=-1,
    )
    pos = apply_mat4(inv_proj, ndc, 1.0)
    return pos[..., :3] / pos[..., 3:4]


def view_to_screen(view_pos, proj):
    """renderer/space_transformations.py:22-26."""
    pos = apply_mat4(proj, view_pos, 1.0)
    return (pos[..., :3] / pos[..., 3:4]) * 0.5 + 0.5


def _apply_mat4_soa(m, v: V3, w):
    return tuple(
        m[i, 0] * v.x + m[i, 1] * v.y + m[i, 2] * v.z + m[i, 3] * w
        for i in range(4)
    )


def screen_to_view_soa(u, v, depth, inv_proj) -> V3:
    """screen_to_view on (u, v) screen-coordinate components; ``depth`` is
    a number or a tensor shaped like them."""
    if not isinstance(depth, torch.Tensor):
        depth = torch.full_like(u, depth)
    ndc = V3(u * 2.0 - 1.0, v * 2.0 - 1.0, depth * 2.0 - 1.0)
    px, py, pz, pw = _apply_mat4_soa(inv_proj, ndc, 1.0)
    return V3(px / pw, py / pw, pz / pw)


def view_to_world_soa(pos: V3, inv_view, is_position=1.0) -> V3:
    x, y, z, _ = _apply_mat4_soa(inv_view, pos, is_position)
    return V3(x, y, z)


def world_to_view_soa(pos: V3, view, is_position=1.0) -> V3:
    x, y, z, _ = _apply_mat4_soa(view, pos, is_position)
    return V3(x, y, z)


def view_to_screen_z_soa(view_pos: V3, proj):
    """The z component of view_to_screen — all the G-buffer consumes."""
    z = (proj[2, 0] * view_pos.x + proj[2, 1] * view_pos.y
         + proj[2, 2] * view_pos.z + proj[2, 3])
    w = (proj[3, 0] * view_pos.x + proj[3, 1] * view_pos.y
         + proj[3, 2] * view_pos.z + proj[3, 3])
    return (z / w) * 0.5 + 0.5
