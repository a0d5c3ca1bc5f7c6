"""Bit-packing codecs (octahedral normals, material words, arbitrary-width
u32 packs) — the PyTorch port of the parts of voxelrt/ops/packing.py that
the render path uses: the SoA forms for the wavefront, the packed-image forms
for the temporal filters and the ReSTIR storage reservoir
(render/restir.py).

The G-buffer stores octahedral f16 normals whose quantization is part of the
reference image (renderer/pathtracer.py:113,404). Packed material words are
u32 in the JAX package; here they are int64 tensors holding the u32 value.
"""

from __future__ import annotations

import torch

from voxelrt_torch.ops.v3 import V3


def encode_unit_vector_3x16_soa(v: V3):
    """Octahedral encode to 2 x f16 in [0,1] (renderer/math_utils.py:202-207);
    returns (ex, ey) f16 components."""
    l1 = torch.abs(v.x) + torch.abs(v.y) + torch.abs(v.z)
    l1 = torch.clamp(l1, min=1e-20)
    x = v.x / l1
    y = v.y / l1
    sx = torch.where(x >= 0.0, 1.0, -1.0)
    sy = torch.where(y >= 0.0, 1.0, -1.0)
    fold_x = (1.0 - torch.abs(y)) * sx
    fold_y = (1.0 - torch.abs(x)) * sy
    ex = torch.where(v.z <= 0.0, fold_x, x) * 0.5 + 0.5
    ey = torch.where(v.z <= 0.0, fold_y, y) * 0.5 + 0.5
    return ex.to(torch.float16), ey.to(torch.float16)


def encode_unit_vector_3x16(v):
    """encode_unit_vector_3x16_soa on a packed (..., 3) tensor; returns a
    packed (..., 2) f16 tensor."""
    return torch.stack(encode_unit_vector_3x16_soa(
        V3(v[..., 0], v[..., 1], v[..., 2])), dim=-1)


def decode_unit_vector_3x16(e):
    """renderer/math_utils.py:209-215 on a packed (..., 2) f16 tensor;
    returns a packed (..., 3) f32 tensor."""
    e = e.to(torch.float32) * 2.0 - 1.0
    x = e[..., 0]
    y = e[..., 1]
    z = 1.0 - torch.abs(x) - torch.abs(y)
    t = torch.clamp(-z, min=0.0)
    x = x + torch.where(x >= 0.0, -t, t)
    y = y + torch.where(y >= 0.0, -t, t)
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-20))
    return torch.stack([x * inv, y * inv, z * inv], dim=-1)


def _u8(c):
    return (c * 255.0).to(torch.int64) & 0xFF


def encode_material_soa(mat_id, albedo: V3):
    """renderer/math_utils.py:231-236 — mat id + rgb8 albedo in one u32
    (int64 tensor)."""
    m = mat_id.to(torch.int64) & 0xFF
    return m | (_u8(albedo.x) << 8) | (_u8(albedo.y) << 16) | (
        _u8(albedo.z) << 24)


def decode_material_word_soa(enc):
    """renderer/math_utils.py:238-247 — returns (mat_id i32, albedo V3)."""
    enc = enc.to(torch.int64)
    mat_id = (enc & 0xFF).to(torch.int32)
    albedo = V3(
        ((enc >> 8) & 0xFF).to(torch.float32) / 255.0,
        ((enc >> 16) & 0xFF).to(torch.float32) / 255.0,
        ((enc >> 24) & 0xFF).to(torch.float32) / 255.0,
    )
    return mat_id, albedo


def decode_material_word(enc):
    """decode_material_word_soa on a word image; returns (mat_id i32,
    albedo f32 (..., 3))."""
    mat_id, albedo = decode_material_word_soa(enc)
    return mat_id, torch.stack(list(albedo), dim=-1)


def encode_u32_arb(data, sizes):
    """renderer/math_utils.py:249-255 — four floats in [0, 1] (the last axis
    of ``data``) into one u32 word (int64 tensor); ``sizes``: the four bit
    widths."""
    out = torch.zeros(data.shape[:-1], dtype=torch.int64, device=data.device)
    shift = 0
    for i, bits in enumerate(sizes):
        q = (data[..., i] * float(2.0 ** bits - 1.0) + 0.5).to(torch.int64)
        out = out | ((q << shift) & 0xFFFFFFFF)
        shift += bits
    return out


def decode_u32_arb(enc, sizes):
    """renderer/math_utils.py:257-263 — inverse of encode_u32_arb: (...,
    4) float32."""
    enc = enc.to(torch.int64) & 0xFFFFFFFF
    parts = []
    shift = 0
    for bits in sizes:
        maxv = 2 ** bits - 1
        parts.append(((enc >> shift) & maxv).to(torch.float32)
                     / float(maxv))
        shift += bits
    return torch.stack(parts, dim=-1)
