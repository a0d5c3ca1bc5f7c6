"""A frozen copy of the port's ``voxelrt_torch/ops/packing.py``, taken when
the benchmark was defined, less what the plain reference does not call.

Bit-packing codecs (octahedral normals, material words, arbitrary-width
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

from .v3 import V3


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


