"""A frozen copy of the port's ``voxelrt_torch/ops/sampling.py``, taken when
the benchmark was defined, less what the plain reference does not call.

Sampling and shading-frame helpers on ray batches (the PyTorch port of
voxelrt/ops/sampling.py, SoA V3 form).

Where the reference consumes ``ti.random()`` per thread, these take explicit
uniform arguments from the counter-based generator (ops/prng.py), so every
sample is reproducible. Unsigned 32-bit hashing runs in int64 tensors with
``& 0xFFFFFFFF`` so that it gives the same bits on the CPU and the GPU.
"""

from __future__ import annotations

import torch

from .v3 import V3, vcross, vdot, vnormalize

EPS = 1e-6
INF = float("inf")
PI = 3.141592653589793
M32 = 0xFFFFFFFF


def saturate(x):
    return torch.clamp(x, 0.0, 1.0)


def sqr(x):
    return x * x


def dot(a: V3, b: V3):
    return vdot(a, b)


def length(v: V3):
    return torch.sqrt(torch.clamp(vdot(v, v), min=0.0))


def normalize(v: V3, eps: float = 1e-20) -> V3:
    return vnormalize(v, eps)


def luminance(c: V3):
    """renderer/math_utils.py:151-153."""
    return c.x * 0.2125 + c.y * 0.7154 + c.z * 0.0721


def mix(a, b, t):
    return a + (b - a) * t


def smoothstep(edge0, edge1, x):
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def reflect(i: V3, n: V3) -> V3:
    """GLSL reflect: i - 2*dot(n,i)*n (i points toward the surface)."""
    return i - n * (2.0 * vdot(n, i))


def make_orthonormal_basis(n: V3):
    """renderer/math_utils.py:32-37 — returns (tangent, bitangent).

    h = x-axis when |n.y| > 0.9 else y-axis; y = normalize(cross(n, h));
    x = cross(n, y)."""
    ny = torch.abs(n.y) > 0.9
    one = torch.ones((), dtype=n.x.dtype, device=n.x.device)
    zero = torch.zeros((), dtype=n.x.dtype, device=n.x.device)
    h = V3(torch.where(ny, one, zero), torch.where(ny, zero, one), zero)
    y = vnormalize(vcross(n, h))
    x = vcross(n, y)
    return x, y


def tangent_to_world(n: V3, v_local: V3) -> V3:
    """renderer/math_utils.py:40-42 / :56-59 — columns (x, y, n) frame."""
    x, y = make_orthonormal_basis(n)
    return x * v_local.x + y * v_local.y + n * v_local.z


def sample_cosine_weighted_hemisphere(n: V3, u) -> V3:
    """renderer/math_utils.py:22-30 (Shirley et al., RT Gems ch. 16);
    u = (u0, u1)."""
    u0, u1 = u
    a = 1.0 - 2.0 * u0
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0))
    a = a * (1.0 - 1e-5)
    b = b * (1.0 - 1e-5)  # grazing-angle precision fix
    phi = 2.0 * PI * u1
    return vnormalize(
        V3(n.x + b * torch.cos(phi), n.y + b * torch.sin(phi), n.z + a))


def sample_cone(cos_theta_max, u) -> V3:
    """renderer/math_utils.py:44-54 — cone around +z, u = (u0, u1)."""
    u0, u1 = u
    cos_theta = (1.0 - u0) + u0 * cos_theta_max
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    phi = 2.0 * PI * u1
    return V3(sin_theta * torch.cos(phi), sin_theta * torch.sin(phi),
              cos_theta)


def sample_cone_oriented(cos_theta_max, n: V3, u) -> V3:
    """renderer/math_utils.py:56-59 — cone around direction n."""
    return tangent_to_world(n, sample_cone(cos_theta_max, u))


def cone_sample_pdf(cos_theta_max, cos_theta):
    """renderer/math_utils.py:61-65. Deliberately reproduces the reference's
    simplification (the pdf ignores the cone orientation); it is part of
    the image. Returns a tensor shaped like ``cos_theta``."""
    pdf = 1.0 / (2.0 * PI * (1.0 - cos_theta_max))
    dev = torch.as_tensor(cos_theta_max).device
    if isinstance(cos_theta, torch.Tensor):
        cos_theta = cos_theta.to(device=dev, dtype=torch.float32)
    else:
        # filled on the device: no host-to-device copy
        cos_theta = torch.full((), cos_theta, dtype=torch.float32, device=dev)
    return torch.where(cos_theta >= cos_theta_max, pdf,
                       torch.zeros((), dtype=torch.float32, device=dev))


def power_heuristic(a, b):
    """renderer/pathtracer.py:349-353."""
    a_sqr = a * a
    p_sum = torch.clamp(a_sqr + b * b, min=1e-4)
    return a_sqr / p_sum


def _mul32(a, b):
    """Low 32 bits of a*b for values in [0, 2**32), without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def pcg3d(a, b, c):
    """PCG3D hash (Jarzynski & Olano, "Hash Functions for GPU Rendering",
    JCGT 2020): three u32 inputs (int64 tensors in [0, 2**32)) -> three
    decorrelated u32 outputs, bit-exact with the JAX package's uint32 form."""
    m = 1664525
    add = 1013904223
    a = (a * m + add) & M32
    b = (b * m + add) & M32
    c = (c * m + add) & M32
    a = (a + _mul32(b, c)) & M32
    b = (b + _mul32(c, a)) & M32
    c = (c + _mul32(a, b)) & M32
    a = a ^ (a >> 16)
    b = b ^ (b >> 16)
    c = c ^ (c >> 16)
    a = (a + _mul32(b, c)) & M32
    b = (b + _mul32(c, a)) & M32
    c = (c + _mul32(a, b)) & M32
    return a, b, c


def u32_to_uniform(bits):
    """Top 24 bits -> f32 uniform in [0, 1) (the f32-mantissa-exact form)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
