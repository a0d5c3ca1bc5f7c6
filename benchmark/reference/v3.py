"""A frozen copy of the port's ``voxelrt_torch/ops/v3.py``, taken when
the benchmark was defined, less what the plain reference does not call.

SoA 3-vectors: a V3 is three separate (N,) component tensors (the PyTorch
port of voxelrt/ops/v3.py).

The render path carries every per-ray 3-vector as a V3 and converts to
packed (N, 3) tensors only at module boundaries (images, tests), as the JAX
package does. Keeping the same layout keeps each formula's operation order,
so the port's float32 results track the reference's.

Binary operators accept another V3 or a per-ray scalar (a python number, a
0-d tensor or a tensor shaped like the components). Against (N,) components
they reject rank-2 operands, which would broadcast an (N, 1) into (N, N);
components of rank 0 or of rank 2 and more (the sky precompute's batched
lanes) broadcast as tensors do.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch


def _coerce(other, ref=None):
    if isinstance(other, V3):
        return other.x, other.y, other.z
    if (isinstance(other, torch.Tensor) and other.dim() > 1
            and isinstance(ref, torch.Tensor) and ref.dim() == 1):
        raise TypeError(
            f"V3 binary op with rank-{other.dim()} operand (shape "
            f"{tuple(other.shape)}): per-ray scalars must be rank<=1")
    return other, other, other


class V3(NamedTuple):
    """Three same-shaped component tensors (or python/0-d scalars)."""

    x: Any
    y: Any
    z: Any

    def __add__(self, o):
        ox, oy, oz = _coerce(o, self.x)
        return V3(self.x + ox, self.y + oy, self.z + oz)

    def __radd__(self, o):
        ox, oy, oz = _coerce(o, self.x)
        return V3(ox + self.x, oy + self.y, oz + self.z)

    def __sub__(self, o):
        ox, oy, oz = _coerce(o, self.x)
        return V3(self.x - ox, self.y - oy, self.z - oz)

    def __rsub__(self, o):
        ox, oy, oz = _coerce(o, self.x)
        return V3(ox - self.x, oy - self.y, oz - self.z)

    def __mul__(self, o):
        ox, oy, oz = _coerce(o, self.x)
        return V3(self.x * ox, self.y * oy, self.z * oz)

    def __rmul__(self, o):
        ox, oy, oz = _coerce(o, self.x)
        return V3(ox * self.x, oy * self.y, oz * self.z)

    def __truediv__(self, o):
        ox, oy, oz = _coerce(o, self.x)
        return V3(self.x / ox, self.y / oy, self.z / oz)

    def __rtruediv__(self, o):
        ox, oy, oz = _coerce(o, self.x)
        return V3(ox / self.x, oy / self.y, oz / self.z)

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    @property
    def shape(self):
        return self.x.shape


def load(a) -> V3:
    """Packed (..., 3) tensor -> V3."""
    if isinstance(a, V3):
        return a
    return V3(a[..., 0], a[..., 1], a[..., 2])


def stack(v: V3, dim: int = -1):
    """V3 -> packed tensor (module boundary only)."""
    if not isinstance(v, V3):
        return v
    return torch.stack([v.x, v.y, v.z], dim=dim)


def splat(c, device=None) -> V3:
    """(3,)-like constant -> V3 of 0-d float32 tensors."""
    if isinstance(c, V3):
        return c
    a = torch.as_tensor(c, dtype=torch.float32, device=device)
    return V3(a[0], a[1], a[2])


def full(n, value, device) -> V3:
    f = torch.full((n,), value, dtype=torch.float32, device=device)
    return V3(f, f, f)


def zeros(n, device) -> V3:
    return full(n, 0.0, device)


def ones(n, device) -> V3:
    return full(n, 1.0, device)


def broadcast(v: V3, n) -> V3:
    """V3 of scalars -> V3 of (n,) components."""
    return V3(*(torch.as_tensor(c).expand(n) for c in v))


def map1(f, a: V3) -> V3:
    return V3(f(a.x), f(a.y), f(a.z))


def vdot(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def vcross(a: V3, b: V3) -> V3:
    return V3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def vnormalize(v: V3, eps: float = 1e-20) -> V3:
    return v * torch.rsqrt(torch.clamp(vdot(v, v), min=eps))


def _where(m, a, b):
    if not isinstance(a, torch.Tensor) and not isinstance(b, torch.Tensor):
        a = torch.full((), a, dtype=torch.float32, device=m.device)
    return torch.where(m, a, b)


def vwhere(m, a, b) -> V3:
    """Per-ray mask select between V3/scalar operands."""
    ax, ay, az = _coerce(a)
    bx, by, bz = _coerce(b)
    return V3(_where(m, ax, bx), _where(m, ay, by), _where(m, az, bz))


def vclip(v: V3, lo, hi) -> V3:
    return map1(lambda c: torch.clamp(c, lo, hi), v)


def any_nonzero(v: V3):
    return (v.x != 0.0) | (v.y != 0.0) | (v.z != 0.0)
