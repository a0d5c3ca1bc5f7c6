"""A frozen copy of the port's ``voxelrt_torch/ops/prng.py``, taken when
the benchmark was defined, less what the plain reference does not call.

Counter-based random numbers, bit-exact with the JAX package's streams.

The JAX package derives every random number from ``jax.random`` keys:
``fold_in`` (Threefry-2x32) per launch, per sample and per pixel, one
``uniform`` pair per sample for the TAA jitter, and PCG3D draw slots hashed
from the per-pixel key words. This module reproduces those bits with integer
arithmetic on python ints or int64 tensors holding u32 values (``& M32``
after every add and shift), so the same code runs on the CPU and the GPU.

A key is a pair ``(k0, k1)`` of u32 values: python ints for launch and sample
keys, int64 tensors for per-pixel keys. ``key(seed)`` matches
``jax.random.PRNGKey(seed)`` for seeds in [0, 2**32).

``uniform`` matches ``jax.random.uniform`` as JAX 0.9 lays its bits out with
``jax_threefry_partitionable=True`` (the default there): the counter of
element i (its row-major index in the requested shape) is the 64-bit value i
split into (hi, lo) words, and the 32 random bits are the XOR of Threefry's
two output words. ``uniform`` draws a tensor of any shape on a device, for one
key or for a batch of keys at once, in wrapping int32 arithmetic (half the
bytes of the int64 form: the sky precompute draws over a hundred million
numbers per call).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d):
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds (jax/_src/prng.py's lowering)."""
    ks = (k0, k1, (k0 ^ k1 ^ 0x1BD11BDA) & M32)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def key(seed: int):
    """``jax.random.PRNGKey(seed)`` as a (k0, k1) pair."""
    seed = int(seed)
    return ((seed >> 32) & M32, seed & M32)


def fold_in(k, data):
    """``jax.random.fold_in(k, data)``: Threefry of the counter pair
    (0, data) under key k. ``data`` is an int or an int tensor (taken as
    u32); the result has data's shape."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & M32
        zero = torch.zeros_like(data)
    else:
        data = int(data) & M32
        zero = 0
    return threefry2x32(k[0], k[1], zero, data)


def _i32(v, device):
    """A u32 value (python int, or int64 tensor of any shape) as an int32
    tensor with the same bits."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int32)
    v = int(v) & M32
    return torch.tensor(v - ((v >> 31) << 32), dtype=torch.int32,
                        device=device)


def _rotl_i32(x, d):
    return (x << d) | ((x >> (32 - d)) & ((1 << d) - 1))


def _threefry_i32(k0, k1, x1):
    """Threefry-2x32 of the counter pair (0, x1) in wrapping int32 tensor
    arithmetic; ``x1`` is consumed."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = ks[0].expand(x1.shape).clone()
    x1 += ks[1]
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 += x1
            x1 = _rotl_i32(x1, r)
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x1 += ks[(i + 2) % 3] + (i + 1)
    return x0, x1


def uniform(k, shape, device, offset=0):
    """``jax.random.uniform(k, shape)`` in float32, as a tensor on
    ``device``. The key entries are python ints or int64 tensors of one
    common shape B (a batch of keys, as ``fold_in`` of a tensor returns
    them); the result has shape B + shape, each key drawing what it would
    draw alone. ``offset`` starts the counters there: ``uniform(k, n, d,
    offset=a)`` is ``uniform(k, a + n, d)[a:]`` bit for bit, which is how a
    block of an image draws its own pixels' numbers."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = 1
    for s in shape:
        n *= int(s)
    if offset + n >= 1 << 32:
        raise ValueError("uniform: more than 2**32 draws per key")
    k0, k1 = _i32(k[0], device), _i32(k[1], device)
    batch = tuple(torch.broadcast_shapes(k0.shape, k1.shape))
    # arange in int64, then the wrapping cast: counters from 2**31 on keep
    # their bits
    idx = torch.arange(offset, offset + n, dtype=torch.int64,
                       device=device).to(torch.int32)
    x1 = idx.expand(batch + (n,)).clone()
    y0, y1 = _threefry_i32(k0[..., None], k1[..., None], x1)
    y0 ^= y1
    bits = ((y0 >> 9) & 0x7FFFFF) | 0x3F800000
    return (bits.view(torch.float32) - 1.0).reshape(batch + shape)
