"""The wavefront sample's PCG3D draws on the card: kernel D (csrc/draws.cu),
one launch for a range of draw slots of every lane, the lane's key fold
included.

The kernel replaces no TPU kernel: the JAX package leaves the draws to XLA,
which fuses them. Run eagerly on the card, ``fold_in`` and
``render/pathtracer.py``'s ``Pcg3dDraws`` were about 70 int64 elementwise
kernels a sample; kernel D hashes in native uint32 in registers and writes
each slot's float32 once. Its outputs equal ``fold_in`` → ``Pcg3dDraws``
bit for bit. Its plain twin, ``draws_twin``, computes the same slots in
wrapping int32 tensor arithmetic, as the kernel does in uint32; the CPU
and the table draws keep ``fold_in`` → ``Pcg3dDraws`` / ``draw_table``
(``draws_kernel_applies``).
"""

from __future__ import annotations

import ctypes

import torch

from voxelrt_torch.ops import _cuda, prng
from voxelrt_torch.utils import profiling

SALT = 0x9E3779B9  # a triple's salt is SALT * (triple + 1) mod 2**32


def draws_kernel_applies(cfg, device) -> bool:
    """Whether ``trace_sample`` takes its draws from kernel D: on CUDA with
    the PCG3D draws, on every route of the sample."""
    return torch.device(device).type == "cuda" and cfg.rng_draws == "pcg3d"


def _key_words(sample_keys, n, device):
    """The sample keys as two int64 tensors of the n lanes and True, or as
    two python ints and False where one key serves every lane."""
    if not any(isinstance(k, torch.Tensor) for k in sample_keys):
        return [int(k) & prng.M32 for k in sample_keys], False
    return [torch.as_tensor(k, dtype=torch.int64, device=device).expand(n)
            .contiguous() for k in sample_keys], True


# --- the plain twin -----------------------------------------------------------

def _shr(x, d):
    """Logical right shift of int32 tensors holding u32 bits."""
    return (x >> d) & ((1 << (32 - d)) - 1)


def _pcg3d_i32(a, b, c):
    a = a * 1664525 + 1013904223
    b = b * 1664525 + 1013904223
    c = c * 1664525 + 1013904223
    a = a + b * c
    b = b + c * a
    c = c + a * b
    a = a ^ _shr(a, 16)
    b = b ^ _shr(b, 16)
    c = c ^ _shr(c, 16)
    a = a + b * c
    b = b + c * a
    c = c + a * b
    return a, b, c


def draws_twin(u, v, sample_keys, height, lo, k):
    """Slots [lo, lo + k) of every lane as a (k, n) float32 tensor, in
    wrapping int32 arithmetic as csrc/draws.cu computes them in uint32:
    the lane's pixel id u * height + v, its key folded by Threefry-2x32,
    then each slot's PCG3D triple and its top 24 bits."""
    dev = u.device
    n = u.shape[0]
    pid = (u.to(torch.int64) * height + v.to(torch.int64)).to(torch.int32)
    keys, _ = _key_words(sample_keys, n, dev)
    kd0, kd1 = prng._threefry_i32(*(prng._i32(w, dev) for w in keys), pid)
    rows, trip = [], {}
    for s in range(lo, lo + k):
        t, c = divmod(s, 3)
        if t not in trip:
            salt = prng._i32(SALT * (t + 1), dev)
            trip[t] = _pcg3d_i32(kd0, kd1, salt.expand(n))
        rows.append(_shr(trip[t][c], 8).to(torch.float32) * (1.0 / (1 << 24)))
    return torch.stack(rows)


# --- the kernel ---------------------------------------------------------------

def _draws_fn():
    lib = _cuda.lib("draws")
    if lib.pcg3d_draws.argtypes is None:
        p = ctypes.c_void_p
        lib.pcg3d_draws.argtypes = [p, p, p, p, ctypes.c_uint, ctypes.c_uint,
                                    ctypes.c_longlong, ctypes.c_int,
                                    ctypes.c_int, p, ctypes.c_longlong, p]
        lib.pcg3d_draws.restype = ctypes.c_int
    return lib.pcg3d_draws


def pcg3d_draws(u, v, sample_keys, height, lo, k):
    """One launch of kernel D: slots [lo, lo + k) of the lanes at pixels
    (u, v) (float32, as ``trace_sample`` gets them) under their sample keys
    ``sample_keys`` = (k0, k1) (int64 tensors of the lanes, or python ints
    for one key), as a (k, n) float32 tensor on the lanes' device whose row
    j is slot lo + j: ``fold_in(sample_keys, u * height + v)`` then
    ``Pcg3dDraws``, bit for bit."""
    dev = u.device
    n = u.shape[0]
    u, v = u.contiguous(), v.contiguous()
    _cuda.require(u, "u", torch.float32, dev, (n,))
    _cuda.require(v, "v", torch.float32, dev, (n,))
    keys, lane_keys = _key_words(sample_keys, n, dev)
    out = torch.empty((k, n), dtype=torch.float32, device=dev)
    ptrs = [w.data_ptr() if lane_keys else None for w in keys]
    scal = [0, 0] if lane_keys else keys
    err = _draws_fn()(u.data_ptr(), v.data_ptr(), *ptrs, *scal, int(height),
                      int(lo), int(k), out.data_ptr(), n,
                      _cuda.stream_ptr(dev))
    _cuda.check(err, "draws")
    if n and k:
        _cuda.LAUNCHES["draws"] += 1
    profiling.count("draws.lanes", n, slots=k, lane_keys=lane_keys)
    return out
