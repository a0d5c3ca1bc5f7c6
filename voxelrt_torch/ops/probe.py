"""Loop-construct probe: kernel P, the port's counterpart of the TPU probe
``tools/pallas_probe.py:kern``.

Per (8, 128) block of float32 lanes, a loop of ``iters`` iterations over 8
float carries (``c[k] = x + k``, each ``+ 1`` per iteration) and one int32
accumulator, with one construct per variant inside the loop (see
``VARIANTS`` and csrc/probe.cu). ``out = c[0] + float(acc)`` is what the TPU
kernel returns; ``aux`` = the sum of carries 1-7 plus the float of each
lane's own sum of gathered table words, which the TPU kernel computes on
every lane and drops: returning it keeps that work observable and checked.

``probe`` sends CPU tensors to the plain PyTorch version and launches the
CUDA kernel on CUDA tensors; there is no fallback from one to the other.
``tools/cuda_probe.py`` times it.
"""

from __future__ import annotations

import ctypes

import torch

from voxelrt_torch.ops import _cuda

VARIANTS = ("base", "orred", "ctz", "reduce", "reduce2", "rolls", "gather",
            "fetch", "cond", "alu20")
BLOCK = (8, 128)
TABLE = (256, 128)


def gather_1024(slab, word_idx):
    """Words of a flat 1024-word slab at ``word_idx``, with the index the TPU
    kernel's roll-trick gather computes (dda_pallas.py ``_gather_1024``):
    row (w >> 7) & 7, lane w & 127."""
    return slab[(((word_idx >> 7) & 7) << 7) + (word_idx & 127)]


def _wrap32(v):
    """int64 tensor -> the int32 value its low 32 bits hold (still int64)."""
    v = v & 0xFFFFFFFF
    return v - ((v >> 31) << 32)


def _ctz_steps(i: int) -> int:
    """The probe's binary-search count of trailing zeros (31 for 0)."""
    low = i & (-i)
    g = 0
    for width, mask in ((16, 0xFFFF), (8, 0xFF), (4, 0xF), (2, 3)):
        t = (low & mask) == 0
        g += width if t else 0
        low = (low >> width) & mask if t else low & mask
    return g + (1 if (low & 1) == 0 else 0)


def probe_plain(x, tab, variant: str, iters: int):
    """Plain PyTorch version of P. x: (NB, 8, 128) f32; tab: (256, 128)
    int32. Returns (out, aux), both (NB, 8, 128) f32."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    nb = x.shape[0]
    flat = tab.reshape(-1).to(torch.int64)
    c = [x + float(k) for k in range(8)]
    idx = x.to(torch.int64) & 1023
    acc = torch.zeros((nb, 1, 1), dtype=torch.int64, device=x.device)
    lane_sum = torch.zeros_like(idx)

    def over_block(t, how):
        r = t.reshape(nb, -1)
        if how == "or":
            while r.shape[1] > 1:  # 1024 lanes: ten halvings
                half = r.shape[1] // 2
                r = r[:, :half] | r[:, half:]
            out = r[:, 0]
        elif how == "sum":
            out = r.sum(1)
        else:
            out = r.max(1).values
        return out.reshape(nb, 1, 1)

    for i in range(iters):
        if variant == "orred":
            bits = torch.ones_like(idx) << (c[0].to(torch.int64) & 31)
            acc = acc + _wrap32(over_block(bits, "or"))
        elif variant == "ctz":
            acc = acc + _ctz_steps(i)
        elif variant in ("reduce", "reduce2"):
            acc = acc + over_block(c[0].to(torch.int64), "sum")
            if variant == "reduce2":
                acc = acc + over_block(c[1].to(torch.int64), "max")
        elif variant == "rolls":
            acc = acc + over_block(c[0].to(torch.int64), "or")
        elif variant == "gather":
            w = gather_1024(flat[:1024], idx + i)
            lane_sum = lane_sum + w
            acc = acc + w[:, :1, :1]
        elif variant == "fetch":
            slab = flat[(i & 31) * 1024:(i & 31) * 1024 + 1024]
            w = gather_1024(slab, idx) + gather_1024(slab, idx + 1)
            lane_sum = lane_sum + w
            acc = acc + w[:, :1, :1]
        elif variant == "cond":
            if (i & 1) == 0:
                acc = acc + 1
        elif variant == "alu20":
            v = c[0]
            for _ in range(10):
                v = v * 1.0001 + 0.001
            c[0] = v
        c = [ck + 1.0 for ck in c]
    out = c[0] + _wrap32(acc).to(torch.float32)
    rest = c[1]
    for k in range(2, 8):
        rest = rest + c[k]
    return out, rest + _wrap32(lane_sum).to(torch.float32)


def probe(x, tab, variant: str, iters: int):
    """Run P: x (NB, 8, 128) f32, tab (256, 128) int32, ``variant`` one of
    VARIANTS, ``iters`` loop iterations. Returns (out, aux), (NB, 8, 128)
    f32 each."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    dev = x.device
    if dev.type == "cpu":
        return probe_plain(x, tab, variant, iters)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    nb = x.shape[0]
    _cuda.require(x, "x", torch.float32, dev, (nb,) + BLOCK)
    _cuda.require(tab, "tab", torch.int32, dev, TABLE)
    out = torch.empty_like(x)
    aux = torch.empty_like(x)
    fn = _cuda.lib("probe").probe
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _cuda.check(fn(x.data_ptr(), tab.data_ptr(), out.data_ptr(),
                   aux.data_ptr(), VARIANTS.index(variant), int(iters), nb,
                   _cuda.stream_ptr(dev)), f"probe[{variant}]")
    _cuda.LAUNCHES["probe"] += 1
    return out, aux
