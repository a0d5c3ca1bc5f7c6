"""Temporal-resample kernel B4 — the camera-motion reprojection hot path, the
PyTorch/CUDA port of voxelrt/ops/resample.py.

While the camera moves, every output pixel fetches a 2×2 (bilinear) or 4×4
(Catmull-Rom) history neighbourhood plus validity-gate buffers through the
previous frame's matrices (renderer/pathtracer.py:1077-1183). One call
fuses, per pass (diffuse or specular):
  * the current-colour bilinear upsample (renderer/pathtracer.py:1077-1090),
  * the gated history tap filter with anti-ringing clamp
    (renderer/pathtracer.py:1092-1183) — normal gate, optional depth gate,
    optional extra scalar buffer (specular reflection depth).

The ACTIVE-RES source buffers are bf16-packed int32 words (≈0.4% relative):
they only shape the TRANSIENT motion-phase image — the history weight caps
at 50 while moving and accumulation restarts on stop, so converged stills
never see them. Depth buffers stay f32 (the 5% relative gate compares them
directly).

``temporal_taps`` sends CPU tensors to its plain PyTorch twin
``temporal_taps_plain`` and launches the CUDA kernel (csrc/resample.cu) on
CUDA tensors; there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from voxelrt_torch.ops import _cuda

# Texels per source table above which callers take the f32 gather path
# (render/temporal._moving_taps). The JAX package sets it from its kernel's
# fast-memory budget; the port keeps the number so that one config takes the
# same branch in both packages (the two branches differ by the bf16
# quantisation of the sources).
MAX_TEXELS = 530_000


def _bf16_bits(x):
    """f32 -> bf16 bits (round-to-nearest-even), as int32 in [0, 0xFFFF].
    int32 arithmetic wraps, as in the JAX package."""
    b = x.to(torch.float32).contiguous().view(torch.int32)
    rne = ((b >> 16) & 1) + 0x7FFF
    return ((b + rne) >> 16) & 0xFFFF


def pack2_bf16(a, b):
    """Two f32 planes -> one int32 plane holding bf16(a) << 16 | bf16(b)."""
    return (_bf16_bits(a) << 16) | _bf16_bits(b)


def _unpack_hi(w):
    return (w & -65536).view(torch.float32)


def _unpack_lo(w):
    return (w << 16).view(torch.float32)


def _catmullrom(x):
    """renderer/pathtracer.py:1002-1014."""
    x2 = x * x
    x3 = x2 * x
    f1 = 1.5 * x3 - 2.5 * x2 + 1.0
    f2 = -0.5 * x3 + 2.5 * x2 - 4.0 * x + 2.0
    return torch.where(x < 1.0, f1, torch.where(x < 2.0, f2, 0.0))


def _decode_oct(w):
    """Octahedral normal from a pack2_bf16(e0, e1) word
    (ops/packing.decode_unit_vector_3x16, renderer/math_utils.py:209-215)."""
    ex = _unpack_hi(w) * 2.0 - 1.0
    ey = _unpack_lo(w) * 2.0 - 1.0
    z = 1.0 - torch.abs(ex) - torch.abs(ey)
    t = torch.clamp(-z, min=0.0)
    x = ex + torch.where(ex >= 0.0, -t, t)
    y = ey + torch.where(ey >= 0.0, -t, t)
    inv = torch.rsqrt(torch.clamp(x * x + y * y + z * z, min=1e-20))
    return x * inv, y * inv, z * inv


def _clip(v, lo, hi):
    """min(max(v, lo), hi): where lo > hi the result is hi, as jnp.clip."""
    return torch.minimum(torch.maximum(v, lo), hi)


def temporal_taps_plain(cur_packed, hist_packed, pn_packed, pd_lin, extra,
                        fxc, fyc, fxh, fyh, center_depth, center_normal,
                        ires_x: int, ires_y: int, catmullrom: bool,
                        gate_depth: bool):
    """Plain twin of B4: the CUDA kernel's arithmetic in the same order (see
    ``temporal_taps`` for the arguments and the result)."""
    stride = ires_y
    with_extra = extra is not None

    # --- current-colour bilinear (renderer/pathtracer.py:1077-1090)
    ixc = torch.floor(fxc)
    iyc = torch.floor(fyc)
    gx = fxc - ixc
    gy = fyc - iyc
    ixi = ixc.to(torch.int64)
    iyi = iyc.to(torch.int64)
    acc = [torch.zeros_like(fxc) for _ in range(3)]
    for cx, cy in ((0, 0), (1, 0), (0, 1), (1, 1)):
        wx = gx if cx else 1.0 - gx
        wy = gy if cy else 1.0 - gy
        w = wx * wy
        ax = torch.clamp(ixi + cx, 0, ires_x - 1)
        ay = torch.clamp(iyi + cy, 0, ires_y - 1)
        t = ax * stride + ay
        c0, c1 = cur_packed[0][t], cur_packed[1][t]
        acc[0] = acc[0] + w * _unpack_hi(c0)
        acc[1] = acc[1] + w * _unpack_lo(c0)
        acc[2] = acc[2] + w * _unpack_hi(c1)
    current = torch.stack(acc, dim=-1)

    # --- gated history taps (renderer/pathtracer.py:1092-1183). The
    # reprojection can land anywhere (NaN for sky): keep indices sane;
    # out-of-bounds taps get zero weight below.
    fxh = torch.clamp(torch.where(torch.isfinite(fxh), fxh, -9.0), -9.0, 1.0e6)
    fyh = torch.clamp(torch.where(torch.isfinite(fyh), fyh, -9.0), -9.0, 1.0e6)
    ix = torch.floor(fxh).to(torch.int64)
    iy = torch.floor(fyh).to(torch.int64)
    fx = fxh - ix.to(torch.float32)
    fy = fyh - iy.to(torch.float32)
    cd = center_depth
    cn0, cn1, cn2 = (center_normal[:, 0], center_normal[:, 1],
                     center_normal[:, 2])

    def full(v):
        return torch.full_like(fxh, v)

    col_sum = [full(0.0) for _ in range(4)]
    col_min = [full(999999.0) for _ in range(4)]
    col_max = [full(0.0) for _ in range(4)]
    e_sum, e_min, e_max = full(0.0), full(999999.0), full(0.0)
    w_sum = full(0.0)

    def tap_w(o, f):
        d = torch.abs(o - f)
        if catmullrom:
            return _catmullrom(d)
        return torch.clamp(1.0 - d, min=0.0)

    taps = range(-1, 3) if catmullrom else range(0, 2)
    for ox in taps:
        wgx = tap_w(ox, fx)
        for oy in taps:
            wgt = wgx * tap_w(oy, fy)
            tx = ix + ox
            ty = iy + oy
            inb = (tx >= 0) & (tx < ires_x) & (ty >= 0) & (ty < ires_y)
            t = (torch.clamp(tx, 0, ires_x - 1) * stride
                 + torch.clamp(ty, 0, ires_y - 1))
            nx, ny, nz = _decode_oct(pn_packed[t])
            ok_n = (cn0 * nx + cn1 * ny + cn2 * nz) > 0.642
            wgt = wgt * ok_n.to(torch.float32)
            if gate_depth:
                ok_d = (torch.abs(pd_lin[t] - cd)
                        / torch.clamp(torch.abs(cd), min=1e-20)) < 0.05
                wgt = wgt * ok_d.to(torch.float32)
            wgt = wgt * inb.to(torch.float32)

            h0, h1 = hist_packed[0][t], hist_packed[1][t]
            c = (_unpack_hi(h0), _unpack_lo(h0), _unpack_hi(h1),
                 _unpack_lo(h1))
            for i in range(4):
                col_min[i] = torch.where(
                    inb, torch.minimum(col_min[i], c[i]), col_min[i])
                col_max[i] = torch.where(
                    inb, torch.maximum(col_max[i], c[i]), col_max[i])
                col_sum[i] = col_sum[i] + c[i] * wgt
            if with_extra:
                ex = extra[t]
                e_min = torch.where(inb, torch.minimum(e_min, ex), e_min)
                e_max = torch.where(inb, torch.maximum(e_max, ex), e_max)
                e_sum = e_sum + ex * wgt
            w_sum = w_sum + wgt

    safe_w = torch.where(torch.abs(w_sum) < 1e-20, 1e-20, w_sum)
    floor = (0.0, 0.0, 0.0, 1.0)
    hist = torch.stack(
        [torch.clamp(_clip(col_sum[i] / safe_w, col_min[i], col_max[i]),
                     min=floor[i]) for i in range(4)], dim=-1)
    extra_f = _clip(e_sum / safe_w, e_min, e_max) if with_extra else None
    return current, w_sum, hist, extra_f


def temporal_taps(cur_packed, hist_packed, pn_packed, pd_lin, extra,
                  fxc, fyc, fxh, fyh, center_depth, center_normal,
                  ires_x: int, ires_y: int, catmullrom: bool,
                  gate_depth: bool):
    """Fused motion-phase resample (see module docstring).

    Source tables (flat over the active region, index x*ires_y + y, one
    int32 / f32 word per texel, n = ires_x*ires_y):
      cur_packed:  (2, n) int32 — pack2(curR, curG), pack2(curB, 0)
      hist_packed: (2, n) int32 — pack2(histR, histG), pack2(histB, histW)
      pn_packed:   (n,) int32 — pack2(oct_e0, oct_e1) of the prev normals
      pd_lin:      (n,) f32 linearized prev depth (read when gate_depth)
      extra:       (n,) f32 (or None) — specular reflection-depth history
    Per-output-pixel (flat (m,)): fxc/fyc current-tap coords, fxh/fyh
    reprojected history coords, center_depth (linear), center_normal (m, 3).
    Returns (current_rgb (m,3), w_sum (m,), hist_rgba (m,4), extra_f (m,)
    or None)."""
    dev = fxc.device
    args = (cur_packed, hist_packed, pn_packed, pd_lin, extra, fxc, fyc, fxh,
            fyh, center_depth, center_normal, ires_x, ires_y, catmullrom,
            gate_depth)
    if dev.type == "cpu":
        return temporal_taps_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = ires_x * ires_y
    m = fxc.shape[0]
    with_extra = extra is not None
    if gate_depth and pd_lin is None:
        raise ValueError("gate_depth needs pd_lin")
    _cuda.require(cur_packed, "cur_packed", torch.int32, dev, (2, n))
    _cuda.require(hist_packed, "hist_packed", torch.int32, dev, (2, n))
    _cuda.require(pn_packed, "pn_packed", torch.int32, dev, (n,))
    if gate_depth:
        _cuda.require(pd_lin, "pd_lin", torch.float32, dev, (n,))
    if with_extra:
        _cuda.require(extra, "extra", torch.float32, dev, (n,))
    for name, t in (("fxc", fxc), ("fyc", fyc), ("fxh", fxh), ("fyh", fyh),
                    ("center_depth", center_depth)):
        _cuda.require(t, name, torch.float32, dev, (m,))
    _cuda.require(center_normal, "center_normal", torch.float32, dev, (m, 3))
    current = torch.empty((m, 3), dtype=torch.float32, device=dev)
    w_sum = torch.empty((m,), dtype=torch.float32, device=dev)
    hist = torch.empty((m, 4), dtype=torch.float32, device=dev)
    extra_f = torch.empty((m,), dtype=torch.float32, device=dev) \
        if with_extra else None
    fn = _cuda.lib("resample").temporal_taps
    fn.argtypes = ([ctypes.c_void_p] * 17 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _cuda.check(fn(
        cur_packed[0].data_ptr(), cur_packed[1].data_ptr(),
        hist_packed[0].data_ptr(), hist_packed[1].data_ptr(),
        pn_packed.data_ptr(),
        pd_lin.data_ptr() if gate_depth else None,
        extra.data_ptr() if with_extra else None,
        fxc.data_ptr(), fyc.data_ptr(), fxh.data_ptr(), fyh.data_ptr(),
        center_depth.data_ptr(), center_normal.data_ptr(),
        current.data_ptr(), w_sum.data_ptr(), hist.data_ptr(),
        extra_f.data_ptr() if with_extra else None,
        m, ires_x, ires_y, int(bool(catmullrom)), int(bool(gate_depth)),
        int(with_extra), _cuda.stream_ptr(dev)), "temporal_taps")
    _cuda.LAUNCHES["temporal_taps"] += 1
    return current, w_sum, hist, extra_f
