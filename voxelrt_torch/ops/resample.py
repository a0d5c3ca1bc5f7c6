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

The JAX package packs the ACTIVE-RES sources into bf16 words (≈0.4%
relative) before its kernel: they only shape the TRANSIENT motion-phase
image — the history weight caps at 50 while moving and accumulation
restarts on stop, so converged stills never see them. Depth buffers stay f32
(the 5% relative gate compares them directly). Here the caller passes the
frame buffers' active-region views as they are; the CUDA kernel rounds each
value to bf16 as it loads it and the twin packs with ``pack2_bf16``, so both
use the JAX package's packed values.

``temporal_taps`` sends CPU tensors to its plain PyTorch twin
``temporal_taps_plain`` and launches the CUDA kernel (csrc/resample.cu) on
CUDA tensors; there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from voxelrt_torch.ops import _cuda
from voxelrt_torch.ops.transforms import linearize_depth

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


def _pack_sources(cur, hist, normals, depth, proj_inv, extra, gate_depth):
    """The source views as the TPU kernel's flat tables (index x*ah + y):
    bf16-packed colour, history and normal words, the linearised depth and
    the extra scalar."""
    cur_packed = torch.stack([
        pack2_bf16(cur[..., 0], cur[..., 1]),
        pack2_bf16(cur[..., 2], torch.zeros_like(cur[..., 2])),
    ]).reshape(2, -1)
    hist_packed = torch.stack([
        pack2_bf16(hist[..., 0], hist[..., 1]),
        pack2_bf16(hist[..., 2], hist[..., 3]),
    ]).reshape(2, -1)
    pn_packed = pack2_bf16(normals[..., 0].to(torch.float32),
                           normals[..., 1].to(torch.float32)).reshape(-1)
    pd_lin = (linearize_depth(depth, proj_inv).reshape(-1) if gate_depth
              else None)
    ex = extra.reshape(-1) if extra is not None else None
    return cur_packed, hist_packed, pn_packed, pd_lin, ex


def temporal_taps_plain(cur, hist, normals, depth, proj_inv, extra,
                        texcoord, rp, center_depth, center_normal,
                        catmullrom: bool, gate_depth: bool):
    """Plain twin of B4: the sources packed as the JAX package packs them,
    then the CUDA kernel's arithmetic in the same order (see
    ``temporal_taps`` for the arguments and the result)."""
    ires_x, ires_y = cur.shape[0], cur.shape[1]
    w, h = texcoord.shape[0], texcoord.shape[1]
    stride = ires_y
    cur_packed, hist_packed, pn_packed, pd_lin, extra = _pack_sources(
        cur, hist, normals, depth, proj_inv, extra, gate_depth)
    with_extra = extra is not None
    fxc = (texcoord[..., 0] * ires_x - 0.5).reshape(-1)
    fyc = (texcoord[..., 1] * ires_y - 0.5).reshape(-1)
    fxh = (rp[..., 0] * ires_x - 0.5).reshape(-1)
    fyh = (rp[..., 1] * ires_y - 0.5).reshape(-1)

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
        wc = wx * wy
        ax = torch.clamp(ixi + cx, 0, ires_x - 1)
        ay = torch.clamp(iyi + cy, 0, ires_y - 1)
        t = ax * stride + ay
        c0, c1 = cur_packed[0][t], cur_packed[1][t]
        acc[0] = acc[0] + wc * _unpack_hi(c0)
        acc[1] = acc[1] + wc * _unpack_lo(c0)
        acc[2] = acc[2] + wc * _unpack_hi(c1)
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
    cd = center_depth.reshape(-1)
    cn = center_normal.reshape(-1, 3)
    cn0, cn1, cn2 = cn[:, 0], cn[:, 1], cn[:, 2]

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
    hist_f = torch.stack(
        [torch.clamp(_clip(col_sum[i] / safe_w, col_min[i], col_max[i]),
                     min=floor[i]) for i in range(4)], dim=-1)
    extra_f = (_clip(e_sum / safe_w, e_min, e_max).reshape(w, h)
               if with_extra else None)
    return (current.reshape(w, h, 3), w_sum.reshape(w, h),
            hist_f.reshape(w, h, 4), extra_f)


@functools.cache
def _entry():
    """The kernel's C entry point, its argument types set once."""
    fn = _cuda.lib("resample").temporal_taps
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong] * 5
                   + [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _source(t, name, dtype, dev, shape, align):
    """Check one source view (device, dtype, shape, a texel's values
    contiguous, y stride one texel, pointer alignment in bytes) and return
    its row stride in elements."""
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected {dtype} {shape} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    inner = (shape[2], 1) if len(shape) == 3 else (1,)
    if (t.stride()[1:] != inner or t.data_ptr() % align
            or t.stride(0) * t.element_size() % align):
        raise ValueError(f"{name}: texels must be contiguous along y and "
                         f"{align}-byte aligned, strides {t.stride()}")
    return t.stride(0)


def temporal_taps(cur, hist, normals, depth, proj_inv, extra,
                  texcoord, rp, center_depth, center_normal,
                  catmullrom: bool, gate_depth: bool, counts=None):
    """Fused motion-phase resample (see module docstring).

    Sources, views of the active aw x ah region of the frame buffers (any
    row stride; a texel's values contiguous, y stride one texel):
      cur:      (aw, ah, 3) f32 current colour
      hist:     (aw, ah, 4) f32 history (16-byte aligned on the card)
      normals:  (aw, ah, 2) f16 octahedral previous normals
      depth:    (aw, ah) f32 previous non-linear depth, read when
                ``gate_depth``, linearised with ``proj_inv`` (4, 4) f32
      extra:    (aw, ah) f32 or None, the specular reflection-depth history
    Per output pixel, contiguous (w, h, ...): texcoord (w, h, 2), the
    reprojected position rp (w, h, 3) (x and y are read), center_depth
    (w, h) linear, center_normal (w, h, 3).
    Colour, history and normals are used at bf16 precision, as the JAX
    package packs them. Returns (current (w, h, 3), w_sum (w, h),
    hist (w, h, 4), extra_f (w, h) or None). ``counts``, on the card only:
    an int32 (4,) tensor to which the kernel adds its blocks, those whose
    history box did not fit in shared memory, the lanes that gathered their
    history taps from global memory, and the texels it staged."""
    args = (cur, hist, normals, depth, proj_inv, extra, texcoord, rp,
            center_depth, center_normal, catmullrom, gate_depth)
    dev = texcoord.device
    if dev.type == "cpu":
        return temporal_taps_plain(*args)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    aw, ah = cur.shape[0], cur.shape[1]
    w, h = texcoord.shape[0], texcoord.shape[1]
    with_extra = extra is not None
    f32 = torch.float32
    rs = [_source(cur, "cur", f32, dev, (aw, ah, 3), 4),
          _source(hist, "hist", f32, dev, (aw, ah, 4), 16),
          _source(normals, "normals", torch.float16, dev, (aw, ah, 2), 4),
          0, 0]
    if gate_depth:
        rs[3] = _source(depth, "depth", f32, dev, (aw, ah), 4)
        _cuda.require(proj_inv, "proj_inv", f32, dev, (4, 4))
    if with_extra:
        rs[4] = _source(extra, "extra", f32, dev, (aw, ah), 4)
    for name, t, c in (("texcoord", texcoord, (2,)), ("rp", rp, (3,)),
                       ("center_depth", center_depth, ()),
                       ("center_normal", center_normal, (3,))):
        _cuda.require(t, name, f32, dev, (w, h) + c)
    if counts is not None:
        _cuda.require(counts, "counts", torch.int32, dev, (4,))
    current = torch.empty((w, h, 3), dtype=f32, device=dev)
    w_sum = torch.empty((w, h), dtype=f32, device=dev)
    hist_f = torch.empty((w, h, 4), dtype=f32, device=dev)
    extra_f = torch.empty((w, h), dtype=f32, device=dev) if with_extra \
        else None
    _cuda.check(_entry()(
        cur.data_ptr(), rs[0], hist.data_ptr(), rs[1],
        normals.data_ptr(), rs[2],
        depth.data_ptr() if gate_depth else None, rs[3],
        extra.data_ptr() if with_extra else None, rs[4],
        proj_inv.data_ptr() if gate_depth else None,
        texcoord.data_ptr(), rp.data_ptr(), center_depth.data_ptr(),
        center_normal.data_ptr(), current.data_ptr(), w_sum.data_ptr(),
        hist_f.data_ptr(), extra_f.data_ptr() if with_extra else None,
        counts.data_ptr() if counts is not None else None,
        w, h, aw, ah, int(bool(catmullrom)), int(bool(gate_depth)),
        int(with_extra), _cuda.stream_ptr(dev)), "temporal_taps")
    _cuda.LAUNCHES["temporal_taps"] += 1
    return current, w_sum, hist_f, extra_f
