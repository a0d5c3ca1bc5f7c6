"""Temporal accumulation and filtering (renderer/pathtracer.py:993-1303); the
PyTorch port of voxelrt/render/temporal.py.

Progressive accumulation lives in per-pixel history buffers blended with
1/history.w (an exponential average capped at ``max_accum_frames``). While
the camera moves, history is reprojected through the previous view/proj
matrices with a Catmull-Rom 4×4 tap filter gated on depth/normal agreement;
specular history reprojects the *virtual reflection point* instead of the
primary hit (renderer/pathtracer.py:1242-1303). The moving-frame taps go
through kernel B4 (ops/resample.py) or, for ``motion_resample='xla'`` and
for active regions above its texel limit, through the f32 gather
formulation (``_bilinear`` + ``_history_filter``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from voxelrt_torch.ops import packing
from voxelrt_torch.ops import resample as rs
from voxelrt_torch.ops.resample import temporal_taps
from voxelrt_torch.ops.sampling import mix
from voxelrt_torch.ops.transforms import (
    delinearize_depth,
    linearize_depth,
    screen_to_view,
    view_to_screen,
    view_to_world,
    world_to_view,
)
from voxelrt_torch.utils import profiling


def _window_sum(x, pad_rows):
    """Sum over the 4×4 window at offsets [-1, 2]² with zero padding: ``x``
    (R, ah[, C]) holds the rows the windows reach, ``pad_rows`` = (before,
    after) the zero rows to add where those rows pass the active region's
    edges. Returns (R + sum(pad_rows) - 3, ah, C)."""
    if x.dim() == 2:
        x = x[..., None]
    p = F.pad(x.permute(2, 0, 1), (1, 2) + tuple(pad_rows))
    rows, ah = p.shape[1] - 3, x.shape[1]
    s = torch.zeros((x.shape[2], rows, ah), dtype=x.dtype, device=x.device)
    for i in range(4):
        for j in range(4):
            s = s + p[:, i:i + rows, j:j + ah]
    return s.permute(1, 2, 0)


def temporal_prepass(cfg, color, color_spec, refl_depth, render_scale, lo=0,
                     halo=None):
    """renderer/pathtracer.py:1020-1075 — returns (color, color_spec,
    refl_depth) with NaN scrubbing applied. The JAX version also returns the
    specular 4×4 mean and deviation; neither its still nor its moving
    filters read them (voxelrt/render/temporal.py:294-408), so the port
    does not compute them.

    On the image's rows [lo, lo + rows) (a block of a partitioned frame):
    ``halo`` = (the reflection depths of the rows [lo - 1, lo), of the rows
    [lo + rows, lo + rows + 2)), as far as the image has them; the window's
    zero padding applies at the active region's edges only."""
    with profiling.span("temporal.prepass"):
        w, h = cfg.image_res
        aw = max(int(w * render_scale), 1)
        ah = max(int(h * render_scale), 1)
        ra = max(0, min(lo + color.shape[0], aw) - lo)
        if ra == 0:
            return color, color_spec, refl_depth
        before, after = halo if halo is not None else (refl_depth[:0],
                                                       refl_depth[:0])
        parts = [x for x in (before, refl_depth, after) if x.shape[0]]
        ext = parts[0] if len(parts) == 1 else torch.cat(parts)
        e0 = lo - before.shape[0]  # the image row of ext's first row
        # the rows the windows reach, [lo - 1, lo + ra + 2), within the region
        a, b = max(0, lo - 1), min(aw, lo + ra + 2)
        pads = (a - (lo - 1), lo + ra + 2 - b)

        rd = ext[a - e0:b - e0, :ah]
        valid = (rd != 0.0).to(torch.float32)
        rd_sum = _window_sum(rd * valid, pads)[..., 0]
        rd_cnt = _window_sum(valid, pads)[..., 0]
        rd_new = torch.where(rd_cnt > 0.01,
                             rd_sum / torch.clamp(rd_cnt, min=1e-20), 0.0)

        def scrub(c):
            bad = torch.any(~torch.isfinite(c) | (c < 0.0), dim=-1,
                            keepdim=True)
            return torch.where(bad, 0.0, c)

        color = color.clone()
        color[:ra, :ah] = scrub(color[:ra, :ah])
        color_spec = color_spec.clone()
        color_spec[:ra, :ah] = scrub(color_spec[:ra, :ah])
        refl_depth = refl_depth.clone()
        refl_depth[:ra, :ah] = rd_new
        return color, color_spec, refl_depth


def _pixel_texcoords(cfg, render_scale, device, lo=0, rows=None):
    """The screen coordinates of the image's rows [lo, lo + rows) (default:
    every row), (rows, H, 2)."""
    w, h = cfg.image_res
    rows = w if rows is None else rows
    ui = torch.arange(lo, lo + rows, dtype=torch.float32,
                      device=device)[:, None]
    vj = torch.arange(h, dtype=torch.float32, device=device)[None, :]
    tx = (ui.expand(rows, h) + 0.5) / (w * render_scale)
    ty = (vj.expand(rows, h) + 0.5) / (h * render_scale)
    return torch.stack([tx, ty], dim=-1)


def _gather2d(img, xi, yi, bx, by):
    """img[(W,H) or (W,H,C)][xi, yi], indices clamped to [0, bx) × [0, by):
    callers clamp to the ACTIVE region so edge taps never read the stale
    out-of-area remainder of the full-res buffer."""
    h = img.shape[1]
    xi = torch.clamp(xi, 0, bx - 1)
    yi = torch.clamp(yi, 0, by - 1)
    return img.reshape((-1,) + tuple(img.shape[2:]))[xi * h + yi]


def _catmullrom(x):
    """renderer/pathtracer.py:1002-1014."""
    x2 = x * x
    x3 = x2 * x
    f1 = 1.5 * x3 - 2.5 * x2 + 1.0
    f2 = -0.5 * x3 + 2.5 * x2 - 4.0 * x + 2.0
    return torch.where(x < 1.0, f1, torch.where(x < 2.0, f2, 0.0))


def reproject(world_pos, prev_view, prev_proj):
    """renderer/pathtracer.py:993-1000."""
    return view_to_screen(world_to_view(world_pos, prev_view), prev_proj)


def _floor_index(f):
    """floor(f) as an index tensor. Non-finite coordinates (sky pixels
    reproject to NaN) become far out of bounds, where every tap has zero
    weight; the JAX package's float-to-int conversion leaves them out of
    bounds or at zero weight as well."""
    return torch.floor(torch.where(torch.isfinite(f), f, -1.0e9)).to(
        torch.int64)


def _history_filter(cfg, history, prev_depth, prev_normals, uv, center_depth,
                    center_normal, proj_inv, render_scale, moving,
                    gate_depth=True, extra=None):
    """Reprojected history fetch with validity gating
    (renderer/pathtracer.py:1092-1183), the f32 gather formulation.
    ``extra`` optionally filters a second scalar buffer (specular reflection
    depth history) alongside. Returns (w_sum, filtered_color4,
    filtered_extra). ``cfg.motion_filter`` selects the reference's
    Catmull-Rom 4×4 or the 2×2 bilinear footprint."""
    w, h = cfg.image_res
    ires_x = int(w * render_scale)
    ires_y = int(h * render_scale)
    fcoord_x = uv[..., 0] * ires_x - 0.5
    fcoord_y = uv[..., 1] * ires_y - 0.5
    ix = _floor_index(fcoord_x)
    iy = _floor_index(fcoord_y)
    fx = fcoord_x - ix
    fy = fcoord_y - iy

    if cfg.motion_filter == "bilinear":
        tap_range = range(0, 2)

        def tap_w(o, f):
            return torch.clamp(1.0 - torch.abs(o - f), min=0.0)
    else:
        tap_range = range(-1, 3)

        def tap_w(o, f):
            return _catmullrom(torch.abs(o - f))

    def full(shape, v):
        return torch.full(shape, v, dtype=torch.float32, device=uv.device)

    shp = tuple(uv.shape[:-1])
    col_sum = full(shp + (4,), 0.0)
    col_min = full(shp + (4,), 999999.0)
    col_max = full(shp + (4,), 0.0)
    d_sum, d_min, d_max = full(shp, 0.0), full(shp, 999999.0), full(shp, 0.0)
    w_sum = full(shp, 0.0)

    for ox in tap_range:
        for oy in tap_range:
            tx = ix + ox
            ty = iy + oy
            in_bounds = (tx >= 0) & (tx < ires_x) & (ty >= 0) & (ty < ires_y)
            wgt = tap_w(ox, fx) * tap_w(oy, fy)
            if moving:
                tap_normal = packing.decode_unit_vector_3x16(
                    _gather2d(prev_normals, tx, ty, ires_x, ires_y))
                ok_n = torch.sum(center_normal * tap_normal, dim=-1) > 0.642
                wgt = wgt * ok_n.to(torch.float32)
                if gate_depth:
                    tap_depth = linearize_depth(
                        _gather2d(prev_depth, tx, ty, ires_x, ires_y),
                        proj_inv)
                    ok_d = (torch.abs(tap_depth - center_depth)
                            / torch.clamp(torch.abs(center_depth),
                                          min=1e-20)) < 0.05
                    wgt = wgt * ok_d.to(torch.float32)
            wgt = wgt * in_bounds.to(torch.float32)

            col = _gather2d(history, tx, ty, ires_x, ires_y)
            inb4 = in_bounds[..., None]
            col_min = torch.where(inb4, torch.minimum(col_min, col), col_min)
            col_max = torch.where(inb4, torch.maximum(col_max, col), col_max)
            col_sum = col_sum + col * wgt[..., None]
            if extra is not None:
                ex = _gather2d(extra, tx, ty, ires_x, ires_y)
                d_min = torch.where(in_bounds, torch.minimum(d_min, ex), d_min)
                d_max = torch.where(in_bounds, torch.maximum(d_max, ex), d_max)
                d_sum = d_sum + ex * wgt
            w_sum = w_sum + wgt

    safe_w = torch.where(torch.abs(w_sum) < 1e-20, 1e-20, w_sum)
    col = col_sum / safe_w[..., None]
    # anti-ringing (renderer/pathtracer.py:1130, 1181-1183); min(max(·)) so
    # that a pixel with no in-bounds tap (lo > hi) gets hi, as jnp.clip
    col = torch.maximum(
        torch.minimum(torch.maximum(col, col_min), col_max),
        torch.tensor([0.0, 0.0, 0.0, 1.0], device=uv.device))
    if extra is not None:
        ex = torch.minimum(torch.maximum(d_sum / safe_w, d_min), d_max)
        return w_sum, col, ex
    return w_sum, col, None


def _bilinear(img, uv, ires_x, ires_y):
    """renderer/pathtracer.py:1077-1090."""
    fx = uv[..., 0] * ires_x - 0.5
    fy = uv[..., 1] * ires_y - 0.5
    ix = torch.floor(fx).to(torch.int64)
    iy = torch.floor(fy).to(torch.int64)
    f_x = (fx - ix)[..., None]
    f_y = (fy - iy)[..., None]
    bl = _gather2d(img, ix, iy, ires_x, ires_y)
    br = _gather2d(img, ix + 1, iy, ires_x, ires_y)
    tl = _gather2d(img, ix, iy + 1, ires_x, ires_y)
    tr = _gather2d(img, ix + 1, iy + 1, ires_x, ires_y)
    return mix(mix(bl, br, f_x), mix(tl, tr, f_x), f_y)


def _moving_taps(cfg, params, state_color, history, gbuffer, texcoord, rp,
                 center_depth, center_n, render_scale, gate_depth,
                 extra=None):
    """Motion-phase resampling: current-color bilinear + gated history taps.

    Dispatches to kernel B4 (ops/resample.temporal_taps) for
    ``motion_resample='pallas'`` while the active region is within the
    kernel path's texel limit, as the JAX package's kernel path does;
    otherwise to the f32 gather path (_bilinear + _history_filter). The
    choice never depends on the device. The kernel path hands the frame
    buffers' active-region views to the kernel as they are: it packs
    nothing here. Returns (current, w_sum, hist, extra_f)."""
    w, h = cfg.image_res
    aw = max(int(w * render_scale), 1)
    ah = max(int(h * render_scale), 1)
    if not (cfg.motion_resample == "pallas" and aw * ah <= rs.MAX_TEXELS):
        current = _bilinear(state_color, texcoord, aw, ah)
        w_sum, hist, extra_f = _history_filter(
            cfg, history, gbuffer["prev_depth"], gbuffer["prev_normals"],
            rp[..., 0:2], center_depth, center_n, params.proj_inv,
            render_scale, moving=True, gate_depth=gate_depth, extra=extra)
        return current, w_sum, hist, extra_f

    return temporal_taps(
        state_color[:aw, :ah], history[:aw, :ah],
        gbuffer["prev_normals"][:aw, :ah], gbuffer["prev_depth"][:aw, :ah],
        params.proj_inv, extra[:aw, :ah] if extra is not None else None,
        texcoord, rp, center_depth, center_n,
        catmullrom=cfg.motion_filter != "bilinear", gate_depth=gate_depth)


def _center(cfg, params, gbuffer, render_scale, lo=0):
    """Per-pixel texcoords, the primary hit reconstructed from the G-buffer
    depth, and the mask of pixels whose position is the origin (sky); the
    G-buffer holds the image's rows from ``lo`` on."""
    depth = gbuffer["depth"]
    texcoord = _pixel_texcoords(cfg, render_scale, depth.device, lo,
                                depth.shape[0])
    x1 = view_to_world(screen_to_view(texcoord, gbuffer["depth"],
                                      params.proj_inv), params.view_inv)
    skip = (x1[..., 0] * x1[..., 0] + x1[..., 1] * x1[..., 1]
            + x1[..., 2] * x1[..., 2]) < 1e-7
    return texcoord, x1, skip


def _blend(hist, current, w_sum, sample_weight, max_accum):
    """History advanced by this frame's samples where a pixel has history
    (``w_sum`` None: everywhere), else restarted from the current colour.
    Returns (hist_out, has_hist, new_w)."""
    new_w = torch.minimum(hist[..., 3] + sample_weight, max_accum)
    blended = mix(hist[..., 0:3], current[..., 0:3],
                  (sample_weight / new_w)[..., None])
    hist_out = torch.cat([blended, new_w[..., None]], dim=-1)
    if w_sum is None:
        return hist_out, None, new_w
    has_hist = w_sum > 1e-3
    fresh = torch.cat([current[..., 0:3],
                       torch.full_like(new_w, sample_weight)[..., None]],
                      dim=-1)
    return torch.where(has_hist[..., None], hist_out, fresh), has_hist, new_w


def temporal_filter(cfg, params, state_color, history, gbuffer,
                    render_scale, moving, sample_weight: float = 1.0, lo=0):
    """Diffuse temporal filter (renderer/pathtracer.py:1185-1230).
    Returns (new_color, new_history). ``sample_weight`` is the number of
    fresh path samples averaged into ``state_color`` this frame; the history
    weight advances by it so the accumulation stays an exact running mean.
    ``lo``: the image row of the buffers' first row (a still frame's block
    of rows)."""
    with profiling.span("temporal.filter"):
        texcoord, center_x1, skip = _center(cfg, params, gbuffer, render_scale,
                                            lo)
        if moving:
            center_n = packing.decode_unit_vector_3x16(gbuffer["normals"])
            rp = reproject(center_x1, params.prev_view, params.prev_proj)
            current, w_sum, hist, _ = _moving_taps(
                cfg, params, state_color, history, gbuffer, texcoord, rp,
                linearize_depth(rp[..., 2], params.proj_inv), center_n,
                render_scale, gate_depth=True)
        else:
            current, w_sum, hist = state_color, None, history

        hist_out, _, _ = _blend(hist, current, w_sum, sample_weight,
                                params.max_accum_frames)
        out_color = hist_out[..., 0:3]
        if moving:
            # re-modulate by the stored albedo
            # (renderer/pathtracer.py:1223-1228)
            _, albedo = packing.decode_material_word(gbuffer["mat_id"])
            out_color = out_color * albedo

        new_history = torch.where(skip[..., None], history, hist_out)
        new_color = torch.where(skip[..., None], state_color, out_color)
        return new_color, new_history


def temporal_filter_specular(cfg, params, color, color_spec, history_spec,
                             history_spec_depth, gbuffer, render_scale, moving,
                             sample_weight: float = 1.0, lo=0):
    """Specular temporal filter (renderer/pathtracer.py:1242-1303).
    Returns (color_with_specular, new_history_spec, new_history_spec_depth);
    ``lo`` as in :func:`temporal_filter`."""
    with profiling.span("temporal.filter_specular"):
        texcoord, center_x1, skip = _center(cfg, params, gbuffer, render_scale,
                                            lo)
        center_refl_depth = gbuffer["depth_reflection"]
        if moving:
            center_n = packing.decode_unit_vector_3x16(gbuffer["normals"])
            refl_nonlin = delinearize_depth(center_refl_depth, params.proj)
            refl_pos = view_to_world(
                screen_to_view(texcoord, refl_nonlin, params.proj_inv),
                params.view_inv)
            rp_src = torch.where((center_refl_depth != 0.0)[..., None],
                                 refl_pos, center_x1)
            rp = reproject(rp_src, params.prev_view, params.prev_proj)
            current, w_sum, hist, hist_depth = _moving_taps(
                cfg, params, color_spec, history_spec, gbuffer, texcoord, rp,
                linearize_depth(rp[..., 2], params.proj_inv), center_n,
                render_scale, gate_depth=False, extra=history_spec_depth)
        else:
            current, w_sum, hist = color_spec, None, history_spec
            hist_depth = history_spec_depth

        hist_out, has_hist, new_w = _blend(hist, current, w_sum, sample_weight,
                                           params.max_accum_frames)
        depth_out = mix(hist_depth, center_refl_depth, sample_weight / new_w)
        if has_hist is not None:
            depth_out = torch.where(has_hist, depth_out, center_refl_depth)

        new_history = torch.where(skip[..., None], history_spec, hist_out)
        new_depth = torch.where(skip, history_spec_depth, depth_out)
        new_color = torch.where(skip[..., None], color,
                                color + hist_out[..., 0:3])
        return new_color, new_history, new_depth
