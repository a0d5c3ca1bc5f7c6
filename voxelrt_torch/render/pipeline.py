"""Renderer: buffer state + the progressive accumulate step (the PyTorch port
of voxelrt/render/pipeline.py), for still and for moving frames.

All frame-persistent buffers live in an explicit :class:`RenderState`;
``accumulate`` mirrors renderer/pathtracer.py:1310-1319 (render -> [spatial
GRIS] -> temporal prepass -> temporal filter -> specular temporal filter). With
``render_scale`` below 1 only the active top-left region is traced and
filtered; the rest of every buffer keeps its old contents. ``accumulate_n``
is a Python loop of launches. A launch is ``trace_frame`` then
``resolve_frame``; both also run on a block of the image's rows, with the
image's pixel coordinates, which is how parallel.sharding partitions a
still frame over devices. The JAX package's arrays are immutable; here
each launch builds new buffers and drops the old ones, so no state is
shared between a caller's RenderState and the next one.

The 16×8 tile order of the reference's buffers (pathtracer.py:71-81) is
kept for the wavefront: flat ray index -> (tile x, tile y, i, j), so each
run of rays is a tight screen tile and pixel ids match the JAX package's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from voxelrt_torch.ops.prng import fold_in, uniform
from voxelrt_torch.ops.tonemap import render_to_image
from voxelrt_torch.ops.v3 import V3
from voxelrt_torch.render import temporal
from voxelrt_torch.render.pathtracer import trace_sample
from voxelrt_torch.utils import profiling


@dataclasses.dataclass
class RenderState:
    """All frame-persistent buffers (renderer/pathtracer.py:39-133)."""

    color: torch.Tensor  # (W, H, 3) diffuse+final radiance
    color_spec: torch.Tensor  # (W, H, 3)
    history: torch.Tensor  # (W, H, 4)
    history_spec: torch.Tensor  # (W, H, 4)
    history_spec_depth: torch.Tensor  # (W, H)
    gbuff_normals: torch.Tensor  # (W, H, 2) f16 octahedral
    gbuff_depth: torch.Tensor  # (W, H)
    gbuff_depth_reflection: torch.Tensor  # (W, H)
    gbuff_position: torch.Tensor  # (W, H, 3)
    gbuff_mat_id: torch.Tensor  # (W, H) int64 holding the u32 word
    gbuff_prev_depth: torch.Tensor  # (W, H)
    gbuff_prev_normals: torch.Tensor  # (W, H, 2) f16
    # ReSTIR's two reservoir slots (render/restir.py), None without ReSTIR
    reservoirs: Any = None
    spp: int = 0
    frame: int = 0


def init_state(cfg, device) -> RenderState:
    w, h = cfg.image_res

    def f(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    reservoirs = None
    if cfg.use_restir_pt:
        from voxelrt_torch.render.restir import init_reservoir_storage

        reservoirs = init_reservoir_storage(cfg, device)
    return RenderState(reservoirs=reservoirs,
        color=f(w, h, 3), color_spec=f(w, h, 3), history=f(w, h, 4),
        history_spec=f(w, h, 4), history_spec_depth=f(w, h),
        gbuff_normals=f(w, h, 2, dtype=torch.float16), gbuff_depth=f(w, h),
        gbuff_depth_reflection=f(w, h), gbuff_position=f(w, h, 3),
        gbuff_mat_id=f(w, h, dtype=torch.int64), gbuff_prev_depth=f(w, h),
        gbuff_prev_normals=f(w, h, 2, dtype=torch.float16))


def reset_framebuffer(state):
    """renderer/pathtracer.py:664-668: restart the accumulation; the
    G-buffers and the frame counter stay. A partitioned state
    (parallel.sharding) is gathered first."""
    if isinstance(state, tuple):
        from voxelrt_torch.parallel.sharding import gather_state

        state = gather_state(state)
    return dataclasses.replace(
        state, history=torch.zeros_like(state.history),
        history_spec=torch.zeros_like(state.history_spec),
        history_spec_depth=torch.zeros_like(state.history_spec_depth), spp=0)


TILE_W, TILE_H = 16, 8  # the reference's interleave (pathtracer.py:71-81)


def _use_tiles(w, h):
    return w % TILE_W == 0 and h % TILE_H == 0


def _pixel_uv_from_index(w, h, pix, tiled=None):
    """u, v pixel coordinates of flat pixel ids in 16×8-tile order (plain
    column order when the image does not tile); ``tiled`` as in
    :func:`_untile`."""
    if _use_tiles(w, h) if tiled is None else tiled:
        per_tx = (h // TILE_H) * TILE_W * TILE_H
        tx = pix // per_tx
        r = pix - tx * per_tx
        per_ty = TILE_W * TILE_H
        ty = r // per_ty
        r2 = r - ty * per_ty
        i = r2 // TILE_H
        j = r2 - i * TILE_H
        return ((tx * TILE_W + i).to(torch.float32),
                (ty * TILE_H + j).to(torch.float32))
    return (pix // h).to(torch.float32), (pix - (pix // h) * h).to(
        torch.float32)


def _untile(w, h, x, tiled=None):
    """Inverse of the tile ordering: (N, ...) -> (W, H, ...). ``tiled``:
    whether the lanes are in tile order (by default, whether a w×h image
    tiles); a block of an image's rows lists its pixels in the order
    :func:`block_tiled` gives it."""
    rest = tuple(x.shape[1:])
    if _use_tiles(w, h) if tiled is None else tiled:
        x = x.reshape((w // TILE_W, h // TILE_H, TILE_W, TILE_H) + rest)
        x = x.transpose(1, 2)
    return x.reshape((w, h) + rest)


def active_res(cfg, render_scale):
    """The traced top-left region (aw, ah) at ``render_scale``."""
    w, h = cfg.image_res
    return max(int(w * render_scale), 1), max(int(h * render_scale), 1)


def active_rows(aw, lo, rows):
    """How many of the rows [lo, lo + rows) lie in the active region."""
    return max(0, min(lo + rows, aw) - lo)


def block_tiled(aw, ah, ra):
    """Whether a block of ``ra`` active rows of an aw×ah active grid lists
    its pixels in its own 16×8 tile order (else in column order): where the
    grid and the block both tile. A block on the grid's 16-row tile columns
    then lists them as the grid's own order does."""
    return _use_tiles(aw, ah) and _use_tiles(ra, ah)


def wavefront_constants(cfg, render_scale, device, rows=None):
    """Per-launch constants derived from the flat ray index over the ACTIVE
    aw×ah grid: the pixel (u, v) of each of the k·n rays and the sample
    each ray belongs to.

    ``rows``: a block (lo, hi) of the buffers' rows (default: all). Its
    rays are its ``ra`` active pixels', with the image's pixel coordinates,
    each sample's in the order of the block's own ra×ah grid
    (:func:`block_tiled`), which ``trace_frame``'s embedding inverts. Every
    lane's output is a function of its pixel and sample alone, so any row
    bounds give the one-device frame's values. A block on 16-row tile
    columns lists the contiguous pixel ids [lo·ah, (lo + ra)·ah) of every
    sample in the image's own order."""
    aw, ah = active_res(cfg, render_scale)
    lo, hi = rows if rows is not None else (0, cfg.image_res[0])
    ra = active_rows(aw, lo, hi - lo)
    k = max(1, cfg.samples_per_launch)
    n = ra * ah
    ridx = torch.arange(k * n, dtype=torch.int64, device=device)
    s_of_ray = ridx // max(n, 1)
    u, v = _pixel_uv_from_index(ra, ah, ridx - s_of_ray * n,
                                block_tiled(aw, ah, ra))
    return u + lo, v, s_of_ray


def sample_keys_of(key, k_samples):
    """The k per-sample keys of one launch (pipeline.py:225-228) and their
    TAA jitter uniforms (pipeline.py:253-255), a (k, 2) float32 tensor on
    the host, drawn for all keys in one call."""
    skeys = [key] + [fold_in(key, 7000 + i) for i in range(1, k_samples)]
    jkeys = [fold_in(sk, 417) for sk in skeys]
    jit = uniform(tuple(torch.tensor([jk[w] for jk in jkeys],
                                     dtype=torch.int64) for w in (0, 1)),
                  (2,), "cpu")
    return skeys, jit


def launch_keys(key, k_samples, pin=False):
    """A launch's sample keys as a (2, k) int64 tensor and their jitter
    uniforms as (k, 2) float32, on the host; ``pin``: in page-locked
    memory, from which an upload to a card does not wait for it."""
    skeys, jit = sample_keys_of(key, k_samples)
    keys = torch.tensor([[sk[0] for sk in skeys], [sk[1] for sk in skeys]],
                        dtype=torch.int64)
    if pin:
        keys, jit = keys.pin_memory(), jit.pin_memory()
    return keys, jit


def trace_frame(cfg, scene, params, state: RenderState, keys,
                camera_is_moving, render_scale, wf, trace_fn=None, lo=0):
    """The render pass of one launch on the state's rows [lo, lo + rows)
    (a block of a partitioned frame; the whole image when ``lo`` is 0 and
    the state holds every row): ``cfg.samples_per_launch`` path samples of
    each active pixel traced as ONE wavefront (``wf``, the block's
    ``wavefront_constants``; ``keys``, the launch's ``launch_keys``) and
    averaged, then embedded into the rows' buffers. Returns the post-trace
    buffers: ``color``, ``color_spec``, ``gbuffer`` (a dict) and
    ``reservoir`` (ReSTIR's raw input reservoir images, else None).
    ``trace_fn``: a replacement for :func:`trace_sample` with the same
    signature and the same per-lane outputs, as parallel.sharding's trace
    of a block's lanes over several devices is."""
    with profiling.span("pipeline.trace_frame"):
        h = cfg.image_res[1]
        aw, ah = active_res(cfg, render_scale)
        rows = state.color.shape[0]
        ra = active_rows(aw, lo, rows)
        scaled = (ra, ah) != (rows, h)
        dev = state.color.device
        k = max(1, cfg.samples_per_launch)
        if cfg.use_restir_pt and k != 1:
            # the GRIS pass consumes one reservoir per pixel
            raise ValueError("samples_per_launch must be 1 with ReSTIR-PT")
        gb_old = dict(
            normals=state.gbuff_normals, depth=state.gbuff_depth,
            depth_reflection=state.gbuff_depth_reflection,
            position=state.gbuff_position, mat_id=state.gbuff_mat_id)
        prev = dict(prev_depth=state.gbuff_prev_depth,
                    prev_normals=state.gbuff_prev_normals)
        if ra == 0:
            # rows outside the active region keep their buffers (below), and
            # their reservoir images are the embedding's zeros
            reservoir = None
            if cfg.use_restir_pt:
                reservoir = {name: torch.zeros_like(x)
                             for name, x in state.reservoirs[0].items()}
            return dict(color=state.color, color_spec=state.color_spec,
                        gbuffer={**gb_old, **prev}, reservoir=reservoir)
        n = ra * ah
        u, v, s_of_ray = wf
        key_t, jit = keys
        k0, k1 = key_t.to(dev, non_blocking=True)
        ju = jit.to(dev, non_blocking=True)
        out = (trace_fn or trace_sample)(cfg, scene, params, u, v,
                           (k0[s_of_ray], k1[s_of_ray]),
                           (ju[s_of_ray, 0], ju[s_of_ray, 1]),
                           camera_is_moving, render_scale)

        with profiling.span("pipeline.embed"):
            def sample_mean(x):
                acc = x[:n]
                for s in range(1, k):
                    acc = acc + x[s * n:(s + 1) * n]
                return acc / k

            diffuse = V3(*(sample_mean(c) for c in out["diffuse"]))
            specular = V3(*(sample_mean(c) for c in out["specular"]))
            tiled = block_tiled(aw, ah, ra)

            def img(x):
                if isinstance(x, tuple):  # V3 or the octahedral normal pair
                    return torch.stack([img(c) for c in x], dim=-1)
                a = _untile(ra, ah, x[:n], tiled)
                if not scaled:
                    return a
                full = torch.zeros((rows, h) + tuple(a.shape[2:]),
                                   dtype=a.dtype, device=dev)
                full[:ra, :ah] = a
                return full

            # Out-of-area pixels keep their previous buffers (the
            # reference's is_outside_render_area contract): there the
            # embedded mask is False.
            inside = img(out["inside"])

            def sel(new, old):
                m = inside[..., None] if new.dim() == 3 else inside
                return torch.where(m, new, old)

            gbuffer = {name: sel(img(out[f"gbuff_{name}"]), old)
                       for name, old in gb_old.items()}
            gbuffer.update(prev)
            reservoir = None
            if cfg.use_restir_pt:
                reservoir = {name: img(x)
                             for name, x in out["reservoir"].items()}
            return dict(color=sel(img(diffuse), state.color),
                        color_spec=sel(img(specular), state.color_spec),
                        gbuffer=gbuffer, reservoir=reservoir)


def resolve_frame(cfg, scene, params, state: RenderState, frame, key,
                  camera_is_moving, render_scale, lo=0, halo=None
                  ) -> RenderState:
    """The rest of one launch on the state's rows [lo, lo + rows): [the
    spatial GRIS pass] -> temporal prepass -> temporal filter -> specular
    temporal filter (renderer/pathtracer.py:1310-1319), from ``frame``,
    this launch's ``trace_frame`` of those rows, and ``key``, the launch's
    key. ``halo(get, a, b)``: the image's rows [a, b) of the post-trace
    buffer ``get`` takes from a frame, on the state's device (default: from
    ``frame``, which must then hold them). The GRIS taps reach
    ceil(restir_radius) rows each side (a tap's offset is below the
    radius, restir.py), the prepass's 4×4 window 1 row before and 2 after.
    A moving frame runs on the whole image only."""
    with profiling.span("pipeline.resolve_frame"):
        w, h = cfg.image_res
        rows = state.color.shape[0]
        hi = lo + rows
        if camera_is_moving and (lo, rows) != (0, w):
            raise ValueError("a moving frame runs on the whole image")
        if halo is None:
            def halo(get, a, b):
                return get(frame)[a - lo:b - lo]
        k = max(1, cfg.samples_per_launch)
        color, color_spec = frame["color"], frame["color_spec"]
        gbuffer = dict(frame["gbuffer"])
        reservoirs = state.reservoirs
        if cfg.use_restir_pt:
            from voxelrt_torch.render.restir import spatial_gris

            with profiling.span("restir.gris"):
                r = math.ceil(cfg.restir_radius)
                a, b = max(0, lo - r), min(w, hi + r)
                res_ext = {name: halo(lambda f, n=name: f["reservoir"][n],
                                      a, b)
                           for name in frame["reservoir"]}
                gbuf_ext = {name: halo(lambda f, n=name: f["gbuffer"][n],
                                       a, b)
                            for name in ("normals", "depth", "mat_id")}
                color, color_spec, reservoirs = spatial_gris(
                    cfg, scene, params, res_ext, color, color_spec, gbuf_ext,
                    state.frame, fold_in(key, 7777), camera_is_moving,
                    render_scale, lo=lo, ext_lo=a)
                del res_ext, gbuf_ext

        def refl(f):
            return f["gbuffer"]["depth_reflection"]

        color, color_spec, refl_depth = temporal.temporal_prepass(
            cfg, color, color_spec, gbuffer["depth_reflection"], render_scale,
            lo=lo, halo=(halo(refl, max(0, lo - 1), lo),
                         halo(refl, hi, min(w, hi + 2))))
        gbuffer["depth_reflection"] = refl_depth

        color, history = temporal.temporal_filter(
            cfg, params, color, state.history, gbuffer, render_scale,
            camera_is_moving, sample_weight=float(k), lo=lo)
        color, history_spec, history_spec_depth = \
            temporal.temporal_filter_specular(
                cfg, params, color, color_spec, state.history_spec,
                state.history_spec_depth, gbuffer, render_scale,
                camera_is_moving, sample_weight=float(k), lo=lo)

        return RenderState(
            color=color, color_spec=color_spec, history=history,
            history_spec=history_spec, history_spec_depth=history_spec_depth,
            gbuff_normals=gbuffer["normals"], gbuff_depth=gbuffer["depth"],
            gbuff_depth_reflection=gbuffer["depth_reflection"],
            gbuff_position=gbuffer["position"], gbuff_mat_id=gbuffer["mat_id"],
            gbuff_prev_depth=gbuffer["depth"],
            gbuff_prev_normals=gbuffer["normals"], reservoirs=reservoirs,
            spp=state.spp + k, frame=state.frame + 1)


def accumulate(cfg, scene, params, state: RenderState, key,
               camera_is_moving: bool = False, render_scale: float = 1.0,
               wf=None) -> RenderState:
    """One progressive frame for every active pixel:
    ``cfg.samples_per_launch`` path samples traced as ONE wavefront of k·n
    rays, averaged, and blended into the history with weight k
    (renderer/pathtracer.py:1310-1319): ``trace_frame`` then
    ``resolve_frame`` on the whole image.

    Render scaling traces ONLY the active-res wavefront and embeds the
    results into the top-left of the full-res buffers (the reference masks
    out-of-area threads instead, renderer/pathtracer.py:289-291). Pixel ids,
    and so the per-pixel random streams, are unchanged."""
    dev = state.color.device
    with profiling.span("pipeline.accumulate"):
        if wf is None:
            wf = wavefront_constants(cfg, render_scale, dev)
        with profiling.span("pipeline.launch_keys"):
            keys = launch_keys(key, max(1, cfg.samples_per_launch),
                               pin=dev.type == "cuda")
        frame = trace_frame(cfg, scene, params, state, keys, camera_is_moving,
                            render_scale, wf)
        return resolve_frame(cfg, scene, params, state, frame, key,
                             camera_is_moving, render_scale)


def accumulate_n(cfg, scene, params, state, key, camera_is_moving=False,
                 render_scale=1.0, n_samples: int = 1):
    """Accumulate ``n_samples`` path samples: ceil(n_samples /
    samples_per_launch) launches, launch i keyed by fold_in(key, i)."""
    k = max(1, cfg.samples_per_launch)
    wf = wavefront_constants(cfg, render_scale, state.color.device)
    for i in range(-(-n_samples // k)):
        state = accumulate(cfg, scene, params, state, fold_in(key, i),
                           camera_is_moving, render_scale, wf=wf)
    return state


def fetch_image(cfg, state, exposure, render_scale=1.0):
    """Tonemapped LDR image (renderer/pathtracer.py:1321-1323, 634-662). A
    partitioned state (parallel.sharding) is gathered first: the vignette
    reads global pixel coordinates."""
    if isinstance(state, tuple):
        from voxelrt_torch.parallel.sharding import gather_state

        state = gather_state(state)
    return render_to_image(state.color, cfg, exposure, render_scale)
