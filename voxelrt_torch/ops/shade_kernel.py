"""One depth of the wavefront sample's shading on the card: kernel S
(csrc/shade.cu), the fused form of render/pathtracer.py's
``shade_depth_eager``.

The kernel replaces no TPU kernel: the JAX package leaves this block to XLA,
which fuses it. Run eagerly on the card it was about 235 elementwise kernels
a sample, each a round trip of its operands through device memory; one
launch a depth keeps the BSDF's, NEE's and MIS's intermediates in registers
and reads the palette from shared memory (no one-hot gather). Its plain
twin is ``shade_depth_eager`` itself, which the CPU and the routes the
kernel does not take run (``shade_kernel_applies``).

The kernel updates the path state in place, so on its route the loop's
state holds every V3 as one (3, n) buffer of its own
(``pathtracer.start_state(..., own=True)``); the ``tracing`` mask alone it
writes anew each depth, so the mask handed to B1 stays as B1 saw it. The
palette's Disney features (``MatFeatures``, which ``prepare_data`` bakes
from the scene) are an argument of the launch, a bit each.
"""

from __future__ import annotations

import ctypes

import torch

from voxelrt_torch.ops import _cuda

# the pointer slots of csrc/shade.cu's ``shade``, in its order: (name,
# components)
SLOTS = (
    ("closest", 1), ("normal", 3), ("albedo", 3), ("hit_light", 1),
    ("mat_id", 1), ("knee_vis", 1), ("u_nee", 2), ("u_bsdf", 3),
    ("u_sky", 3), ("pos", 3), ("d", 3), ("tracing", 1), ("tracing_out", 1),
    ("throughput", 3),
    ("contrib", 3), ("esc_dir", 3), ("esc_u3", 3), ("esc_weight", 3),
    ("primary_normal_oct", 2), ("primary_pos", 3), ("primary_mat_info", 1),
    ("primary_albedo", 3), ("is_sky_ray", 1),
    ("first_light_sample_bsdf_pdf", 1), ("first_nee_diffuse", 3),
    ("first_nee_specular", 3), ("first_bounce_invpdf", 1),
    ("first_bounce_lobe_id", 1), ("first_bounce_dir", 3),
    ("first_light_sample_dir", 3), ("lobe_in", 1),
    ("first_bounce_reflection_dist", 1), ("palette", 1), ("floor_height", 1),
    ("light_direction", 1), ("cos_max", 1), ("light_color", 1),
    ("strans", 1))
N_PTRS = sum(k for _, k in SLOTS)


def shade_kernel_applies(cfg, device) -> bool:
    """Whether a depth's shading runs as the kernel: on CUDA, off ReSTIR
    (whose rc bookkeeping fetches the sky at every depth) and the sorted
    route, with B1's in-kernel NEE or no sun (path A' dispatches its shadow
    rays inside the stage), and with the cone centre's transmittance or a
    flat sky (``nee_transmittance='per_ray'`` fetches the sky per ray)."""
    return (torch.device(device).type == "cuda"
            and not cfg.use_restir_pt and not cfg.sort_rays
            and (cfg.nee_in_kernel or not cfg.use_directional_light)
            and (cfg.nee_transmittance == "center"
                 or not cfg.use_physical_sky))


def feature_bits(feat) -> int:
    """A ``MatFeatures`` as csrc/shade.cu's ``features`` bits (subsurface
    1, metallic 2, anisotropic 4, sheen 8, clearcoat 16)."""
    return sum(1 << i for i, on in enumerate(feat) if on)


def _shade_fn():
    """csrc/shade.cu's ``shade``, its slot count checked on first use."""
    lib = _cuda.lib("shade")
    if lib.shade.argtypes is None:
        lib.shade_slots.restype = ctypes.c_int
        if lib.shade_slots() != N_PTRS:
            raise RuntimeError("csrc/shade.cu's slots differ from SLOTS")
        lib.shade.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                              ctypes.c_int, ctypes.c_int, ctypes.c_float,
                              ctypes.c_float, ctypes.c_longlong,
                              ctypes.c_void_p]
        lib.shade.restype = ctypes.c_int
    return lib.shade


def shade_depth(cfg, params, mat_params, depth, hit, knee_vis, s, u_nee,
                u_bsdf, u_sky, strans, feat):
    """One launch of kernel S for depth ``depth``: updates ``s`` (a
    ``pathtracer.PathState`` on the kernel's route) in place as
    ``shade_depth_eager`` replaces its fields, ``tracing`` by a new mask.
    ``hit``: the depth's ``pathtracer.Hit``; ``knee_vis``: B1's NEE
    verdicts (int32), None without a sun; ``u_*``: the depth's draws;
    ``strans``: the cone centre's sun transmittance as a (3,) tensor, None
    for a flat sky (1); ``feat``: the palette's ``MatFeatures``."""
    dev = hit.closest.device
    n = hit.closest.shape[0]
    first, last = depth == 0, depth == cfg.max_ray_depth - 1
    nee = cfg.use_directional_light
    if nee and knee_vis is None:
        raise ValueError("the shade kernel takes B1's in-kernel NEE verdicts")
    f32, i32 = torch.float32, torch.int32
    b, f16, i64 = torch.bool, torch.float16, torch.int64
    tracing_out = torch.empty_like(s.tracing)
    rec0, rec1 = first, depth == 1
    lane = (n,)
    # slot name: (tensor or tensors, dtype, shape, whether this depth uses
    # it); an unused slot is a null pointer
    table = dict(
        closest=(hit.closest, f32, lane, True),
        normal=(hit.normal, f32, lane, True),
        albedo=(hit.albedo, f32, lane, True),
        hit_light=(hit.hit_light, b, lane, True),
        mat_id=(hit.mat_id, i32, lane, True),
        knee_vis=(knee_vis, i32, lane, nee),
        u_nee=(u_nee, f32, lane, nee),
        u_bsdf=(u_bsdf, f32, lane, not last),
        u_sky=(u_sky, f32, lane, True),
        pos=(s.pos, f32, lane, True), d=(s.d, f32, lane, True),
        tracing=(s.tracing, b, lane, True),
        tracing_out=(tracing_out, b, lane, True),
        throughput=(s.throughput, f32, lane, True),
        contrib=(s.contrib, f32, lane, True),
        esc_dir=(s.esc_dir, f32, lane, True),
        esc_u3=(s.esc_u3, f32, lane, True),
        esc_weight=(s.esc_weight, f32, lane, True),
        primary_normal_oct=(s.primary_normal_oct, f16, lane, rec0),
        primary_pos=(s.primary_pos, f32, lane, rec0),
        primary_mat_info=(s.primary_mat_info, i64, lane, rec0),
        primary_albedo=(s.primary_albedo, f32, lane, rec0),
        is_sky_ray=(s.is_sky_ray, b, lane, rec0),
        first_light_sample_bsdf_pdf=(s.first_light_sample_bsdf_pdf, f32,
                                     lane, rec0 and nee),
        first_nee_diffuse=(s.first_nee_diffuse, f32, lane, rec0 and nee),
        first_nee_specular=(s.first_nee_specular, f32, lane, rec0 and nee),
        first_bounce_invpdf=(s.first_bounce_invpdf, f32, lane,
                             rec0 and not last),
        first_bounce_lobe_id=(s.first_bounce_lobe_id, i32, lane,
                              rec0 and not last),
        first_bounce_dir=(s.first_bounce_dir, f32, lane, rec0 and not last),
        first_light_sample_dir=(s.first_light_sample_dir, f32, lane,
                                rec0 and nee and not last),
        lobe_in=(s.first_bounce_lobe_id, i32, lane, rec1),
        first_bounce_reflection_dist=(s.first_bounce_reflection_dist, f32,
                                      lane, rec1),
        palette=(mat_params, f32, (128, 14), True),
        floor_height=(params.floor_height, f32, (), True),
        light_direction=(params.light_direction, f32, (3,), True),
        cos_max=(params.light_cone_cos_theta_max, f32, (), True),
        light_color=(params.light_color, f32, (3,), True),
        strans=(strans, f32, (3,), strans is not None))
    ptrs = []
    for name, k in SLOTS:
        t, dtype, shape, used = table[name]
        comps = (t if k > 1 else (t,)) if used else (None,) * k
        for c in comps:
            if c is not None:
                _cuda.require(c, name, dtype, dev, shape)
            ptrs.append(None if c is None else c.data_ptr())

    err = _shade_fn()((ctypes.c_void_p * N_PTRS)(*ptrs), int(first),
                      int(last), int(nee), feature_bits(feat),
                      float(cfg.light_weight), float(cfg.radiance_clamp), n,
                      _cuda.stream_ptr(dev))
    _cuda.check(err, "shade")
    s.tracing = tracing_out
    if n:
        _cuda.LAUNCHES["shade"] += 1
