"""The plain reference of a progressive still: the path samples of chosen
pixels, traced again from the scene the example script defines, averaged
and blended into a history launch by launch as the program's still path
does, then tonemapped.

The path sample (``trace_sample``) is a frozen copy of the port's
``voxelrt_torch/render/pathtracer.py`` as it runs a still with the default
route: PCG3D draw slots, the camera ray with its TAA jitter, the floor
plane and the voxel grid through the plain traversal (``dda.py``) with the
in-kernel sun-cone NEE at every depth, the Disney BSDF, the deferred
escape sky through the stochastic one-corner fetch and the cone-centre
transmittance (``sky.py``), and the diffuse/specular split. Every random
number is a function of the pixel, the sample's key and the draw slot, so
a pixel's samples come out the same whether its neighbours are traced
beside it or not. The blend (``resolve_still``) is the still branch of the
port's ``render/temporal.py``: the NaN scrub, the running mean of the
history weighted by the samples of the launch, and the sky pixels, which
show the launch's own mean. The tonemap is ``ops/tonemap.py``'s.

What ``prepare_data`` derives (the palette subset and its feature flags,
the traversal tables with the sun-open certificate, the bf16 sky words,
the camera matrices) is worked out again here from the recorded scene.
Imports nothing of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

from . import packing, v3
from .accel import add_sun_open_table, build_pallas_tables
from .bsdf import (ALL_FEATURES, LOBE_DIFFUSE, LOBE_SPEC_REFL, MatFeatures,
                   disney_eval_split_pdf, sample_disney)
from .dda import nee_params, raytrace_plain, upload_tables
from .materials import MaterialList, fetch_material
from .prng import fold_in, key as prng_key, uniform
from .sampling import (EPS, INF, cone_sample_pdf, dot, length,
                       make_orthonormal_basis, mix, normalize, pcg3d,
                       power_heuristic, sample_cone_oriented, saturate,
                       u32_to_uniform)
from .scene import CAMERA_POS, camera_matrices
from .sky import load_sky, sample_skybox_transmittance
from .sky import _sample_skybox_stochastic as sample_skybox
from .tonemap import uchimura
from .transforms import (apply_mat4, screen_to_view_soa,
                         view_to_screen_z_soa, view_to_world_soa,
                         world_to_view_soa)
from .v3 import V3, vclip, vwhere

@dataclasses.dataclass(frozen=True)
class Config:
    """The render settings the reference reads: the configuration file's
    ``render_config`` plus the traffic's image size and samples a launch.
    The palette subset and the NEE source knob are filled from the scene."""

    image_res: tuple
    samples_per_launch: int
    grid_res: int = 128
    voxel_dx: float = 1.0 / 64.0
    max_ray_depth: int = 4
    use_directional_light: bool = True
    radiance_clamp: float = 300.0
    light_weight: float = 3.0
    nee_in_kernel: bool = True
    nee_transmittance: str = "center"
    max_dda_advances: int = 512
    dda_sun_mode: str = "half"
    dda_nee_src_open: str = "auto"
    sky_fetch: str = "stochastic"
    skybox_res: int = 1024
    sky_steps: int = 64
    sky_sun_samples: int = 8
    sky_ms_samples: int = 8
    sky_ms_steps: int = 5
    cloud_steps: int = 32
    cloud_sun_samples: int = 8
    cloud_shadow_steps: int = 8
    cloud_accum_passes: int = 32
    use_physical_sky: bool = False
    use_clouds: bool = False
    vignette_strength: float = 0.9
    vignette_radius: float = 0.0
    vignette_center: tuple = (0.5, 0.5)
    material_features: tuple = ()

    @property
    def grid_offset(self):
        return -(self.grid_res // 2)


SUPPORTED = dict(nee_in_kernel=True, nee_transmittance="center",
                 sky_fetch="stochastic", use_directional_light=True,
                 use_restir_pt=False, sort_rays=False, rng_draws="pcg3d")


def make_config(render_config, image_res, samples_per_launch):
    """The reference's Config of a configuration file's ``render_config``;
    raises on a setting whose route the reference does not trace."""
    for k, v in SUPPORTED.items():
        if k in render_config and render_config[k] != v:
            raise ValueError(f"the reference traces {k}={v!r} only")
    fields = {f.name for f in dataclasses.fields(Config)}
    over = {k: (tuple(v) if isinstance(v, list) else v)
            for k, v in render_config.items() if k in fields}
    return Config(image_res=tuple(image_res),
                  samples_per_launch=int(samples_per_launch), **over)


class Params(NamedTuple):
    camera_pos: torch.Tensor
    proj: torch.Tensor
    proj_inv: torch.Tensor
    view: torch.Tensor
    view_inv: torch.Tensor
    light_direction: torch.Tensor
    light_cone_cos_theta_max: torch.Tensor
    light_color: torch.Tensor
    floor_height: torch.Tensor
    floor_color: torch.Tensor
    floor_material: torch.Tensor
    background_color: torch.Tensor
    max_accum_frames: torch.Tensor
    voxel_edges: torch.Tensor


class SceneData(NamedTuple):
    mat_params: torch.Tensor
    tables: Any
    sky: Any


def prepare(cfg: Config, scene, sky_dir, device):
    """(cfg with the scene's palette flags and NEE knob, SceneData, Params)
    of a recorded scene: the work of the program's ``prepare_data`` and
    ``_params``, done again."""
    mats = MaterialList()
    ids = set(int(i) for i in np.unique(scene.material))
    ids |= {0, 1, 2, int(scene.floor_material)}
    rows = mats.params_np[sorted(ids)]
    feats = tuple(bool(np.any(rows[:, c] != 0.0)) for c in (3, 4, 8, 9, 11))
    # the scene's own sky flags, as the program's Scene puts them in
    cfg = dataclasses.replace(cfg, use_physical_sky=scene.use_physical_sky,
                              use_clouds=scene.use_clouds)
    sky = None
    if cfg.use_physical_sky:
        sky = load_sky(cfg, sky_dir,
                       np.asarray(scene.light_direction, np.float32),
                       np.asarray(scene.light_color, np.float32)
                       * cfg.light_weight,
                       float(scene.light_cone_cos_theta_max), device)
    tables = build_pallas_tables(scene.material, scene.packed_voxels(),
                                 cfg.grid_res)
    tables = add_sun_open_table(
        tables, scene.material,
        np.asarray(scene.light_direction, np.float64),
        float(scene.light_cone_cos_theta_max))
    w = np.asarray(tables.sun_open_words).astype(np.uint32)
    open_frac = float(np.unpackbits(w.view(np.uint8)).sum()) / max(
        (cfg.grid_res // 4) ** 3, 1)
    src_open = cfg.dda_nee_src_open
    if src_open == "auto":
        src_open = "on" if open_frac >= 0.15 else "off"
    cfg = dataclasses.replace(cfg, material_features=feats,
                              dda_nee_src_open=src_open)
    sd = SceneData(mat_params=torch.as_tensor(mats.params_np, device=device),
                   tables=upload_tables(tables, device), sky=sky)

    proj, view = camera_matrices(cfg.image_res[0] / cfg.image_res[1])

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    params = Params(
        camera_pos=f32(np.asarray(CAMERA_POS)),
        proj=f32(proj), proj_inv=f32(np.linalg.inv(proj)),
        view=f32(view), view_inv=f32(np.linalg.inv(view)),
        light_direction=f32(scene.light_direction),
        light_cone_cos_theta_max=f32(scene.light_cone_cos_theta_max),
        light_color=f32(scene.light_color),
        floor_height=f32(scene.floor_height),
        floor_color=f32(scene.floor_color),
        floor_material=torch.tensor(int(scene.floor_material),
                                    dtype=torch.int32, device=device),
        background_color=f32(scene.background_color),
        max_accum_frames=f32(999999999.0),
        voxel_edges=f32(scene.voxel_edges))
    return cfg, sd, params


# --- the path sample ----------------------------------------------------------


class Pcg3dDraws:
    """Per-slot uniform draws: PCG3D of the per-pixel key pair, three slots
    to an evaluation."""

    def __init__(self, k0, k1):
        self._k0, self._k1, self._trip = k0, k1, {}

    def __getitem__(self, slot):
        t, c = divmod(int(slot), 3)
        if t not in self._trip:
            salt = (0x9E3779B9 * (t + 1)) & 0xFFFFFFFF
            self._trip[t] = pcg3d(self._k0, self._k1,
                                  torch.full_like(self._k0, salt))
        return u32_to_uniform(self._trip[t][c])


def firefly_filter(v: V3, cfg) -> V3:
    return vclip(v, 0.0, cfg.radiance_clamp)


def fetch_voxel_surface(uv: V3, color_word, voxel_edges):
    word = color_word.to(torch.int64) & 0xFFFFFFFF
    mat_id = (word >> 24).to(torch.int32)
    color = V3((word & 0xFF).to(torch.float32) / 255.0,
               ((word >> 8) & 0xFF).to(torch.float32) / 255.0,
               ((word >> 16) & 0xFF).to(torch.float32) / 255.0)

    def near_edge(c):
        return ((c < voxel_edges) | (c > 1.0 - voxel_edges)).to(torch.int32)

    count = near_edge(uv.x) + near_edge(uv.y) + near_edge(uv.z)
    color = color * (1.0 - 0.9 * (count >= 2).to(torch.float32))
    return color, mat_id == 2, mat_id


class Hit(NamedTuple):
    closest: torch.Tensor
    normal: V3
    albedo: V3
    hit_light: torch.Tensor
    mat_id: torch.Tensor


def next_hit(cfg, scene, params, pos: V3, d: V3, mask, nee_u):
    """Closest hit of the floor plane and the voxel grid, with the traced
    surface's sun-cone shadow verdict."""
    n = pos.x.shape[0]
    dev = pos.x.device
    closest = torch.full((n,), INF, dtype=torch.float32, device=dev)
    normal = v3.zeros(n, dev)
    albedo = v3.ones(n, dev)
    hit_light = torch.zeros((n,), dtype=torch.bool, device=dev)
    mat_id = torch.zeros((n,), dtype=torch.int32, device=dev)

    dy = d.y
    floor_dist = (params.floor_height - pos.y) / torch.where(
        dy == 0.0, 1e-20, dy)
    hit_pos = pos + d * floor_dist
    extent = length(hit_pos - hit_pos.y)  # the reference's quirky broadcast
    floor_ok = mask & (floor_dist > EPS) & (floor_dist < closest) & (
        extent < 10.0)
    closest = torch.where(floor_ok, floor_dist, closest)
    normal = vwhere(floor_ok, V3(0.0, 1.0, 0.0), normal)
    flip = floor_ok & (dy > 0.0)
    normal = vwhere(flip, -normal, normal)
    albedo = vwhere(floor_ok, v3.splat(params.floor_color), albedo)
    hit_light = torch.where(floor_ok, params.floor_material == 2, hit_light)
    mat_id = torch.where(floor_ok, params.floor_material.to(torch.int32),
                         mat_id)

    inv_size = 1.0 / cfg.voxel_dx
    eye_scaled = pos * inv_size - cfg.grid_offset
    tmax = torch.where(mask, INF, 0.0)
    floor_valid = mask & (floor_dist > EPS) & (extent < 10.0)
    alt_t = torch.where(floor_valid, floor_dist * inv_size, INF)
    ldir = v3.splat(params.light_direction)
    tang_l, bitang_l = make_orthonormal_basis(ldir)
    nee = nee_params(nee_u, alt_t, ldir, tang_l, bitang_l,
                     params.light_cone_cos_theta_max, EPS * inv_size, EPS,
                     dev)
    tr = raytrace_plain(scene.tables, eye_scaled, d, EPS, tmax,
                        cfg.max_dda_advances, nee=nee, alive=mask,
                        any_hit=False, fetch_colors=True,
                        use_sun_open=False, sun_mode=cfg.dda_sun_mode,
                        nee_src_open=cfg.dda_nee_src_open == "on")
    vox_dist = tr.distance * cfg.voxel_dx
    vox_ok = mask & (vox_dist < closest)
    closest = torch.where(vox_ok, vox_dist, closest)
    uv = vclip(eye_scaled + d * tr.distance
               - V3(*(c.to(torch.float32) for c in tr.ipos)), 0.0, 1.0)
    color, v_is_light, v_mat = fetch_voxel_surface(uv, tr.color_word,
                                                   params.voxel_edges)
    normal = vwhere(vox_ok, tr.normal, normal)
    albedo = vwhere(vox_ok, color, albedo)
    hit_light = torch.where(vox_ok, v_is_light, hit_light)
    mat_id = torch.where(vox_ok, v_mat, mat_id)
    return Hit(closest, normal, albedo, hit_light, mat_id), tr.nee_visible


def get_cast_dir(cfg, params, u, v, jitter_u):
    iw, ih = (torch.full((), 1.0 / r, dtype=torch.float32, device=u.device)
              for r in cfg.image_res)
    tc_u = (u + 0.5) * iw / 1.0
    tc_v = (v + 0.5) * ih / 1.0
    j0, j1 = jitter_u
    tc_u = tc_u + (j0 * 2.0 - 1.0) * iw * 0.5
    tc_v = tc_v + (j1 * 2.0 - 1.0) * ih * 0.5
    d = normalize(screen_to_view_soa(tc_u, tc_v, 1.0, params.proj_inv))
    d = view_to_world_soa(d, params.view_inv, 0.0)
    return normalize(d)


def sky_or_background(cfg, scene, params, d: V3, u3: V3, want_trans):
    if cfg.use_physical_sky:
        return sample_skybox(cfg, scene.sky, d, u3, want_trans)
    n = d.x.shape[0]
    scatt = v3.broadcast(v3.splat(params.background_color), n)
    return scatt, (v3.ones(n, d.x.device) if want_trans else None)


def sun_transmittance(cfg, scene, d: V3) -> V3:
    if cfg.use_physical_sky:
        return sample_skybox_transmittance(cfg, scene.sky, d)
    one = torch.ones(d.x.shape, dtype=torch.float32, device=d.x.device)
    return V3(one, one, one)


def trace_sample(cfg, scene, params, u, v, sample_keys, jitter_u):
    """One path sample of each lane at pixel (u, v) with its sample key
    and TAA jitter uniforms. Returns (diffuse V3, specular V3, the primary
    hit's non-linear depth)."""
    n = u.shape[0]
    dev = u.device

    def zf():
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    d = get_cast_dir(cfg, params, u, v, jitter_u)
    pos = v3.broadcast(v3.splat(params.camera_pos), n)
    tracing = ~((u > 1.0 * cfg.image_res[0]) | (v > 1.0 * cfg.image_res[1]))
    contrib = v3.zeros(n, dev)
    throughput = v3.ones(n, dev)
    primary_pos = v3.zeros(n, dev)
    primary_mat_info = torch.zeros((n,), dtype=torch.int64, device=dev)
    first_bounce_lobe_id = torch.zeros((n,), dtype=torch.int32, device=dev)
    first_bounce_invpdf = torch.ones((n,), dtype=torch.float32, device=dev)
    first_nee_diffuse = v3.zeros(n, dev)
    first_nee_specular = v3.zeros(n, dev)
    first_light_sample_bsdf_pdf = torch.ones((n,), dtype=torch.float32,
                                             device=dev)
    is_sky_ray = torch.zeros((n,), dtype=torch.bool, device=dev)
    esc_dir = V3(zf(), torch.ones((n,), dtype=torch.float32, device=dev),
                 zf())
    esc_u3 = v3.zeros(n, dev)
    esc_weight = v3.zeros(n, dev)
    feat = (MatFeatures(*cfg.material_features) if cfg.material_features
            else ALL_FEATURES)

    pid = u.to(torch.int64) * cfg.image_res[1] + v.to(torch.int64)
    kd = fold_in(sample_keys, pid)
    draws = Pcg3dDraws(kd[0], kd[1])
    del kd

    for depth in range(cfg.max_ray_depth):
        base = 8 * depth
        u_nee = (draws[base], draws[base + 1])
        u_bsdf = (draws[base + 2], draws[base + 3], draws[base + 4])
        u_sky = V3(draws[base + 5], draws[base + 6], draws[base + 7])

        hit, knee_vis = next_hit(cfg, scene, params, pos, d, tracing, u_nee)
        hit_mat = fetch_material(scene.mat_params, hit.mat_id, hit.albedo)
        finite_closest = torch.isfinite(hit.closest)
        hit_pos = pos + d * torch.where(finite_closest, hit.closest, 0.0)

        if depth == 0:
            primary_pos = vwhere(tracing & finite_closest, hit_pos,
                                 primary_pos)
            primary_mat_info = torch.where(
                tracing, packing.encode_material_soa(hit.mat_id, hit.albedo),
                primary_mat_info)

        surf = tracing & ~hit.hit_light & finite_closest
        term_sky = tracing & ~hit.hit_light & ~finite_closest
        term_light = tracing & hit.hit_light & finite_closest

        esc_dir = vwhere(term_sky, d, esc_dir)
        esc_u3 = vwhere(term_sky, u_sky, esc_u3)
        esc_weight = vwhere(term_sky, throughput, esc_weight)
        if depth == 0:
            is_sky_ray = term_sky
            primary_pos = vwhere(term_sky, 0.0, primary_pos)
        if depth > 0:
            contrib = contrib + vwhere(term_light, throughput * hit.albedo,
                                       0.0)
        tracing = surf

        spos = hit_pos + hit.normal * EPS
        view = -d
        tang, bitang = make_orthonormal_basis(hit.normal)

        light_dir = sample_cone_oriented(
            params.light_cone_cos_theta_max,
            v3.broadcast(v3.splat(params.light_direction), n), u_nee)
        ndl = dot(light_dir, hit.normal)
        bsdf_d, bsdf_s, light_sample_bsdf_pdf = disney_eval_split_pdf(
            hit_mat, view, hit.normal, light_dir, tang, bitang, feat=feat)
        if depth == 0:
            first_light_sample_bsdf_pdf = torch.where(
                surf, light_sample_bsdf_pdf, first_light_sample_bsdf_pdf)
        shadow_mask = surf & (ndl > 0.0)
        dyl = light_dir.y
        fd = (params.floor_height - spos.y) / torch.where(
            dyl == 0.0, 1e-20, dyl)
        hpf = spos + light_dir * fd
        floor_occ = (fd > EPS) & (length(hpf - hpf.y) < 10.0)
        visible = shadow_mask & (knee_vis != 0) & ~floor_occ
        nee_visible = visible.to(torch.float32)

        light_mis = torch.ones((), dtype=torch.float32, device=dev)
        if depth > 0:
            light_pdf = cone_sample_pdf(params.light_cone_cos_theta_max, 1.0)
            light_mis = power_heuristic(light_pdf, light_sample_bsdf_pdf)
        strans = sun_transmittance(
            cfg, scene, v3.load(params.light_direction[None, :]))
        scale = ((light_mis * cfg.light_weight * torch.clamp(ndl, min=0.0))
                 * v3.splat(params.light_color) * strans)
        nee_d = bsdf_d * scale
        nee_s = bsdf_s * scale
        if depth == 0:
            first_nee_diffuse = first_nee_diffuse + vwhere(
                visible, firefly_filter(throughput * nee_d, cfg), 0.0)
            first_nee_specular = first_nee_specular + vwhere(
                visible, firefly_filter(throughput * nee_s, cfg), 0.0)
        else:
            contrib = contrib + vwhere(
                visible, firefly_filter(throughput * (nee_d + nee_s), cfg),
                0.0)

        if depth == cfg.max_ray_depth - 1:
            break
        new_d, bsdf, pdf, lobe = sample_disney(hit_mat, view, hit.normal,
                                               tang, bitang, u_bsdf,
                                               feat=feat)
        bounce_weight = bsdf * saturate(dot(new_d, hit.normal))
        if depth == 0:
            first_bounce_invpdf = torch.where(surf, 1.0 / pdf,
                                              first_bounce_invpdf)
            first_bounce_lobe_id = torch.where(surf, lobe,
                                               first_bounce_lobe_id)
        else:
            bounce_weight = bounce_weight / pdf
            bsdf_light_pdf = cone_sample_pdf(
                params.light_cone_cos_theta_max,
                dot(v3.splat(params.light_direction), new_d))
            bounce_weight = bounce_weight * power_heuristic(
                pdf, nee_visible * bsdf_light_pdf)
        throughput = vwhere(surf, throughput * bounce_weight, throughput)
        d = vwhere(surf, new_d, d)
        pos = vwhere(surf, spos, pos)
    del draws

    # the deferred escape sky, the cone-centre transmittance in the sun disk
    esc_any = v3.any_nonzero(esc_weight)
    sky_scatt, sky_trans = sky_or_background(
        cfg, scene, params, esc_dir, esc_u3,
        want_trans=not cfg.use_physical_sky)
    if sky_trans is None:
        sky_trans = sun_transmittance(
            cfg, scene, v3.load(params.light_direction[None, :]))
    hit_sun = (dot(v3.splat(params.light_direction), esc_dir)
               >= params.light_cone_cos_theta_max).to(torch.float32)
    sky_emission = firefly_filter(
        sky_scatt + sky_trans * cfg.light_weight
        * v3.splat(params.light_color) * hit_sun, cfg)
    contrib = contrib + vwhere(esc_any, esc_weight * sky_emission, 0.0)

    gbuff_depth = view_to_screen_z_soa(
        world_to_view_soa(primary_pos, params.view), params.proj)

    light_pdf_one = cone_sample_pdf(params.light_cone_cos_theta_max, 1.0)
    light_sample_mis = power_heuristic(light_pdf_one,
                                       first_light_sample_bsdf_pdf)
    apply = ~is_sky_ray
    nee_d_out = vwhere(apply, first_nee_diffuse * light_sample_mis,
                       first_nee_diffuse)
    nee_s_out = vwhere(apply, first_nee_specular * light_sample_mis,
                       first_nee_specular)

    prim_mat_id, prim_albedo = packing.decode_material_word_soa(
        primary_mat_info)
    emission = vwhere(prim_mat_id == 2, prim_albedo, 0.0)
    lobe_diff = first_bounce_lobe_id == LOBE_DIFFUSE
    lobe_spec = first_bounce_lobe_id == LOBE_SPEC_REFL
    diffuse = vwhere(lobe_diff, contrib * first_bounce_invpdf + emission,
                     0.0) + nee_d_out
    specular = vwhere(lobe_spec, contrib * first_bounce_invpdf, 0.0) + \
        nee_s_out
    return diffuse, specular, gbuff_depth


# --- a launch's keys ------------------------------------------------------------


def launch_keys(key, k):
    """A launch's k sample keys and their (k, 2) TAA jitter uniforms."""
    skeys = [key] + [fold_in(key, 7000 + i) for i in range(1, k)]
    jkeys = [fold_in(sk, 417) for sk in skeys]
    jit = uniform(tuple(torch.tensor([jk[w] for jk in jkeys],
                                     dtype=torch.int64) for w in (0, 1)),
                  (2,), "cpu")
    return skeys, jit


# --- the blend into the history and the tonemap ----------------------------------


def _texcoords(cfg, px, py):
    w, h = cfg.image_res
    tx = (px.to(torch.float32) + 0.5) / (w * 1.0)
    ty = (py.to(torch.float32) + 0.5) / (h * 1.0)
    return torch.stack([tx, ty], dim=-1)


def _skip(cfg, params, px, py, depth):
    """Pixels whose primary ray escaped (the G-buffer's position at the
    origin): the history is left as it is there."""
    uv = _texcoords(cfg, px, py)
    ndc = torch.stack([uv[..., 0] * 2.0 - 1.0, uv[..., 1] * 2.0 - 1.0,
                       depth * 2.0 - 1.0], dim=-1)
    pos = apply_mat4(params.proj_inv, ndc, 1.0)
    x1 = apply_mat4(params.view_inv, pos[..., :3] / pos[..., 3:4], 1.0)[
        ..., :3]
    return (x1[..., 0] * x1[..., 0] + x1[..., 1] * x1[..., 1]
            + x1[..., 2] * x1[..., 2]) < 1e-7


def _scrub(c):
    bad = torch.any(~torch.isfinite(c) | (c < 0.0), dim=-1, keepdim=True)
    return torch.where(bad, 0.0, c)


def _blend(hist, current, sample_weight, max_accum):
    new_w = torch.minimum(hist[..., 3] + sample_weight, max_accum)
    blended = mix(hist[..., 0:3], current[..., 0:3],
                  (sample_weight / new_w)[..., None])
    return torch.cat([blended, new_w[..., None]], dim=-1)


def resolve_still(cfg, params, px, py, state, diffuse, specular, depth,
                  dtype=torch.float32):
    """One launch's blend for the chosen pixels: ``state`` = (history,
    history_spec), (P, 4) each; ``diffuse``, ``specular``: the launch's
    sample means (P, 3); ``depth``: its first sample's primary depth.
    Returns (colour (P, 3), new state). ``dtype``: the precision of the
    blend (the control's lower precision)."""
    k = float(cfg.samples_per_launch)
    history, history_spec = state
    color = _scrub(diffuse)
    color_spec = _scrub(specular)
    skip = _skip(cfg, params, px, py, depth)[..., None]
    max_accum = params.max_accum_frames.to(dtype)
    hist_out = _blend(history, color.to(dtype), k, max_accum)
    new_history = torch.where(skip, history, hist_out)
    out = torch.where(skip, color.to(dtype), hist_out[..., 0:3])
    spec_out = _blend(history_spec, color_spec.to(dtype), k, max_accum)
    new_history_spec = torch.where(skip, history_spec, spec_out)
    out = torch.where(skip, out, out + spec_out[..., 0:3])
    return out, (new_history, new_history_spec)


def tonemap(cfg, exposure, px, py, hdr):
    """The display transform of the chosen pixels' HDR colour."""
    w, h = cfg.image_res
    cx, cy = (float(c) for c in cfg.vignette_center)
    du = px.to(torch.float32) / w - cx
    dv = py.to(torch.float32) / h - cy
    dist = torch.sqrt(du * du + dv * dv)
    darken = 1.0 - cfg.vignette_strength * torch.clamp(
        dist - cfg.vignette_radius, min=0.0)
    return saturate(torch.pow(uchimura(hdr * darken[..., None] * exposure),
                              1.0 / 2.2))


# --- a still, replayed ------------------------------------------------------------


def render_stills(cfg, sd, params, exposure, pixels, stills,
                  max_lanes=1 << 22, dtype=torch.float32):
    """The HDR colour and the tonemapped value of ``pixels`` (flat ids
    x * H + y, an int64 tensor on the render device) at the end of each
    still of ``stills``, a list of the launch keys that went into each, in
    order, from an empty history: each launch traces ``samples_per_launch``
    samples of every chosen pixel, takes their mean and blends it in. The
    launches of all stills go through ``trace_sample`` together, in blocks
    of whole launches of at most ``max_lanes`` lanes. ``dtype``: the
    precision of the samples' radiance, their mean and the blend (float32
    here; bfloat16 is the control). Returns a list of (hdr (P, 3), ldr (P,
    3)) a still, float32."""
    dev = pixels.device
    h = cfg.image_res[1]
    k = cfg.samples_per_launch
    p = pixels.shape[0]
    px, py = pixels // h, pixels % h
    if not all(stills):
        raise ValueError("a still without launches")
    launches = [(si, lk) for si, keys in enumerate(stills) for lk in keys]
    cur, state, out, results = None, None, None, []

    def still_end():
        hdr = out.to(torch.float32)
        results.append((hdr, tonemap(cfg, exposure, px, py, hdr)))

    per_block = max(1, max_lanes // max(1, k * p))
    for b0 in range(0, len(launches), per_block):
        block = launches[b0:b0 + per_block]
        keys0, keys1, jits = [], [], []
        for _, lk in block:
            skeys, jit = launch_keys(lk, k)
            keys0 += [sk[0] for sk in skeys]
            keys1 += [sk[1] for sk in skeys]
            jits.append(jit)
        nb = len(block)
        # lane (launch j, sample s, pixel i) at (j * k + s) * p + i
        ks = torch.arange(nb * k, device=dev).repeat_interleave(p)
        k0 = torch.tensor(keys0, dtype=torch.int64, device=dev)[ks]
        k1 = torch.tensor(keys1, dtype=torch.int64, device=dev)[ks]
        jit = torch.cat(jits).to(dev)[ks]
        u = px.to(torch.float32).repeat(nb * k)
        v = py.to(torch.float32).repeat(nb * k)
        diffuse, specular, depth = trace_sample(cfg, sd, params, u, v,
                                                (k0, k1),
                                                (jit[:, 0], jit[:, 1]))
        dif = v3.stack(diffuse).to(dtype).reshape(nb, k, p, 3)
        spe = v3.stack(specular).to(dtype).reshape(nb, k, p, 3)
        dep = depth.reshape(nb, k, p)
        for j, (si, _) in enumerate(block):
            if si != cur:  # a new still starts from an empty history
                if cur is not None:
                    still_end()
                cur = si
                state = (torch.zeros((p, 4), dtype=dtype, device=dev),
                         torch.zeros((p, 4), dtype=dtype, device=dev))
            acc_d, acc_s = dif[j, 0], spe[j, 0]
            for s_ in range(1, k):
                acc_d = acc_d + dif[j, s_]
                acc_s = acc_s + spe[j, s_]
            out, state = resolve_still(cfg, params, px, py, state, acc_d / k,
                                       acc_s / k, dep[j, 0], dtype)
    if cur is not None:
        still_end()
    return results


def render_key(seed):
    """The render key of a run's seed, as the program's ``prng.key``."""
    return prng_key(seed)


def chunk_launch_keys(render_key_, key_data, n_launches):
    """The keys of a chunk's launches: the chunk keyed fold_in(render key,
    key_data), its launch j fold_in(chunk key, j)."""
    ck = fold_in(render_key_, key_data)
    return [fold_in(ck, j) for j in range(n_launches)]


__all__ = ["Config", "make_config", "prepare", "render_stills",
           "chunk_launch_keys", "render_key", "trace_sample"]
