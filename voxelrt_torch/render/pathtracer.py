"""Wavefront path-tracing sample pass (the PyTorch port of
voxelrt/render/pathtracer.py, kernel path).

One call traces one progressive sample for every ray of a wavefront: ray
generation, a statically unrolled 4-deep bounce loop with NEE + MIS against
the sun cone light, sky/emissive termination, the deferred escape sky, and
the diffuse/specular split + G-buffer epilogue. Traversal goes through
kernel B1 (ops/dda_kernel.py): with ``nee_in_kernel`` (the default) one
closest-hit dispatch per depth that also traces the sun-cone shadow ray,
without it a closest-hit dispatch and a separate any-hit sun-shadow dispatch
per depth. Each depth's shading (BSDF, NEE, MIS, the escape and emissive
terminations) is one launch of the shade kernel (ops/shade_kernel.py) on
the card's still and moving-frame paths, and its plain twin
``shade_depth_eager`` elsewhere. The escape sky goes through kernels B2/B3
(sky/atmos.py):
``sky_fetch='stochastic'`` reads one corner per ray through B2,
``'bilinear'`` four corners of both maps through B3 over the whole
wavefront; ``nee_transmittance='per_ray'`` runs B3 per light direction at
every depth.

Reference quirks preserved on purpose (they are part of the image):
  * cone pdf that ignores orientation (renderer/math_utils.py:61-65);
  * the first-bounce BSDF-sample MIS weight is applied only to the ReSTIR
    reservoir copy of the integrand, NOT to the displayed contrib
    (renderer/pathtracer.py:571-574 vs :615);
  * firefly clamp at 300 (renderer/pathtracer.py:20-24);
  * light_weight = 3.0 multiplier (renderer/pathtracer.py:144);
  * emission is only added to the diffuse channel when the first-bounce lobe
    is diffuse (renderer/pathtracer.py:615);
  * Russian roulette disabled (renderer/pathtracer.py:527-533).

Divergence from the reference: an escaped first bounce adds a large finite
reflection distance instead of the reference's inf (which poisons its
reflection-depth G-buffer with NaNs, renderer/pathtracer.py:414-417,543-547).

Every mode of the JAX package's ``trace_sample`` runs here:

* ``use_restir_pt``: the sky is fetched inline at every depth (its rc
  bookkeeping needs per-depth values), the NEE transmittance per ray, no
  in-kernel NEE; the sample's input reservoir (the rc vertex, the NEE
  sample's WRS) comes back in ``out["reservoir"]`` for the spatial GRIS
  pass (render/restir.py);
* ``sort_rays``: the non-primary dispatches go to B1 in (alive,
  origin-cell morton, direction octant) order and come back in ray order
  (``_trace_voxels_sorted``); in-kernel NEE is off;
* ``rng_draws='table'``: a (8·depth+1)-slot threefry table per ray instead
  of the PCG3D slots.
"""

from __future__ import annotations

import types
from typing import Any, NamedTuple

import torch

from voxelrt_torch.materials import fetch_material
from voxelrt_torch.ops import (dda_kernel, draws_kernel, hit_kernel,
                                packing, shade_kernel, v3)
from voxelrt_torch.ops.bsdf import (
    ALL_FEATURES,
    LOBE_DIFFUSE,
    LOBE_SPEC_REFL,
    MatFeatures,
    disney_eval_split_pdf,
    sample_disney,
)
from voxelrt_torch.ops.dda_kernel import raytrace
from voxelrt_torch.ops.prng import fold_in, uniform
from voxelrt_torch.ops.shade_kernel import shade_kernel_applies
from voxelrt_torch.ops.sampling import (
    EPS,
    INF,
    cone_sample_pdf,
    dot,
    is_vec_zero,
    length,
    luminance,
    make_orthonormal_basis,
    normalize,
    pcg3d,
    power_heuristic,
    sample_cone_oriented,
    saturate,
    u32_to_uniform,
)
from voxelrt_torch.ops.transforms import (
    linearize_depth,
    screen_to_view_soa,
    view_to_screen_z_soa,
    view_to_world_soa,
    world_to_view_soa,
)
from voxelrt_torch.ops.v3 import V3, vclip, vwhere
from voxelrt_torch.utils import profiling

SKY_REFLECTION_DIST = 1.0e4  # finite stand-in for the reference's inf


class SceneData(NamedTuple):
    """Device-side scene (see voxelrt_torch.world.VoxelWorld)."""

    occ_words: torch.Tensor  # int32 bits of the packed occupancy pyramid
    voxels: torch.Tensor  # int32 bits of r | g<<8 | b<<16 | mat<<24, z-major
    mat_params: torch.Tensor  # f32[128, 14] Disney palette
    sky: Any = None  # sky.atmos.SkyData when physical sky enabled
    tables: Any = None  # ops.dda_kernel.DeviceTables


class RenderParams(NamedTuple):
    """Per-frame values (the reference's 0-D fields), float32 tensors on the
    render device."""

    camera_pos: torch.Tensor  # (3,)
    proj: torch.Tensor  # (4,4)
    proj_inv: torch.Tensor
    view: torch.Tensor
    view_inv: torch.Tensor
    prev_proj: torch.Tensor
    prev_view: torch.Tensor
    prev_camera_pos: torch.Tensor
    light_direction: torch.Tensor  # (3,) normalized
    light_cone_cos_theta_max: torch.Tensor  # ()
    light_color: torch.Tensor  # (3,)
    floor_height: torch.Tensor  # ()
    floor_color: torch.Tensor  # (3,)
    floor_material: torch.Tensor  # () int32
    background_color: torch.Tensor  # (3,)
    max_accum_frames: torch.Tensor  # ()
    taa_jitter: torch.Tensor  # (2,)
    frame_idx: torch.Tensor  # () int32
    voxel_edges: torch.Tensor  # () f32


def mat_features(cfg) -> MatFeatures:
    """Static Disney feature flags for this scene's palette subset (baked
    into cfg by HeadlessRenderer.prepare_data); () = unknown = all on."""
    if cfg.material_features:
        return MatFeatures(*cfg.material_features)
    return ALL_FEATURES


class Pcg3dDraws:
    """Per-slot uniform draws: ``draws[slot]`` hashes the per-pixel key pair
    with PCG3D (pathtracer.py:123-141); slots group 3 to a PCG3D evaluation,
    which is cached here. On the card kernel D (ops/draws_kernel.py) draws
    the same bits."""

    def __init__(self, k0, k1):
        self._k0 = k0
        self._k1 = k1
        self._trip = {}

    def __getitem__(self, slot):
        t, c = divmod(int(slot), 3)
        if t not in self._trip:
            salt = (0x9E3779B9 * (t + 1)) & 0xFFFFFFFF
            self._trip[t] = pcg3d(self._k0, self._k1,
                                  torch.full_like(self._k0, salt))
        return u32_to_uniform(self._trip[t][c])


def march_unroll_of(cfg) -> int:
    """Resolve config.dda_march_unroll as the JAX package does
    (pathtracer.py:143-149): the app shell replaces 'auto' with a
    scene-class int; configs built without the shell resolve to 3. The
    port's kernel does not read it (per-ray results do not depend on it)."""
    u = cfg.dda_march_unroll
    return u if isinstance(u, int) else 3


def draw_table(cfg, kd):
    """The table draws (``rng_draws='table'``, pathtracer.py:577-581): the
    8·max_ray_depth+1 threefry uniforms of each ray's key ``kd`` = (k0,
    k1), drawn on the rays' device, as an (n_draws, N) float32 tensor whose
    row ``slot`` is that slot's draw for every ray."""
    n_draws = 8 * cfg.max_ray_depth + 1
    return uniform(kd, (n_draws,), kd[0].device).t().contiguous()


def firefly_filter(v: V3, cfg) -> V3:
    """renderer/pathtracer.py:22-24."""
    return vclip(v, 0.0, cfg.radiance_clamp)


def fetch_voxel_surface(cfg, ipos: V3, uv: V3, color_word, voxel_edges):
    """Voxel surface color + edge darkening (renderer/voxel_world.py:34-56),
    from the packed voxel word the traversal kernel fetched. Returns
    (color, is_light, mat_id)."""
    word = color_word.to(torch.int64) & 0xFFFFFFFF
    mat_id = (word >> 24).to(torch.int32)
    color = V3(
        (word & 0xFF).to(torch.float32) / 255.0,
        ((word >> 8) & 0xFF).to(torch.float32) / 255.0,
        ((word >> 16) & 0xFF).to(torch.float32) / 255.0,
    )
    boundary = voxel_edges

    def near_edge(c):
        return ((c < boundary) | (c > 1.0 - boundary)).to(torch.int32)

    count = near_edge(uv.x) + near_edge(uv.y) + near_edge(uv.z)
    f = (count >= 2).to(torch.float32)
    color = color * (1.0 - 0.9 * f)
    return color, mat_id == 2, mat_id


class Hit(NamedTuple):
    closest: torch.Tensor  # (N,) world-space distance (inf = miss)
    normal: V3
    albedo: V3
    hit_light: torch.Tensor  # (N,) bool
    mat_id: torch.Tensor  # (N,) int32
    iters: torch.Tensor  # (N,) int32 traversal advance count


def _morton3(x, y, z):
    """Morton code of three cell coordinates below 256 (the JAX package's
    ops/dda_pallas.py:_morton3)."""
    def part1by2(v):
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        return (v | (v << 2)) & 0x09249249

    return part1by2(x) | (part1by2(y) << 1) | (part1by2(z) << 2)


SORT_DEAD = 0x7FFFFFFF  # routing key of a masked-off ray: sorts last


def routing_key(cfg, origin: V3, d: V3, mask):
    """The sorted route's key of each ray (pathtracer.py:219-231): the
    morton code of its origin's 4^3 cell, shifted left 3, or'ed with its
    direction octant; SORT_DEAD for a masked-off ray."""
    r2 = cfg.grid_res // 4
    cell = [torch.clamp(c.to(torch.int32) >> 2, 0, r2 - 1) for c in origin]
    octant = ((d.x > 0).to(torch.int32) + 2 * (d.y > 0).to(torch.int32)
              + 4 * (d.z > 0).to(torch.int32))
    key = (_morton3(*cell) << 3) | octant
    return torch.where(mask, key, SORT_DEAD)


def _trace_voxels_sorted(cfg, tables, origin: V3, d: V3, mask, shadow_ray,
                         sun_shadow):
    """B1 on the rays in (alive, origin-cell morton, direction octant)
    order, the outputs scattered back to ray order (pathtracer.py:200-275):
    one sort of the routing keys, origin and direction gathered, dead rays
    traced with tmax 0 and marked dead, so they come back as the unsorted
    route's canonical miss. The order among equal keys is not part of the
    result: every per-ray output is the unsorted route's."""
    key = routing_key(cfg, origin, d, mask)
    skey, sidx = torch.sort(key)
    alive = skey != SORT_DEAD
    so = V3(*(c[sidx] for c in origin))
    sd = V3(*(c[sidx] for c in d))
    stmax = torch.where(alive, INF, 0.0)
    tr = raytrace(tables, so, sd, EPS, stmax, cfg.max_dda_advances,
                  alive=alive, any_hit=shadow_ray,
                  fetch_colors=not shadow_ray, use_sun_open=sun_shadow)

    def unsort(x):
        if x is None:
            return None
        if isinstance(x, V3):
            return V3(*(unsort(c) for c in x))
        out = torch.empty_like(x)
        out[sidx] = x
        return out

    return tr._replace(**{f: unsort(getattr(tr, f)) for f in (
        "distance", "ipos", "normal", "iters", "color_word", "active")})


def floor_plane(params, pos: V3, d: V3, mask):
    """The implicit floor plane's crossing (renderer/pathtracer.py:152-190):
    (floor_dist, floor_valid), the distance along each ray and whether the
    crossing counts (a tracing ray, ahead of it, inside the extent)."""
    dy = d.y
    floor_dist = (params.floor_height - pos.y) / torch.where(
        dy == 0.0, 1e-20, dy)
    hit_pos = pos + d * floor_dist
    # The reference's extent check subtracts the scalar dot(hit_pos, normal)
    # from the vector hit_pos (a quirky broadcast) — reproduced verbatim.
    extent = length(hit_pos - hit_pos.y)
    return floor_dist, mask & (floor_dist > EPS) & (extent < 10.0)


def grid_origin(cfg, pos: V3) -> V3:
    """World positions in B1's grid space (world_to_voxel)."""
    return pos * (1.0 / cfg.voxel_dx) - cfg.grid_offset


def hit_prepare_eager(cfg, params, pos: V3, d: V3, mask, nee, floor=None):
    """B1's inputs for a ``next_hit`` dispatch: (the grid-space origin,
    tmax, and with ``nee`` the floor crossing in grid units, inf where the
    floor is not crossed, else None). The plain twin of kernel H's
    ``hit_prepare`` (ops/hit_kernel.py); ``floor``: ``floor_plane``'s
    result where the caller has it."""
    origin = grid_origin(cfg, pos)
    tmax = torch.where(mask, INF, 0.0)
    if not nee:
        return origin, tmax, None
    floor_dist, floor_valid = (floor if floor is not None
                               else floor_plane(params, pos, d, mask))
    alt_t = torch.where(floor_valid, floor_dist * (1.0 / cfg.voxel_dx), INF)
    return origin, tmax, alt_t


def hit_merge_eager(cfg, params, pos: V3, d: V3, mask, tr, floor=None,
                    any_hit=False):
    """The closest of the floor plane and B1's voxel hit ``tr``
    (renderer/pathtracer.py:218-244): (closest, normal, albedo, hit_light,
    mat_id), the fields of ``Hit`` before ``iters``. The plain twin of
    kernel H's ``hit_merge`` (ops/hit_kernel.py); ``floor``:
    ``floor_plane``'s result where the caller has it; ``any_hit``: only
    ``closest`` is meaningful, and the voxel's surface is not decoded."""
    n = pos.x.shape[0]
    dev = pos.x.device
    floor_dist, floor_valid = (floor if floor is not None
                               else floor_plane(params, pos, d, mask))
    closest = torch.full((n,), INF, dtype=torch.float32, device=dev)
    normal = v3.zeros(n, dev)
    albedo = v3.ones(n, dev)
    hit_light = torch.zeros((n,), dtype=torch.bool, device=dev)
    mat_id = torch.zeros((n,), dtype=torch.int32, device=dev)

    floor_ok = floor_valid & (floor_dist < closest)
    closest = torch.where(floor_ok, floor_dist, closest)
    normal = vwhere(floor_ok, V3(0.0, 1.0, 0.0), normal)
    # Floor normal flip (pathtracer.py:186-187).
    flip = floor_ok & (d.y > 0.0)
    normal = vwhere(flip, -normal, normal)
    albedo = vwhere(floor_ok, v3.splat(params.floor_color), albedo)
    hit_light = torch.where(floor_ok, params.floor_material == 2, hit_light)
    mat_id = torch.where(floor_ok, params.floor_material.to(torch.int32),
                         mat_id)

    # --- voxel grid (renderer/pathtracer.py:192-216)
    vox_dist = tr.distance * cfg.voxel_dx
    vox_ok = mask & (vox_dist < closest)
    closest = torch.where(vox_ok, vox_dist, closest)
    if any_hit:
        return closest, normal, albedo, hit_light, mat_id
    uv = vclip(grid_origin(cfg, pos) + d * tr.distance
               - V3(*(c.to(torch.float32) for c in tr.ipos)), 0.0, 1.0)
    color, v_is_light, v_mat = fetch_voxel_surface(
        cfg, tr.ipos, uv, tr.color_word, params.voxel_edges)
    normal = vwhere(vox_ok, tr.normal, normal)
    albedo = vwhere(vox_ok, color, albedo)
    hit_light = torch.where(vox_ok, v_is_light, hit_light)
    mat_id = torch.where(vox_ok, v_mat, mat_id)
    return closest, normal, albedo, hit_light, mat_id


def nee_launch_scalars(cfg, params, device):
    """B1's in-kernel NEE launch scalars (``dda_kernel.nee_scalars``): the
    cone's axis and its basis, its cosine, the shadow origin's offset in
    grid units and the shadow rays' tmin. They depend on ``params`` alone,
    so ``trace_sample`` makes them once."""
    ldir = v3.splat(params.light_direction)
    tang_l, bitang_l = make_orthonormal_basis(ldir)
    return dda_kernel.nee_scalars(ldir, tang_l, bitang_l,
                                  params.light_cone_cos_theta_max,
                                  EPS * (1.0 / cfg.voxel_dx), EPS, device)


def next_hit(cfg, scene, params, pos: V3, d: V3, mask, shadow_ray=False,
             sun_shadow=False, nee_u=None, coherent=False, nee_scalars=None):
    """Closest hit of floor plane + voxel grid (renderer/pathtracer.py:218-244).

    mask: rays to trace; the others are dead lanes of the traversal kernel.
    ``shadow_ray``: an any-hit dispatch (B1's shadow mode): only ``closest``
    of the result is meaningful, finite when something blocks the ray.
    ``sun_shadow`` marks shadow rays sampled within the sun's NEE cone, for
    which the kernel may use its sun-visibility certificate
    (``use_sun_open``; the verdicts are the same without it).
    ``nee_u``: (u0, u1) cone uniforms enabling in-kernel NEE; returns
    (Hit, nee_visible) then, a plain Hit otherwise. The floor crossing is
    the kernel's alternative shadow origin; floor OCCLUSION of the shadow
    ray stays a closed-form check in the caller. ``nee_scalars``: the NEE
    launch scalars (``nee_launch_scalars``), made here when not given.
    ``coherent`` marks rays already in screen-tile order (the primaries),
    which skip the sorted route of ``sort_rays``.

    A closest-hit call on the card forms B1's inputs and the Hit in kernel
    H's two launches (``hit_kernel_applies``); any-hit calls and the CPU
    run their twins ``hit_prepare_eager`` and ``hit_merge_eager``."""
    card = not shadow_ray and hit_kernel.hit_kernel_applies(cfg,
                                                            pos.x.device)
    with_nee = nee_u is not None
    floor = None
    if card:
        origin, tmax, alt_t = hit_kernel.hit_prepare(cfg, params, pos, d,
                                                     mask, with_nee)
    else:
        floor = floor_plane(params, pos, d, mask)
        origin, tmax, alt_t = hit_prepare_eager(cfg, params, pos, d, mask,
                                                with_nee, floor)
    nee = None
    if with_nee:
        if nee_scalars is None:
            nee_scalars = nee_launch_scalars(cfg, params, pos.x.device)
        nee = dict(u0=nee_u[0], u1=nee_u[1], alt_t=alt_t,
                   scalars=nee_scalars)
    if cfg.sort_rays and not coherent:
        if nee is not None:
            raise ValueError("the sorted route has no in-kernel NEE")
        tr = _trace_voxels_sorted(cfg, scene.tables, origin, d, mask,
                                  shadow_ray, sun_shadow)
    else:
        tr = raytrace(scene.tables, origin, d, EPS, tmax,
                      cfg.max_dda_advances, nee=nee, alive=mask,
                      any_hit=shadow_ray, fetch_colors=not shadow_ray,
                      use_sun_open=sun_shadow, sun_mode=cfg.dda_sun_mode,
                      nee_src_open=cfg.dda_nee_src_open == "on")
    if card:
        fields = hit_kernel.hit_merge(cfg, params, pos, d, mask, tr)
    else:
        fields = hit_merge_eager(cfg, params, pos, d, mask, tr, floor,
                                 shadow_ray)
    hit_out = Hit(*fields, tr.iters)
    if with_nee:
        return hit_out, tr.nee_visible
    return hit_out


def get_cast_dir(cfg, params, u, v, camera_is_moving: bool,
                 render_scale: float, jitter_u):
    """Primary ray directions (renderer/pathtracer.py:293-312); ``jitter_u``
    holds the per-ray (u0, u1) TAA jitter uniforms of each ray's sample."""
    # 0-d tensors filled on the ray device (no host-to-device copy)
    iw, ih = (torch.full((), 1.0 / r, dtype=torch.float32, device=u.device)
              for r in cfg.image_res)
    tc_u = (u + 0.5) * iw / render_scale
    tc_v = (v + 0.5) * ih / render_scale
    if not camera_is_moving:
        j0, j1 = jitter_u
        tc_u = tc_u + (j0 * 2.0 - 1.0) * iw * 0.5
        tc_v = tc_v + (j1 * 2.0 - 1.0) * ih * 0.5
    d = normalize(screen_to_view_soa(tc_u, tc_v, 1.0, params.proj_inv))
    d = view_to_world_soa(d, params.view_inv, 0.0)
    return normalize(d)


def sample_sky(cfg, scene, params, d: V3, u3: V3, want_trans=True):
    """Sky radiance for escaped rays: constant background or the precomputed
    skybox (renderer/pathtracer.py:499-517)."""
    if cfg.use_physical_sky:
        from voxelrt_torch.sky.atmos import sample_skybox

        return sample_skybox(cfg, scene.sky, d, u3, want_trans=want_trans)
    n = d.x.shape[0]
    scatt = v3.broadcast(v3.splat(params.background_color), n)
    if not want_trans:
        return scatt, None
    return scatt, v3.ones(n, d.x.device)


def _sky_emission(cfg, params, d, scatt, trans):
    """Escape radiance: in-scatter + sun disk through the transmittance
    (renderer/pathtracer.py:499-517)."""
    hit_sun = (dot(v3.splat(params.light_direction), d)
               >= params.light_cone_cos_theta_max).to(torch.float32)
    return firefly_filter(
        scatt + trans * cfg.light_weight * v3.splat(params.light_color)
        * hit_sun, cfg)


def sky_transmittance(cfg, scene, d: V3) -> V3:
    """Sun transmittance for NEE (renderer/pathtracer.py:465-466)."""
    if cfg.use_physical_sky:
        from voxelrt_torch.sky.atmos import sample_skybox_transmittance

        return sample_skybox_transmittance(cfg, scene.sky, d)
    one = torch.ones(d.x.shape, dtype=torch.float32, device=d.x.device)
    return V3(one, one, one)


def _light_dir_1(params) -> V3:
    """The cone-centre direction as a V3 of (1,) components."""
    return v3.load(params.light_direction[None, :])


def nee_transmittance(cfg, scene, params, light_dir: V3) -> V3:
    """Sun transmittance for a cone-sampled NEE direction set:
    'center' evaluates the skybox once at the cone centre (a 1-lane B3
    fetch broadcast over the wavefront), 'per_ray' per direction. ReSTIR
    always fetches per ray: its GRIS shift re-evaluates stored NEE terms
    and must see the same transmittance function."""
    if (cfg.nee_transmittance == "center" and cfg.use_physical_sky
            and not cfg.use_restir_pt):
        return sky_transmittance(cfg, scene, _light_dir_1(params))
    return sky_transmittance(cfg, scene, light_dir)


class PathState(types.SimpleNamespace):
    """The bounce loop's per-ray state in ``trace_sample``: the path
    (``pos``, ``d``, ``tracing``, ``throughput``, ``contrib``), the deferred
    escape record (``esc_dir``, ``esc_u3``, ``esc_weight``), the depth-0
    records (``primary_*``, ``first_*``, ``is_sky_ray``), depth 1's
    ``first_bounce_reflection_dist`` and, under ReSTIR, ``rc``,
    ``throughput_after_rc`` and ``rc_bounce_lobe_id``."""


def start_state(cfg, params, d: V3, inside) -> PathState:
    """The loop's state before depth 0. Every V3 but ``d`` is a (3, n)
    buffer of its own, ``pos`` included, since the shade kernel updates them
    in place (the eager twin replaces them)."""
    n = d.x.shape[0]
    dev = d.x.device

    def zf():
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    def vfull(value):
        return V3(*torch.full((3, n), value, dtype=torch.float32,
                              device=dev))

    pos = V3(*params.camera_pos[:, None].expand(3, n).contiguous())
    s = PathState(
        pos=pos, d=d, tracing=inside,
        contrib=vfull(0.0), throughput=vfull(1.0),
        primary_normal_oct=(
            torch.zeros((n,), dtype=torch.float16, device=dev),
            torch.zeros((n,), dtype=torch.float16, device=dev)),
        primary_pos=vfull(0.0),
        primary_mat_info=torch.zeros((n,), dtype=torch.int64, device=dev),
        primary_albedo=vfull(1.0),
        first_bounce_lobe_id=torch.zeros((n,), dtype=torch.int32,
                                         device=dev),
        first_bounce_invpdf=torch.ones((n,), dtype=torch.float32,
                                       device=dev),
        first_nee_diffuse=vfull(0.0),
        first_nee_specular=vfull(0.0),
        first_bounce_dir=vfull(0.0),
        first_light_sample_dir=vfull(0.0),
        first_light_sample_bsdf_pdf=torch.ones((n,), dtype=torch.float32,
                                               device=dev),
        first_bounce_reflection_dist=zf(),
        is_sky_ray=torch.zeros((n,), dtype=torch.bool, device=dev),
        esc_dir=V3(zf(), torch.ones((n,), dtype=torch.float32, device=dev),
                   zf()),
        esc_u3=vfull(0.0),
        esc_weight=vfull(0.0))
    if cfg.use_restir_pt:
        # ReSTIR-PT input-sample state (renderer/pathtracer.py:336-347,
        # 381-391): the rc vertex and what arrives there.
        s.rc = dict(rc_pos=v3.zeros(n, dev), rc_normal=v3.zeros(n, dev),
                    rc_incident_dir=v3.zeros(n, dev),
                    rc_incident_L=v3.zeros(n, dev),
                    rc_NEE_dir=v3.zeros(n, dev),
                    rc_mat_info=torch.zeros((n,), dtype=torch.int64,
                                            device=dev))
        s.throughput_after_rc = v3.ones(n, dev)
        s.rc_bounce_lobe_id = torch.zeros((n,), dtype=torch.int32,
                                          device=dev)
    return s


def shade_depth_eager(cfg, scene, params, depth, hit: Hit, knee_vis,
                      s: PathState, u_nee, u_bsdf, u_sky: V3):
    """One depth of the bounce loop's shading in eager PyTorch
    (renderer/pathtracer.py:399-497): the depth's records, the escape and
    emissive terminations, NEE against the sun cone and the next bounce's
    BSDF sample with its MIS. Replaces the fields of ``s``. ``knee_vis``:
    B1's in-kernel NEE verdicts, or None where the sun-shadow ray is
    dispatched here. The plain twin of ``ops/shade_kernel.shade_depth``,
    and the route of the CPU, ReSTIR, the sorted route, path A' and
    ``nee_transmittance='per_ray'`` (``shade_kernel_applies``)."""
    n = hit.closest.shape[0]
    dev = hit.closest.device
    restir = cfg.use_restir_pt
    # The escape sky is deferred to one fetch after the bounce loop, except
    # under ReSTIR, whose rc bookkeeping needs the sky at every depth.
    defer_sky = not restir
    use_nee = cfg.use_directional_light
    use_knee = knee_vis is not None
    pos, d, tracing = s.pos, s.d, s.tracing
    throughput, contrib = s.throughput, s.contrib
    rc = s.rc if restir else None

    def zf():
        return torch.zeros((n,), dtype=torch.float32, device=dev)

    hit_mat = fetch_material(scene.mat_params, hit.mat_id, hit.albedo)
    finite_closest = torch.isfinite(hit.closest)
    hit_pos = pos + d * torch.where(finite_closest, hit.closest, 0.0)

    if depth == 0:
        oct_x, oct_y = packing.encode_unit_vector_3x16_soa(hit.normal)
        s.primary_normal_oct = (
            torch.where(tracing, oct_x, s.primary_normal_oct[0]),
            torch.where(tracing, oct_y, s.primary_normal_oct[1]),
        )
        s.primary_pos = vwhere(tracing & finite_closest, hit_pos,
                               s.primary_pos)
        s.primary_mat_info = torch.where(
            tracing,
            packing.encode_material_soa(hit.mat_id, hit.albedo),
            s.primary_mat_info)
        s.primary_albedo = vwhere(tracing, hit.albedo, s.primary_albedo)
    elif depth == 1:
        add_refl = tracing & (s.first_bounce_lobe_id != LOBE_DIFFUSE)
        s.first_bounce_reflection_dist = s.first_bounce_reflection_dist + \
            torch.where(add_refl, torch.where(
                finite_closest, hit.closest, SKY_REFLECTION_DIST), 0.0)
        if restir:
            # rc vertex capture (renderer/pathtracer.py:409-414).
            rc["rc_pos"] = vwhere(tracing, hit_pos, rc["rc_pos"])
            rc["rc_normal"] = vwhere(tracing, hit.normal,
                                     rc["rc_normal"])
            rc["rc_mat_info"] = torch.where(
                tracing, packing.encode_material_soa(hit.mat_id,
                                                     hit.albedo),
                rc["rc_mat_info"])
    elif depth == 2 and restir:
        # renderer/pathtracer.py:416-417.
        rc["rc_incident_dir"] = vwhere(tracing, d,
                                       rc["rc_incident_dir"])

    surf = tracing & ~hit.hit_light & finite_closest
    term_sky = tracing & ~hit.hit_light & ~finite_closest
    term_light = tracing & hit.hit_light & finite_closest

    # --- miss -> sky (renderer/pathtracer.py:499-517)
    if defer_sky:
        # a ray escapes at most once: record the escape here, fetch the
        # sky once after the bounce loop
        s.esc_dir = vwhere(term_sky, d, s.esc_dir)
        s.esc_u3 = vwhere(term_sky, u_sky, s.esc_u3)
        s.esc_weight = vwhere(term_sky, throughput, s.esc_weight)
    else:
        sky_scatt, sky_trans = sample_sky(cfg, scene, params, d, u_sky)
        sky_emission = _sky_emission(cfg, params, d, sky_scatt,
                                     sky_trans)
        contrib = contrib + vwhere(term_sky, throughput * sky_emission,
                                   0.0)
    if depth == 0:
        s.is_sky_ray = term_sky
        s.primary_pos = vwhere(term_sky, 0.0, s.primary_pos)
    if restir and depth == 1:
        # Escape at the rc vertex: rc_pos becomes a direction and
        # rc_incident_L the sky colour
        # (renderer/pathtracer.py:512-514).
        rc["rc_pos"] = vwhere(term_sky, d, rc["rc_pos"])
        rc["rc_incident_L"] = vwhere(term_sky, sky_emission,
                                     rc["rc_incident_L"])
    if restir and depth >= 2:
        rc["rc_incident_L"] = rc["rc_incident_L"] + vwhere(
            term_sky,
            firefly_filter(s.throughput_after_rc * sky_emission, cfg),
            0.0)

    # --- emissive voxel/floor hit terminates (pathtracer.py:518-525)
    if depth > 0:
        contrib = contrib + vwhere(term_light, throughput * hit.albedo,
                                   0.0)
    if restir and depth >= 2:
        rc["rc_incident_L"] = rc["rc_incident_L"] + vwhere(
            term_light,
            firefly_filter(s.throughput_after_rc * hit.albedo, cfg), 0.0)

    s.tracing = surf

    # --- surface shading (every depth incl. the last)
    spos = hit_pos + hit.normal * EPS
    view = -d
    tang, bitang = make_orthonormal_basis(hit.normal)

    nee_visible = zf()
    if use_nee:
        light_dir = sample_cone_oriented(
            params.light_cone_cos_theta_max,
            v3.broadcast(v3.splat(params.light_direction), n), u_nee)
        ndl = dot(light_dir, hit.normal)
        bsdf_d, bsdf_s, light_sample_bsdf_pdf = disney_eval_split_pdf(
            hit_mat, view, hit.normal, light_dir, tang, bitang,
            feat=mat_features(cfg))
        if depth == 0:
            s.first_light_sample_bsdf_pdf = torch.where(
                surf, light_sample_bsdf_pdf,
                s.first_light_sample_bsdf_pdf)

        shadow_mask = surf & (ndl > 0.0)
        if use_knee:
            # kernel verdict covers voxel occlusion; the floor plane is
            # a closed-form check (quirky extent bound included)
            dyl = light_dir.y
            fd = (params.floor_height - spos.y) / torch.where(
                dyl == 0.0, 1e-20, dyl)
            hpf = spos + light_dir * fd
            floor_occ = (fd > EPS) & (length(hpf - hpf.y) < 10.0)
            visible = shadow_mask & (knee_vis != 0) & ~floor_occ
        else:
            sh = next_hit(cfg, scene, params, spos, light_dir,
                          shadow_mask, shadow_ray=True,
                          sun_shadow=True)
            visible = shadow_mask & ~torch.isfinite(sh.closest)
        nee_visible = visible.to(torch.float32)

        light_mis = torch.ones((), dtype=torch.float32, device=dev)
        if depth > 0:
            light_pdf = cone_sample_pdf(
                params.light_cone_cos_theta_max, 1.0)
            light_mis = power_heuristic(light_pdf,
                                        light_sample_bsdf_pdf)

        strans = nee_transmittance(cfg, scene, params, light_dir)
        scale = ((light_mis * cfg.light_weight
                  * torch.clamp(ndl, min=0.0))
                 * v3.splat(params.light_color) * strans)
        nee_d = bsdf_d * scale
        nee_s = bsdf_s * scale
        if depth == 0:
            s.first_nee_diffuse = s.first_nee_diffuse + vwhere(
                visible, firefly_filter(throughput * nee_d, cfg), 0.0)
            s.first_nee_specular = s.first_nee_specular + vwhere(
                visible, firefly_filter(throughput * nee_s, cfg), 0.0)
        else:
            contrib = contrib + vwhere(
                visible,
                firefly_filter(throughput * (nee_d + nee_s), cfg), 0.0)
        if restir and depth == 1:
            # renderer/pathtracer.py:454-455.
            rc["rc_NEE_dir"] = vwhere(visible, light_dir,
                                      rc["rc_NEE_dir"])
        if restir and depth >= 2:
            # renderer/pathtracer.py:475-476 (no firefly clamp here).
            rc["rc_incident_L"] = rc["rc_incident_L"] + vwhere(
                visible, s.throughput_after_rc * (nee_d + nee_s), 0.0)
    s.contrib = contrib

    # --- next bounce (renderer/pathtracer.py:479-497); none after the
    # last depth.
    if depth == cfg.max_ray_depth - 1:
        return
    new_d, bsdf, pdf, lobe = sample_disney(hit_mat, view, hit.normal,
                                           tang, bitang, u_bsdf,
                                           feat=mat_features(cfg))
    bounce_weight = bsdf * saturate(dot(new_d, hit.normal))
    if depth == 0:
        s.first_bounce_invpdf = torch.where(surf, 1.0 / pdf,
                                            s.first_bounce_invpdf)
        s.first_bounce_lobe_id = torch.where(surf, lobe,
                                             s.first_bounce_lobe_id)
        s.first_bounce_dir = vwhere(surf, new_d, s.first_bounce_dir)
        if use_nee:
            s.first_light_sample_dir = vwhere(surf, light_dir, 0.0)
    else:
        bounce_weight = bounce_weight / pdf
        bsdf_light_pdf = cone_sample_pdf(
            params.light_cone_cos_theta_max,
            dot(v3.splat(params.light_direction), new_d))
        bounce_weight = bounce_weight * power_heuristic(
            pdf, nee_visible * bsdf_light_pdf)
    if restir and depth == 1:
        s.rc_bounce_lobe_id = torch.where(surf, lobe, s.rc_bounce_lobe_id)
    if restir and depth >= 2:
        s.throughput_after_rc = vwhere(
            surf, s.throughput_after_rc * bounce_weight,
            s.throughput_after_rc)
    s.throughput = vwhere(surf, throughput * bounce_weight, throughput)
    s.d = vwhere(surf, new_d, d)
    s.pos = vwhere(surf, spos, pos)


def center_transmittance(cfg, scene, params):
    """The shade kernel's NEE transmittance: the cone centre's as a (3,)
    tensor (the 1-lane B3 fetch that ``shade_depth_eager`` makes at every
    depth, fetched once), or None under a flat sky or without a sun."""
    if not (cfg.use_directional_light and cfg.use_physical_sky):
        return None
    return v3.stack(sky_transmittance(cfg, scene,
                                      _light_dir_1(params))).reshape(3)


def trace_sample(cfg, scene, params, u, v, sample_keys, jitter_u,
                 camera_is_moving: bool = False, render_scale: float = 1.0):
    """Trace one progressive sample for rays at pixels (u, v) — the
    megakernel body (renderer/pathtracer.py:355-632).

    ``sample_keys``: the (k0, k1) sample key of each ray (python ints or
    int64 tensors); ``jitter_u``: the (u0, u1) TAA jitter uniforms of each
    ray's sample. Returns a dict of per-ray outputs; with ``use_restir_pt``
    also ``reservoir``, the input reservoir of each ray as a dict of packed
    tensors (the render/restir.py boundary).

    Each depth's shading runs as one launch of the shade kernel where
    ``shade_kernel_applies``, else as ``shade_depth_eager``. Each depth's
    PCG3D draws are one launch of kernel D where ``draws_kernel_applies``
    (ops/draws_kernel.py), else ``fold_in`` then ``Pcg3dDraws``, whose bits
    the kernel's equal. Each depth's closest-hit glue around B1 is kernel
    H's two launches on the card (``next_hit``). B1's in-kernel NEE launch
    scalars are made once a call."""
    n = u.shape[0]
    dev = u.device
    restir = cfg.use_restir_pt
    on_card = shade_kernel_applies(cfg, dev)
    card_draws = draws_kernel.draws_kernel_applies(cfg, dev)
    use_nee = cfg.use_directional_light
    # In-kernel NEE: the traversal kernel itself traces each surface's
    # sun-cone shadow ray, replacing the separate any-hit dispatch per depth
    # (pathtracer.py:600-602, with use_pallas_dda read as True). ReSTIR
    # keeps the explicit dispatches, and the sorted route has no NEE.
    use_knee = (cfg.nee_in_kernel and use_nee and not restir
                and not cfg.sort_rays)

    with profiling.span("sample.raygen"):
        d = get_cast_dir(cfg, params, u, v, camera_is_moving, render_scale,
                         jitter_u)

        # is_outside_render_area (renderer/pathtracer.py:289-291).
        inside = ~((u > render_scale * cfg.image_res[0])
                   | (v > render_scale * cfg.image_res[1]))
        s = start_state(cfg, params, d, inside)
        strans = center_transmittance(cfg, scene, params) if on_card else None
        knee_scalars = (nee_launch_scalars(cfg, params, dev) if use_knee
                        else None)

        # Counter-based per-pixel RNG: every uniform is a pure function of
        # (global pixel id, sample key, draw slot). Kernel D folds each
        # lane's key itself, in each launch.
        if not card_draws:
            pid = u.to(torch.int64) * cfg.image_res[1] + v.to(torch.int64)
            kd = fold_in(sample_keys, pid)
            if cfg.rng_draws == "pcg3d":
                draws = Pcg3dDraws(kd[0], kd[1])
            else:
                draws = draw_table(cfg, kd)
            del kd

    def draw_slots(lo, k):
        """Slots [lo, lo + k) of every lane, indexed from 0."""
        if card_draws:
            return draws_kernel.pcg3d_draws(u, v, sample_keys,
                                            cfg.image_res[1], lo, k)
        return [draws[lo + i] for i in range(k)]

    for depth in range(cfg.max_ray_depth):
        profiling.count("sample.lanes", n, depth=depth)
        with profiling.span("sample.draws", depth=depth):
            dr = draw_slots(8 * depth, 8)
            u_nee = (dr[0], dr[1])
            u_bsdf = (dr[2], dr[3], dr[4])
            u_sky = V3(dr[5], dr[6], dr[7])

        with profiling.span("sample.hit", depth=depth):
            knee_vis = None
            if use_knee:
                hit, knee_vis = next_hit(cfg, scene, params, s.pos, s.d,
                                         s.tracing, nee_u=u_nee,
                                         coherent=depth == 0,
                                         nee_scalars=knee_scalars)
            else:
                hit = next_hit(cfg, scene, params, s.pos, s.d, s.tracing,
                               coherent=depth == 0)
        with profiling.span("sample.shade", depth=depth):
            if on_card:
                shade_kernel.shade_depth(cfg, params, scene.mat_params,
                                         depth, hit, knee_vis, s, u_nee,
                                         u_bsdf, u_sky, strans,
                                         mat_features(cfg))
            else:
                shade_depth_eager(cfg, scene, params, depth, hit, knee_vis,
                                  s, u_nee, u_bsdf, u_sky)
        # the depth's draws go before the next depth's are made
        del dr, u_nee, u_bsdf, u_sky
    # the NEE sample's WRS uniform, the slot after the bounce loop's
    u_wrs = (draw_slots(8 * cfg.max_ray_depth, 1)[0] if restir and use_nee
             else None)
    draws = None

    if not restir:
        # --- deferred escape sky (single fetch for the whole bounce loop)
        with profiling.span("sample.sky"):
            esc_any = v3.any_nonzero(s.esc_weight)
            # the cone-centre transmittance stands in for the per-ray map
            # inside the sun disk (config.nee_transmittance='center')
            cheap_sun_trans = (cfg.nee_transmittance == "center"
                               and cfg.use_physical_sky)
            sky_scatt, sky_trans = sample_sky(cfg, scene, params, s.esc_dir,
                                              s.esc_u3,
                                              want_trans=not cheap_sun_trans)
            if sky_trans is None:
                sky_trans = sky_transmittance(cfg, scene, _light_dir_1(params))
            sky_emission = _sky_emission(cfg, params, s.esc_dir, sky_scatt,
                                         sky_trans)
            s.contrib = s.contrib + vwhere(esc_any,
                                           s.esc_weight * sky_emission, 0.0)

    # --- epilogue (renderer/pathtracer.py:535-632) ---------------------------
    with profiling.span("sample.epilogue"):
        primary_pos_view = world_to_view_soa(s.primary_pos, params.view)
        gbuff_depth = view_to_screen_z_soa(primary_pos_view, params.proj)

        primary_dir = normalize(s.primary_pos - v3.splat(params.camera_pos))
        virtual_point = (s.primary_pos
                         + primary_dir * s.first_bounce_reflection_dist)
        refl_depth = view_to_screen_z_soa(
            world_to_view_soa(virtual_point, params.view), params.proj)
        gbuff_depth_reflection = torch.where(
            s.first_bounce_reflection_dist != 0.0,
            linearize_depth(refl_depth, params.proj_inv), 0.0)

        # Primary-vertex MIS (renderer/pathtracer.py:556-605).
        nee_d_out = s.first_nee_diffuse
        nee_s_out = s.first_nee_specular
        chose_nee = torch.zeros((n,), dtype=torch.bool, device=dev)
        if use_nee:
            light_pdf_one = cone_sample_pdf(params.light_cone_cos_theta_max,
                                            1.0)
            light_sample_mis = power_heuristic(light_pdf_one,
                                               s.first_light_sample_bsdf_pdf)
            apply = ~s.is_sky_ray
            if not restir:
                nee_d_out = vwhere(apply, nee_d_out * light_sample_mis,
                                   nee_d_out)
                nee_s_out = vwhere(apply, nee_s_out * light_sample_mis,
                                   nee_s_out)

        if restir:
            # The input reservoir (renderer/pathtracer.py:549-607): the BSDF
            # path sample through its rc vertex, merged by WRS with the primary
            # vertex's NEE sample when there is a sun, then finalized; packed
            # at the render/restir.py boundary.
            z = dict(s.rc)
            z["F"] = s.contrib
            z["lobes"] = s.rc_bounce_lobe_id * 10 + s.first_bounce_lobe_id
            dir_x1x2 = z["rc_pos"] - s.primary_pos
            denom = torch.abs(dot(normalize(dir_x1x2), z["rc_normal"]))
            z["cached_jacobian_term"] = dot(dir_x1x2, dir_x1x2) / torch.clamp(
                denom, min=1e-20)
            res_m = torch.ones((n,), dtype=torch.float32, device=dev)
            nee_f = s.first_nee_diffuse + s.first_nee_specular
            if use_nee:
                bsdf_pdf0 = 1.0 / s.first_bounce_invpdf
                bsdf_light_pdf0 = cone_sample_pdf(
                    params.light_cone_cos_theta_max,
                    dot(v3.splat(params.light_direction), s.first_bounce_dir))
                bsdf_light_pdf0 = torch.where(is_vec_zero(nee_f), 0.0,
                                              bsdf_light_pdf0)
                bsdf_mis = power_heuristic(bsdf_pdf0, bsdf_light_pdf0)
                res_weight = (bsdf_mis * luminance(z["F"])
                              * s.first_bounce_invpdf)
                light_sample_weight = light_sample_mis * luminance(nee_f)
                # WRS input of the NEE sample (renderer/pathtracer.py:588-598,
                # reservoir.py:65-74).
                new_weight = res_weight + light_sample_weight
                sel = (light_sample_weight > 0.0) & (
                    u_wrs * new_weight <= light_sample_weight)
                sel = sel & apply
                strans0 = nee_transmittance(cfg, scene, params,
                                            s.first_light_sample_dir)
                zero3 = v3.zeros(n, dev)
                light_z = dict(
                    F=nee_f, rc_pos=s.first_light_sample_dir, rc_normal=zero3,
                    rc_incident_dir=zero3,
                    rc_incident_L=strans0 * cfg.light_weight
                    * v3.splat(params.light_color),
                    rc_NEE_dir=zero3, rc_mat_info=0, cached_jacobian_term=1.0,
                    lobes=99)
                for k, lz in light_z.items():
                    if isinstance(z[k], V3):
                        z[k] = vwhere(sel, lz, z[k])
                    else:
                        # a fill on the device, not a host-to-device copy
                        z[k] = torch.where(sel, torch.full(
                            (), lz, dtype=z[k].dtype, device=dev), z[k])
                res_weight = torch.where(apply & (light_sample_weight > 0.0),
                                         new_weight, res_weight)
                res_m = torch.where(apply, 2.0, res_m)  # input_sample: M += 1
                chose_nee = sel
            else:
                res_weight = luminance(z["F"]) * s.first_bounce_invpdf
            # finalize_without_M (reservoir.py:96-102) for non-sky rays.
            p_hat_final = luminance(z["F"])
            fin = torch.where(p_hat_final < 1e-6, 0.0,
                              res_weight / torch.clamp(p_hat_final, min=1e-20))
            reservoir = {k: (v3.stack(x) if isinstance(x, V3) else x)
                         for k, x in z.items()}
            reservoir["M"] = res_m
            reservoir["weight"] = torch.where(s.is_sky_ray, 1.0, fin)

        prim_mat_id, prim_albedo_dec = packing.decode_material_word_soa(
            s.primary_mat_info)
        emission = vwhere(prim_mat_id == 2, prim_albedo_dec, 0.0)

        lobe_diff = s.first_bounce_lobe_id == LOBE_DIFFUSE
        lobe_spec = s.first_bounce_lobe_id == LOBE_SPEC_REFL
        if not restir:
            diffuse = vwhere(lobe_diff,
                             s.contrib * s.first_bounce_invpdf + emission,
                             0.0) + nee_d_out
            specular = vwhere(lobe_spec, s.contrib * s.first_bounce_invpdf,
                              0.0) + nee_s_out
        else:
            # renderer/pathtracer.py:620-626: the chosen input sample's
            # integrand, unweighted (the GRIS pass applies the weight).
            res_f = v3.load(reservoir["F"])
            diffuse = vwhere(chose_nee, s.first_nee_diffuse,
                             vwhere(lobe_diff, res_f, 0.0))
            specular = vwhere(chose_nee, s.first_nee_specular,
                              vwhere(lobe_spec, res_f, 0.0))

        if camera_is_moving and not restir:
            # De-modulate albedo so temporal filtering works on irradiance
            # (renderer/pathtracer.py:628-631; under ReSTIR the GRIS pass
            # demodulates).
            diffuse = diffuse / v3.vmaximum(s.primary_albedo, 1e-2)

        out = dict(
            diffuse=diffuse,
            specular=specular,
            inside=inside,
            gbuff_normals=s.primary_normal_oct,
            gbuff_depth=gbuff_depth,
            gbuff_depth_reflection=gbuff_depth_reflection,
            gbuff_position=s.primary_pos,
            gbuff_mat_id=s.primary_mat_info,
        )
        if restir:
            out["reservoir"] = reservoir
        return out

