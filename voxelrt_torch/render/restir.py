"""ReSTIR-PT: reservoir storage, the reconnection shift and the spatial GRIS
pass (the PyTorch port of voxelrt/render/restir.py; renderer/reservoir.py +
renderer/pathtracer.py:672-989).

Reservoirs cross module boundaries as dicts of packed tensors: (..., 3) for
the six 3-vector fields, (...,) for the rest, ``rc_mat_info`` an int64
tensor holding the u32 word. Inside the pass the 3-vectors are V3s of
(N,) component views. The storage quantization is the reference's
StorageReservoir (f16 M, weight and jacobian; octahedral normal and NEE
direction through an 8-bit u32 pack; f16 octahedral incident direction;
int8 lobes, reservoir.py:105-141), with exact zeros kept as zeros, since the
zero vector is the reference's escape/terminated/shadowed flag.

The GRIS pass runs its ``restir_taps`` golden-spiral taps as a Python loop,
so one tap's temporaries are live at a time. The terms of a path sample
that do not depend on the vertex it is shifted into (``shift_source``) are
computed once a pass for every pixel and gathered by the taps. Its
revalidation ray is a shadow dispatch of B1 (ops/dda_kernel.py) without the
sun-open early-out, since it is no sun-cone sample; the stored NEE
directions' transmittance goes through B3's direction entry once a pass, on
the packed (W*H, 3) directions.

Reference quirks preserved:
  * the invalid-jacobian branch zeroes BOTH the jacobian and the shifted
    integrand (pathtracer.py:799-803 — `1/0 > 11` is always true);
  * `valid_samples + 1` division after finalize (pathtracer.py:977-978);
  * defensive pairwise MIS with the canonical reservoir
    (pathtracer.py:870-944).
"""

from __future__ import annotations

import math

import torch

from voxelrt_torch.materials import fetch_material
from voxelrt_torch.ops import packing, v3
from voxelrt_torch.ops.bsdf import (
    disney_evaluate,
    disney_evaluate_lobewise,
    disney_evaluate_lobewise_split,
    pdf_disney,
    pdf_disney_lobewise,
)
from voxelrt_torch.ops.prng import fold_in, uniform
from voxelrt_torch.ops.sampling import (
    INF,
    cone_sample_pdf,
    dot,
    hash3,
    is_vec_zero,
    luminance,
    make_orthonormal_basis,
    normalize,
    power_heuristic,
    saturate,
)
from voxelrt_torch.ops.transforms import screen_to_view_soa, view_to_world_soa
from voxelrt_torch.ops.v3 import V3, vclip, vwhere

GOLDEN_ANGLE = 2.399963229728  # pathtracer.py:887

FIELDS3 = ("F", "rc_pos", "rc_normal", "rc_incident_dir", "rc_incident_L",
           "rc_NEE_dir")
# the fields of a path sample (all but the reservoir's M and weight)
SAMPLE_FIELDS = (*FIELDS3, "rc_mat_info", "cached_jacobian_term", "lobes")


def _f16(x):
    return x.to(torch.float16).to(torch.float32)


def _is_zero3(a):
    """is_vec_zero on a packed (..., 3) tensor."""
    return is_vec_zero(v3.load(a))


def _oct_roundtrip(a, via_u32):
    """Octahedral encode/decode of packed directions, exact zeros kept
    (voxelrt/render/restir.py:62-74); ``via_u32`` adds the 8-bit u32 pack
    of the normal and NEE direction."""
    oct_ = packing.encode_unit_vector_3x16(a)
    if via_u32:
        o = oct_.to(torch.float32)
        packed = packing.encode_u32_arb(
            torch.stack([o[..., 0], o[..., 1], o[..., 0] * 0, o[..., 1] * 0],
                        dim=-1), (8, 8, 8, 8))
        oct_ = packing.decode_u32_arb(packed, (8, 8, 8, 8))[..., 0:2]
    dec = packing.decode_unit_vector_3x16(oct_)
    return torch.where(_is_zero3(a)[..., None], 0.0, dec)


def encode_reservoir(res):
    """Apply the StorageReservoir quantization (renderer/reservoir.py:
    105-124) to a reservoir dict; returns a new dict."""
    out = dict(res)
    out["M"] = _f16(res["M"])
    out["weight"] = _f16(res["weight"])
    out["rc_normal"] = _oct_roundtrip(res["rc_normal"], True)
    out["rc_NEE_dir"] = _oct_roundtrip(res["rc_NEE_dir"], True)
    out["rc_incident_dir"] = _oct_roundtrip(res["rc_incident_dir"], False)
    out["cached_jacobian_term"] = _f16(res["cached_jacobian_term"])
    out["lobes"] = res["lobes"].to(torch.int8).to(torch.int32)
    return out


def init_reservoir_storage(cfg, device):
    """Two slots of per-pixel reservoirs (pathtracer.py:107-109): the pass's
    quantized input reservoirs and its output, (W, H, ...) each."""
    w, h = cfg.image_res

    def slot():
        d = {k: torch.zeros((w, h, 3), dtype=torch.float32, device=device)
             for k in FIELDS3}
        d["rc_mat_info"] = torch.zeros((w, h), dtype=torch.int64,
                                       device=device)
        d["cached_jacobian_term"] = torch.ones((w, h), dtype=torch.float32,
                                               device=device)
        d["lobes"] = torch.zeros((w, h), dtype=torch.int32, device=device)
        d["M"] = torch.zeros((w, h), dtype=torch.float32, device=device)
        d["weight"] = torch.zeros((w, h), dtype=torch.float32, device=device)
        return d

    return (slot(), slot())


def _sample_v3(z):
    """A packed path sample as the pass's working form: V3 views for the
    3-vector fields, the rest as they are."""
    return {k: (v3.load(z[k]) if k in FIELDS3 else z[k])
            for k in SAMPLE_FIELDS}


def shift_source(cfg, scene, params, z):
    """The terms of the path samples ``z`` (the dict of ``_sample_v3``) that
    do not depend on the primary vertex they are shifted into: the flags,
    the rc material and basis, the sun's transmittance along the stored NEE
    direction (B3) and the emission. A pass computes them once for every
    pixel's sample; a tap gathers its neighbours' with ``_take``."""
    from voxelrt_torch.render.pathtracer import sky_transmittance

    rc_normal, rc_nee_dir = z["rc_normal"], z["rc_NEE_dir"]
    rc_is_escape = is_vec_zero(rc_normal)
    rc_is_last = is_vec_zero(z["rc_incident_dir"])
    rc_nee_visible = ~is_vec_zero(rc_nee_dir)
    rc_tang, rc_bitang = make_orthonormal_basis(rc_normal)
    rc_mat_id, rc_albedo = packing.decode_material_word_soa(z["rc_mat_info"])
    rc_mat = fetch_material(scene.mat_params, rc_mat_id, rc_albedo)
    src = dict(
        rc_is_escape=rc_is_escape,
        has_bounce=~rc_is_last & ~rc_is_escape,
        nee_lit=rc_nee_visible & ~rc_is_escape,
        rc_tang=rc_tang, rc_bitang=rc_bitang, rc_mat=rc_mat,
        rc_lobe=z["lobes"] // 10, prim_lobe=z["lobes"] % 10,
        rc_bsdf_light_pdf=cone_sample_pdf(
            params.light_cone_cos_theta_max,
            dot(v3.splat(params.light_direction), z["rc_incident_dir"]))
        * rc_nee_visible.to(torch.float32),
        emission=vwhere(rc_mat_id == 2, rc_mat.base_col, 0.0))
    if cfg.use_directional_light:
        src["strans"] = sky_transmittance(cfg, scene, rc_nee_dir)
    return src


def _take(x, idx):
    """Rows ``idx`` of every tensor in a dict or NamedTuple nest."""
    if isinstance(x, torch.Tensor):
        return x[idx]
    if isinstance(x, dict):
        return {k: _take(e, idx) for k, e in x.items()}
    return type(x)(*(_take(e, idx) for e in x))


def shift(cfg, params, dst_pos: V3, dst_normal: V3, dst_mat, z, src):
    """Reconnection shift of the path samples ``z`` (the dict of
    ``_sample_v3``; ``src`` their ``shift_source`` terms) into new primary
    vertices (renderer/pathtracer.py:670-812). Returns (diffuse, specular,
    jacobian × passed checks)."""
    rc_pos, rc_normal = z["rc_pos"], z["rc_normal"]
    rc_incident_dir, rc_nee_dir = z["rc_incident_dir"], z["rc_NEE_dir"]
    rc_is_escape = src["rc_is_escape"]
    rc_tang, rc_bitang = src["rc_tang"], src["rc_bitang"]
    rc_mat, rc_lobe = src["rc_mat"], src["rc_lobe"]

    to_rc = vwhere(rc_is_escape, rc_pos, normalize(rc_pos - dst_pos))
    passed = torch.where(
        (dot(dst_normal, to_rc) < 1e-5)
        | (~rc_is_escape & (dot(rc_normal, -to_rc) < 1e-5)), 0.0, 1.0)

    # rc-vertex bounce weights (pathtracer.py:694-717).
    rc_brdf = disney_evaluate_lobewise(
        rc_mat, -to_rc, rc_normal, rc_incident_dir, rc_tang, rc_bitang,
        rc_lobe) * saturate(dot(rc_normal, rc_incident_dir))
    dst_rc_pdf = pdf_disney_lobewise(
        rc_mat, -to_rc, rc_normal, rc_incident_dir, rc_tang, rc_bitang,
        rc_lobe)
    rc_nee_brdf = disney_evaluate(
        rc_mat, -to_rc, rc_normal, rc_nee_dir, rc_tang, rc_bitang) * \
        saturate(dot(rc_normal, rc_nee_dir))

    # primary dst vertex (pathtracer.py:730-742): the source sample's
    # primary lobe.
    dst_tang, dst_bitang = make_orthonormal_basis(dst_normal)
    view = normalize(v3.splat(params.camera_pos) - dst_pos)
    prim_d, prim_s = disney_evaluate_lobewise_split(
        dst_mat, view, dst_normal, to_rc, dst_tang, dst_bitang,
        src["prim_lobe"])
    cosw = saturate(dot(dst_normal, to_rc))
    prim_d = prim_d * cosw
    prim_s = prim_s * cosw

    # shifted integrand (pathtracer.py:759-782).
    n = dst_pos.x.shape[0]
    contrib = v3.zeros(n, dst_pos.x.device)
    rc_bsdf_mis = power_heuristic(dst_rc_pdf, src["rc_bsdf_light_pdf"])

    def clamp(c):
        return vclip(c, 0.0, cfg.radiance_clamp)

    contrib = contrib + vwhere(
        src["has_bounce"],
        clamp(rc_brdf * (rc_bsdf_mis / torch.clamp(dst_rc_pdf, min=1e-20))
              * z["rc_incident_L"]), 0.0)
    contrib = contrib + vwhere(rc_is_escape, clamp(z["rc_incident_L"]), 0.0)
    if cfg.use_directional_light:
        rc_light_bsdf_pdf = pdf_disney(rc_mat, -to_rc, rc_normal, rc_nee_dir,
                                       rc_tang, rc_bitang)
        rc_light_pdf = cone_sample_pdf(params.light_cone_cos_theta_max, 1.0)
        rc_light_mis = power_heuristic(rc_light_pdf, rc_light_bsdf_pdf)
        contrib = contrib + vwhere(
            src["nee_lit"],
            clamp(rc_nee_brdf * rc_light_mis * src["strans"]
                  * cfg.light_weight * v3.splat(params.light_color)), 0.0)
    contrib = contrib + src["emission"]

    diffuse = prim_d * contrib
    specular = prim_s * contrib

    # jacobian (pathtracer.py:787-803).
    dir_y1_x2 = rc_pos - dst_pos
    d2 = dot(dir_y1_x2, dir_y1_x2)
    jac_conn = z["cached_jacobian_term"] * torch.abs(
        dot(normalize(dir_y1_x2), rc_normal)) / torch.clamp(d2, min=1e-20)
    jac = torch.where(rc_is_escape, 1.0, jac_conn)
    invalid = (jac < 0.0) | ~torch.isfinite(jac)
    jac = torch.where(invalid, 0.0, jac)
    # the reference's invalid branch always zeroes the integrand too.
    diffuse = vwhere(invalid, 0.0, diffuse)
    specular = vwhere(invalid, 0.0, specular)
    return diffuse, specular, jac * passed


def _gather_px(img, idx):
    """Rows ``idx`` (flat pixel ids, already clamped) of a (W, H, ...)
    image."""
    return img.reshape((-1,) + tuple(img.shape[2:]))[idx]


def _world_pos(texcoord, depth_nl, params) -> V3:
    u, v = texcoord
    return view_to_world_soa(
        screen_to_view_soa(u, v, depth_nl, params.proj_inv), params.view_inv)


def _dist(x1: V3, params):
    rel = x1 - v3.splat(params.camera_pos)
    return torch.sqrt(dot(rel, rel))


def spatial_gris(cfg, scene, params, reservoir_img, color, color_spec,
                 gbuffer, frame, key, camera_is_moving, render_scale, lo=0,
                 ext_lo=0):
    """Spatial GRIS resampling pass (renderer/pathtracer.py:815-989).

    Takes the render pass's per-pixel input reservoirs (``reservoir_img``,
    (W, H, ...) packed), its colours and G-buffer, runs ``cfg.restir_taps``
    golden-spiral neighbour taps with defensive pairwise MIS, revalidates
    the winner with a shadow ray and writes the resolved diffuse/specular.
    ``frame``: the frame counter (an int) seeding the spiral's angle;
    ``key``: the (k0, k1) key of the pass's threefry draws. Returns (color,
    color_spec, (the quantized input reservoirs, the output reservoirs)).

    On a block of the image's rows (a device's share of a partitioned
    frame): ``color`` and ``color_spec`` hold the rows [lo, lo + rows),
    ``reservoir_img`` and ``gbuffer`` the rows from ``ext_lo`` on that the
    taps reach (the block's, and up to ceil(restir_radius) halo rows each
    side: a tap's offset is below the radius). Pixel coordinates, hashes,
    clamps and threefry counters are the image's, so a block's pixels get
    the whole-image pass's values bit for bit."""
    from voxelrt_torch.render.pathtracer import next_hit

    w, h = cfg.image_res
    rows = color.shape[0]
    n = rows * h
    off = (lo - ext_lo) * h  # the block's first pixel in the ext buffers
    dev = color.device
    max_taps = cfg.restir_taps
    max_radius = cfg.restir_radius

    # Input reservoirs, quantized like the storage write at
    # pathtracer.py:607; the shift's source terms and the materials are
    # per pixel, computed once for every row the taps reach.
    res_ext = encode_reservoir(reservoir_img)
    ext = {k: x.reshape((-1,) + tuple(x.shape[2:]))
           for k, x in res_ext.items()}
    ext_src = shift_source(cfg, scene, params, _sample_v3(ext))
    center = _take(ext, slice(off, off + n))
    center_z = _sample_v3(center)
    center_src = _take(ext_src, slice(off, off + n))

    pix = torch.arange(lo * h, lo * h + n, dtype=torch.int64, device=dev)
    ui, vi = pix // h, pix % h  # the image's pixel coordinates
    ur = ui - ext_lo  # the row in the ext buffers
    inv_w, inv_h = (torch.full((), 1.0 / r, dtype=torch.float32, device=dev)
                    for r in (w, h))

    def texcoord(x, y):
        # x: an ext row; x + ext_lo + 0.5 is exact in float32 either way
        return ((x.to(torch.float32) + (ext_lo + 0.5)) * inv_w / render_scale,
                (y.to(torch.float32) + 0.5) * inv_h / render_scale)

    depth_img = gbuffer["depth"]
    normals_img = gbuffer["normals"]
    mat_img = gbuffer["mat_id"]
    center_x1 = _world_pos(texcoord(ur, vi),
                           depth_img.reshape(-1)[off:off + n], params)
    center_dist = _dist(center_x1, params)
    center_n1 = v3.load(packing.decode_unit_vector_3x16(
        normals_img.reshape(-1, 2)[off:off + n]))
    sky_px = is_vec_zero(center_x1)
    mat_id_ext, albedo_ext = packing.decode_material_word_soa(
        mat_img.reshape(-1))
    ext_mat = fetch_material(scene.mat_params, mat_id_ext, albedo_ext)
    cmat_id = mat_id_ext[off:off + n]
    center_mat = _take(ext_mat, slice(off, off + n))
    center_f = center_z["F"]
    center_m = center["M"]

    # random offsets (pathtracer.py:830-837): the angle from an integer
    # hash, its u32 value (not its bits) converted to float32
    seed = hash3(ui >> 3, vi >> 3, (2 * int(frame)) & 0xFFFFFFFF)
    angle_shift = ((seed & 0x007FFFFF) | 0x3F800000).to(torch.float32) \
        / 4294967295.0 * math.pi
    radius_shift = uniform(fold_in(key, 17), (n,), dev, offset=lo * h)

    out_res = {k: torch.zeros_like(x) for k, x in center.items()
               if k in SAMPLE_FIELDS}
    out_res["cached_jacobian_term"] = torch.ones_like(
        center["cached_jacobian_term"])
    out_m = torch.zeros((n,), dtype=torch.float32, device=dev)
    out_weight = torch.zeros((n,), dtype=torch.float32, device=dev)
    valid_samples = torch.zeros((n,), dtype=torch.float32, device=dev)
    canonical_mis_weight = torch.ones((n,), dtype=torch.float32, device=dev)
    chosen_f_d = v3.zeros(n, dev)
    chosen_f_s = v3.zeros(n, dev)
    center_canon = luminance(center_f) * center_m / max_taps

    # One tap at a time: each iteration's temporaries are freed before the
    # next (the JAX package's fori_loop, restir.py:410-412).
    for i in range(max_taps):
        fi = float(i)
        angle = (angle_shift + fi) * GOLDEN_ANGLE
        offset_radius = torch.sqrt((radius_shift + fi) / max_taps) \
            * max_radius
        ox = (torch.cos(angle) * offset_radius).to(torch.int64)
        oy = (torch.sin(angle) * offset_radius).to(torch.int64)
        nonzero = (ox != 0) | (oy != 0)
        tx = ur + ox
        ty = vi + oy
        # _gather_px clamps to the image (restir.py:239-244); the tap's
        # texture coordinate does not
        idx = torch.clamp(tx, -ext_lo, w - 1 - ext_lo) * h + torch.clamp(
            ty, 0, h - 1)

        nb_n1 = v3.load(packing.decode_unit_vector_3x16(
            _gather_px(normals_img, idx)))
        nb_x1 = _world_pos(texcoord(tx, ty), _gather_px(depth_img, idx),
                           params)
        nb_dist = _dist(nb_x1, params)
        nb_res = {k: _gather_px(x, idx) for k, x in res_ext.items()}
        nb_z = _sample_v3(nb_res)

        gate = nonzero & ~(
            (torch.abs(nb_dist - center_dist) > 0.1 * center_dist)
            | (dot(center_n1, nb_n1) < 0.5))

        nb_mat = _take(ext_mat, idx)

        # Shift the centre's sample into the neighbour's domain and the
        # neighbour's into the centre's.
        c_d, c_s, c_jac = shift(cfg, params, nb_x1, nb_n1, nb_mat, center_z,
                                center_src)
        s_d, s_s, jac = shift(cfg, params, center_x1, center_n1, center_mat,
                              nb_z, _take(ext_src, idx))
        nb_m = nb_res["M"]

        center_p_hat = luminance(c_d + c_s) * c_jac
        canonical_weight = center_p_hat * nb_m
        canonical_weight = canonical_weight / torch.clamp(
            center_p_hat * nb_m + center_canon, min=1e-20)
        canonical_mis_weight = canonical_mis_weight + torch.where(
            gate, 1.0 - canonical_weight, 0.0)

        s_f = s_d + s_s
        p_hat = luminance(s_f)
        p_hat_from_nb = p_hat / torch.clamp(jac, min=1e-20)
        nb_mis = p_hat_from_nb * nb_m
        nb_mis = nb_mis / torch.clamp(
            p_hat_from_nb * nb_m + p_hat * center_m / max_taps, min=1e-20)
        nb_mis = torch.where(torch.isfinite(nb_mis), nb_mis, 0.0)

        in_w = nb_res["weight"] * p_hat * jac * nb_mis
        in_w = torch.where(gate, in_w, 0.0)

        # WRS merge (reservoir.py:77-87).
        out_m = out_m + torch.where(gate, nb_m, 0.0)
        new_weight = out_weight + in_w
        u = uniform(fold_in(key, 100 + i), (n,), dev, offset=lo * h)
        sel = (in_w > 0.0) & (u * new_weight <= in_w)
        out_weight = new_weight
        nb_res["F"] = v3.stack(s_f)
        for k in out_res:
            m = sel[:, None] if out_res[k].dim() == 2 else sel
            out_res[k] = torch.where(m, nb_res[k], out_res[k])
        chosen_f_d = vwhere(sel, s_d, chosen_f_d)
        chosen_f_s = vwhere(sel, s_s, chosen_f_s)
        valid_samples = valid_samples + gate.to(torch.float32)
        del nb_res, nb_z, c_d, c_s, s_d, s_s

    # Visibility revalidation of the chosen sample (pathtracer.py:959-967).
    rc_pos = v3.load(out_res["rc_pos"])
    escape = _is_zero3(out_res["rc_normal"])
    to_rc = vwhere(escape, rc_pos, normalize(rc_pos - center_x1))
    origin = center_x1 + center_n1 * (0.003 * center_dist)
    sh = next_hit(cfg, scene, params, origin, to_rc, ~sky_px,
                  shadow_ray=True)
    rel = center_x1 - rc_pos
    actual = torch.where(escape, INF, torch.sqrt(dot(rel, rel)))
    occluded = torch.isfinite(sh.closest) & (
        torch.abs(sh.closest - actual) > 0.1 * actual)
    out_weight = torch.where(occluded, 0.0, out_weight)
    del sh

    # Merge the canonical sample (pathtracer.py:970-975).
    in_w = center["weight"] * luminance(center_f) * canonical_mis_weight
    out_m = out_m + center_m
    new_weight = out_weight + in_w
    u = uniform(fold_in(key, 55), (n,), dev, offset=lo * h)
    sel = ((in_w > 0.0) & (u * new_weight <= in_w)) | occluded
    out_weight = torch.where(in_w > 0.0, new_weight, out_weight)
    for k in out_res:
        m = sel[:, None] if out_res[k].dim() == 2 else sel
        out_res[k] = torch.where(m, center[k], out_res[k])
    chosen_f_d = vwhere(sel, v3.load(color.reshape(-1, 3)), chosen_f_d)
    chosen_f_s = vwhere(sel, v3.load(color_spec.reshape(-1, 3)), chosen_f_s)

    # finalize_without_M + /(valid+1) (pathtracer.py:977-978).
    p_hat_final = luminance(v3.load(out_res["F"]))
    out_weight = torch.where(
        p_hat_final < 1e-6, 0.0,
        out_weight / torch.clamp(p_hat_final, min=1e-20))
    out_weight = out_weight / (valid_samples + 1.0)

    # Final colour (pathtracer.py:981-986).
    emission = vwhere(cmat_id == 2, center_mat.base_col, 0.0)
    wgt = torch.clamp(out_weight, 0.0, 50.0)
    f_d = chosen_f_d
    if camera_is_moving:
        f_d = f_d / v3.vmaximum(center_mat.base_col, 1e-2)
    new_color = f_d * wgt + emission
    new_color_s = chosen_f_s * wgt

    # Sky pixels bypass resampling (pathtracer.py:858-860).
    new_color = vwhere(sky_px, center_f, new_color)
    new_color_s = vwhere(sky_px, v3.load(color_spec.reshape(-1, 3)),
                         new_color_s)

    # update the cached jacobian and store (pathtracer.py:988-989).
    dir_x1x2 = v3.load(out_res["rc_pos"]) - center_x1
    denom = torch.abs(dot(normalize(dir_x1x2),
                          v3.load(out_res["rc_normal"])))
    out_res["cached_jacobian_term"] = dot(dir_x1x2, dir_x1x2) / torch.clamp(
        denom, min=1e-20)
    out_res["M"] = out_m
    out_res["weight"] = out_weight
    stored = encode_reservoir(out_res)
    slot_out = {k: x.reshape((rows, h) + tuple(x.shape[1:]))
                for k, x in stored.items()}
    first = lo - ext_lo
    slot_in = {k: x[first:first + rows] for k, x in res_ext.items()}
    return (v3.stack(new_color).reshape(rows, h, 3),
            v3.stack(new_color_s).reshape(rows, h, 3), (slot_in, slot_out))
