"""A frozen copy of the port's ``voxelrt_torch/ops/bsdf.py``, taken when
the benchmark was defined, less what the plain reference does not call.

Disney BSDF: evaluate / sample / pdf on ray batches (the PyTorch port of
voxelrt/ops/bsdf.py, SoA V3 form; references: Burley 2012/2015, the wdas
brdf explorer).

Preserved reference quirks (they are part of the image):
  * ``sample_disney`` returns only the *chosen* lobe's BSDF value and
    pdf = lobe_pdf * lobe_weight (renderer/bsdf.py:395-458), not the full
    mixture.
  * NaN/inf pdf guards return 1.0 (renderer/bsdf.py:378-380, 455-456).
  * ``lobe_probabilities`` weighting (renderer/bsdf.py:352-363).

``MatFeatures`` carries the JAX package's per-scene specialization: a False
flag certifies a feature is 0.0 for every reachable material, so the lobes
it scales are dropped — bitwise identical except at the measure-zero float
gap documented there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .sampling import (
    PI,
    dot,
    luminance,
    mix,
    normalize,
    reflect,
    sample_cosine_weighted_hemisphere,
    saturate,
    sqr,
)
from .v3 import V3, vcross, vnormalize, vwhere

LOBE_DIFFUSE = 0
LOBE_SPEC_REFL = 1
LOBE_CLEARC = 2
class MatFeatures(NamedTuple):
    """Static per-scene material feature flags (see the module docstring)."""

    subsurface: bool = True
    metallic: bool = True
    anisotropic: bool = True
    sheen: bool = True
    clearcoat: bool = True


ALL_FEATURES = MatFeatures()


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def _safe_pow(x, p):
    return torch.pow(torch.clamp(x, min=1e-20), p)


def _cmix(a: V3, b: V3, t) -> V3:
    return a + (b - a) * t


def _ones_like3(v: V3) -> V3:
    return V3(torch.ones_like(v.x), torch.ones_like(v.y), torch.ones_like(v.z))


def disney_subsurface(mat, n_dot_l, n_dot_v, l_dot_h, f_l, f_v):
    """renderer/bsdf.py:39-46."""
    fss90 = l_dot_h * l_dot_h * mat.roughness
    fss = mix(1.0, fss90, f_l) * mix(1.0, fss90, f_v)
    ss = 1.25 * (fss * (1.0 / torch.clamp(n_dot_l + n_dot_v, min=1e-7) - 0.5)
                 + 0.5)
    return mat.base_col * ((1.0 / PI) * ss)


def disney_diffuse(mat, n_dot_l, n_dot_v, l_dot_h, feat=ALL_FEATURES):
    """Diffuse + retro + subsurface + sheen (renderer/bsdf.py:48-67)."""
    r_r = 2.0 * mat.roughness * sqr(l_dot_h)
    f_l = _pow5(1.0 - n_dot_l)
    f_v = _pow5(1.0 - n_dot_v)

    f_lambert = mat.base_col / PI
    f_retro = f_lambert * (r_r * (f_l + f_v + f_l * f_v * (r_r - 1.0)))
    f_d = f_lambert * ((1.0 - 0.5 * f_l) * (1.0 - 0.5 * f_v)) + f_retro

    if feat.subsurface:
        ss = disney_subsurface(mat, n_dot_l, n_dot_v, l_dot_h, f_l, f_v)
        out = _cmix(f_d, ss, mat.subsurface)
    else:
        out = f_d
    if feat.sheen:
        albedo_lum = luminance(mat.base_col)
        sheen_col = vwhere(albedo_lum > 0.0,
                           mat.base_col / torch.clamp(albedo_lum, min=1e-20),
                           1.0)
        sheen_schlick = _pow5(1.0 - l_dot_h)
        sheen = (_cmix(_ones_like3(sheen_col), sheen_col, mat.sheen_tint)
                 * mat.sheen) * sheen_schlick
        out = out + sheen
    return out


def gtr2_anisotropic(n_dot_h, h_dot_x, h_dot_y, ax, ay):
    """renderer/bsdf.py:69-71."""
    denom = PI * ax * ay * sqr(sqr(h_dot_x / ax) + sqr(h_dot_y / ay)
                               + sqr(n_dot_h))
    return 1.0 / torch.clamp(denom, min=1e-20)


def smith_g_ggx_aniso(n_dot_v, v_dot_x, v_dot_y, ax, ay):
    """renderer/bsdf.py:73-75."""
    denom = n_dot_v + torch.sqrt(torch.clamp(
        sqr(v_dot_x * ax) + sqr(v_dot_y * ay) + sqr(n_dot_v), min=0.0))
    return 1.0 / torch.where(denom == 0.0, 1e-20, denom)


def disney_fresnel(mat, l_dot_h, feat=ALL_FEATURES):
    """renderer/bsdf.py:77-83."""
    albedo_lum = luminance(mat.base_col)
    spec_tint = vwhere(albedo_lum > 0.0,
                       mat.base_col / torch.clamp(albedo_lum, min=1e-20), 1.0)
    dielectric = _cmix(_ones_like3(spec_tint), spec_tint,
                       mat.specular_tint) * (mat.specular * 0.08)
    if feat.metallic:
        spec_col = _cmix(dielectric, mat.base_col, mat.metallic)
    else:
        spec_col = dielectric
    f_l = _pow5(1.0 - l_dot_h)
    return _cmix(spec_col, _ones_like3(spec_col), f_l)


def _aniso_alphas(mat, feat=ALL_FEATURES):
    if not feat.anisotropic:  # aspect == 1.0 exactly
        ax = torch.clamp(sqr(mat.roughness), min=1e-3)
        return ax, ax
    aspect = torch.sqrt(torch.clamp(1.0 - 0.9 * mat.anisotropic, min=0.0))
    ax = torch.clamp(sqr(mat.roughness) / torch.clamp(aspect, min=1e-4),
                     min=1e-3)
    ay = torch.clamp(sqr(mat.roughness) * aspect, min=1e-3)
    return ax, ay


def disney_specular(mat, n_dot_l, n_dot_v, l_dot_h, n_dot_h, h_dot_x, h_dot_y,
                    l_dot_x, l_dot_y, v_dot_x, v_dot_y, feat=ALL_FEATURES):
    """Specular reflection lobe (renderer/bsdf.py:86-105)."""
    ax, ay = _aniso_alphas(mat, feat)
    d = gtr2_anisotropic(n_dot_h, h_dot_x, h_dot_y, ax, ay)
    g = smith_g_ggx_aniso(n_dot_l, l_dot_x, l_dot_y, ax, ay) * \
        smith_g_ggx_aniso(n_dot_v, v_dot_x, v_dot_y, ax, ay)
    f = disney_fresnel(mat, l_dot_h, feat)
    return f * (d * g)


def gtr1(n_dot_h, alpha):
    """renderer/bsdf.py:112-121."""
    a2 = alpha * alpha
    t = 1.0 + (a2 - 1.0) * n_dot_h * n_dot_h
    d = (a2 - 1.0) / (PI * torch.log(torch.clamp(a2, min=1e-20)) * t)
    return torch.where(alpha >= 1.0, 1.0 / PI, d)


def smith_g_ggx(n_dot_v, alpha):
    """renderer/bsdf.py:123-127."""
    a2 = alpha * alpha
    b = n_dot_v * n_dot_v
    return 1.0 / torch.clamp(
        n_dot_v + torch.sqrt(torch.clamp(a2 + b - a2 * b, min=0.0)),
        min=1e-20)


def disney_clearcoat(mat, n_dot_l, n_dot_v, n_dot_h, l_dot_h):
    """renderer/bsdf.py:129-135."""
    alpha = mix(0.1, 0.001, mat.clearcoat_gloss)
    d = gtr1(torch.abs(n_dot_h), alpha)
    f = mix(0.04, 1.0, _pow5(1.0 - l_dot_h))
    g = smith_g_ggx(n_dot_l, 0.25) * smith_g_ggx(n_dot_v, 0.25)
    return mat.clearcoat * d * f * g


def _half_vectors(v, n, l, tang, bitang):
    h = normalize(l + v)
    return dict(
        n_dot_l=dot(n, l),
        n_dot_v=dot(n, v),
        l_dot_h=dot(l, h),
        n_dot_h=dot(n, h),
        h_dot_x=dot(h, tang),
        h_dot_y=dot(h, bitang),
        l_dot_x=dot(l, tang),
        l_dot_y=dot(l, bitang),
        v_dot_x=dot(v, tang),
        v_dot_y=dot(v, bitang),
        h=h,
    )


def _metallic_scale(bsdf_d, mat, feat):
    if not feat.metallic:  # (1 - 0) multiply is exact identity
        return bsdf_d
    return bsdf_d * (1.0 - mat.metallic)


def lobe_probabilities(mat, feat=ALL_FEATURES):
    """renderer/bsdf.py:351-363."""
    if feat.metallic:
        diffuse_w = (1.0 - mat.metallic) * torch.clamp(1.0 - mat.specular,
                                                       0.4, 0.9)
    else:
        diffuse_w = torch.clamp(1.0 - mat.specular, 0.4, 0.9)
    specular_w = 1.0 - diffuse_w
    if not feat.clearcoat:  # clearcoat_w == 0.0 exactly
        w_sum = diffuse_w + specular_w
        return diffuse_w / w_sum, specular_w / w_sum, torch.zeros_like(
            diffuse_w)
    clearcoat_w = mat.clearcoat * 0.7
    w_sum = diffuse_w + specular_w + clearcoat_w
    return diffuse_w / w_sum, specular_w / w_sum, clearcoat_w / w_sum


def disney_eval_split_pdf(mat, v, n, l, tang, bitang, feat=ALL_FEATURES):
    """Fused (diffuse, specular, mixture pdf) — equal to the reference's
    evaluate_split + pdf_disney (renderer/bsdf.py:138-172, 383-393), sharing
    the half-vector frame, GTR/Smith terms and lobe weights."""
    q = _half_vectors(v, n, l, tang, bitang)
    valid = (q["n_dot_l"] > 0.0) & (q["n_dot_v"] > 0.0)
    ax, ay = _aniso_alphas(mat, feat)

    spec_d = gtr2_anisotropic(q["n_dot_h"], q["h_dot_x"], q["h_dot_y"], ax, ay)
    g1_v = smith_g_ggx_aniso(q["n_dot_v"], q["v_dot_x"], q["v_dot_y"], ax, ay)

    bsdf_d = _metallic_scale(
        disney_diffuse(mat, q["n_dot_l"], q["n_dot_v"], q["l_dot_h"], feat),
        mat, feat,
    )
    g = smith_g_ggx_aniso(q["n_dot_l"], q["l_dot_x"], q["l_dot_y"], ax, ay) \
        * g1_v
    f = disney_fresnel(mat, q["l_dot_h"], feat)
    bsdf_s = f * (spec_d * g)

    dw, sw, cw = lobe_probabilities(mat, feat)
    pdf_d = saturate(q["n_dot_l"]) / PI
    pdf_s = (g1_v * torch.abs(q["l_dot_h"]) * spec_d
             / torch.clamp(torch.abs(q["n_dot_l"]), min=1e-20))
    pdf = pdf_d * dw + pdf_s * sw
    if feat.clearcoat:
        cc_alpha = mix(0.1, 0.001, mat.clearcoat_gloss)
        cc_d = gtr1(torch.abs(q["n_dot_h"]), cc_alpha)
        cc_f = mix(0.04, 1.0, _pow5(1.0 - q["l_dot_h"]))
        cc_g = smith_g_ggx(q["n_dot_l"], 0.25) * smith_g_ggx(q["n_dot_v"], 0.25)
        bsdf_s = bsdf_s + mat.clearcoat * cc_d * cc_f * cc_g
        v_dot_h = dot(v, q["h"])
        pdf_c = cc_d * torch.abs(q["n_dot_h"]) / torch.where(
            v_dot_h == 0.0, 1e-20, 4.0 * v_dot_h)
        pdf = pdf + pdf_c * cw
    return vwhere(valid, bsdf_d, 0.0), vwhere(valid, bsdf_s, 0.0), pdf


def pdf_diffuse(mat, n, l):
    """renderer/bsdf.py:179-182."""
    return saturate(dot(l, n)) / PI


def pdf_clearcoat(mat, v, n, l):
    """renderer/bsdf.py:191-199."""
    alpha = mix(0.1, 0.001, mat.clearcoat_gloss)
    h = normalize(v + l)
    n_dot_h = torch.abs(dot(n, h))
    v_dot_h = dot(v, h)
    d = gtr1(n_dot_h, alpha)
    return d * n_dot_h / torch.where(v_dot_h == 0.0, 1e-20, 4.0 * v_dot_h)


def pdf_specular(mat, v, n, l, tang, bitang):
    """renderer/bsdf.py:254-277 — anisotropic GGX VNDF pdf."""
    ax, ay = _aniso_alphas(mat)
    h = normalize(v + l)
    n_dot_l = torch.abs(dot(n, l))
    d = gtr2_anisotropic(dot(n, h), dot(h, tang), dot(h, bitang), ax, ay)
    g = smith_g_ggx_aniso(dot(n, v), dot(v, tang), dot(v, bitang), ax, ay)
    return g * torch.abs(dot(l, h)) * d / torch.clamp(n_dot_l, min=1e-20)


def _scrub_pdf(pdf):
    """NaN/inf guard -> 1.0 (renderer/bsdf.py:378-380, 455-456)."""
    return torch.where(torch.isfinite(pdf), pdf, 1.0)


def pdf_disney(mat, v, n, l, tang, bitang):
    """renderer/bsdf.py:383-393 — the full mixture pdf (no NaN guard
    upstream)."""
    dw, sw, cw = lobe_probabilities(mat)
    return (pdf_diffuse(mat, n, l) * dw
            + pdf_specular(mat, v, n, l, tang, bitang) * sw
            + pdf_clearcoat(mat, v, n, l) * cw)


def _ggx_vndf_sample(v, n, tang, bitang, ax, ay, u):
    """renderer/bsdf.py:226-252 — anisotropic GGX VNDF half-vector sample."""
    u0, u1 = u
    vt0, vt1, vt2 = dot(tang, v), dot(n, v), dot(bitang, v)
    big_v = vnormalize(V3(vt0 * ax, vt1, vt2 * ay))
    zero = torch.zeros((), dtype=big_v.x.dtype, device=big_v.x.device)
    one = torch.ones((), dtype=big_v.x.dtype, device=big_v.x.device)
    t1 = vwhere(big_v.y < 0.9999, vnormalize(vcross(big_v, V3(zero, one, zero))),
                V3(one, zero, zero))
    t2 = vcross(t1, big_v)
    big_v_y = big_v.y

    a = 1.0 / (1.0 + big_v_y)
    r = torch.sqrt(u0)
    lo = u1 < a
    phi = torch.where(
        lo,
        (u1 / torch.clamp(a, min=1e-20)) * PI,
        PI + (u1 - a) / torch.clamp(1.0 - a, min=1e-20) * PI,
    )
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi) * torch.where(lo, 1.0, big_v_y)

    p3 = torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0))
    m = t1 * p1 + t2 * p2 + big_v * p3
    m = vnormalize(V3(ax * m.x, m.y, ay * m.z))
    m = tang * m.x + bitang * m.z + n * m.y
    return vwhere(dot(m, v) < 0.0, -m, m)


def sample_specular(mat, v, n, tang, bitang, u, feat=ALL_FEATURES):
    """renderer/bsdf.py:279-304 — returns (dir, pdf)."""
    ax, ay = _aniso_alphas(mat, feat)
    m = _ggx_vndf_sample(v, n, tang, bitang, ax, ay, u)
    sampled = reflect(-v, m)
    n_dot_l = torch.abs(dot(n, sampled))
    n_dot_v = dot(n, v)
    l_dot_h = torch.abs(dot(sampled, m))
    n_dot_h = dot(n, m)
    h_dot_x = dot(m, tang)
    h_dot_y = dot(m, bitang)
    v_dot_x = dot(v, tang)
    v_dot_y = dot(v, bitang)
    d = gtr2_anisotropic(n_dot_h, h_dot_x, h_dot_y, ax, ay)
    g = smith_g_ggx_aniso(n_dot_v, v_dot_x, v_dot_y, ax, ay)
    pdf = g * l_dot_h * d / torch.clamp(n_dot_l, min=1e-20)
    return sampled, pdf


def sample_clearcoat(mat, v, n, tang, bitang, u):
    """renderer/bsdf.py:201-224 — GTR1 inverse-CDF sample, returns (dir, pdf)."""
    u0, u1 = u
    alpha = mix(0.1, 0.001, mat.clearcoat_gloss)
    a2 = sqr(alpha)
    cos_theta = torch.sqrt(
        torch.clamp((1.0 - _safe_pow(a2, 1.0 - u0)) / (1.0 - a2), min=1e-4))
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=1e-4))
    phi = 2.0 * PI * u1
    m = (tang * (sin_theta * torch.cos(phi))
         + bitang * (sin_theta * torch.sin(phi))
         + n * cos_theta)
    m = vwhere(dot(m, v) < 0.0, -m, m)
    sampled = reflect(-v, m)
    n_dot_h = torch.abs(dot(n, m))
    v_dot_h = dot(v, m)
    d = gtr1(n_dot_h, alpha)
    pdf = d * n_dot_h / torch.where(v_dot_h == 0.0, 1e-20, 4.0 * v_dot_h)
    return sampled, pdf


def sample_diffuse(mat, n, u):
    """renderer/bsdf.py:184-189 — returns (dir, pdf)."""
    d = sample_cosine_weighted_hemisphere(n, u)
    return d, saturate(dot(d, n)) / PI


def sample_disney(mat, v, n, tang, bitang, u3, feat=ALL_FEATURES):
    """renderer/bsdf.py:395-458 — returns (dir, brdf, pdf, lobe_id).

    u3 = (u_lobe, u0, u1): lobe choice + the 2-D lobe sample shared by the
    three lobe samplers (only the chosen one is used)."""
    dw, sw, cw = lobe_probabilities(mat, feat)
    u_lobe, u2 = u3[0], (u3[1], u3[2])

    dir_d, pdf_d = sample_diffuse(mat, n, u2)
    dir_s, pdf_s = sample_specular(mat, v, n, tang, bitang, u2, feat)

    choose_d = u_lobe <= dw
    choose_s = (~choose_d) & (u_lobe <= dw + sw)

    if feat.clearcoat:
        dir_c, pdf_c = sample_clearcoat(mat, v, n, tang, bitang, u2)
        lobe = torch.where(choose_d, LOBE_DIFFUSE,
                           torch.where(choose_s, LOBE_SPEC_REFL, LOBE_CLEARC))
        sample_dir = vwhere(choose_d, dir_d, vwhere(choose_s, dir_s, dir_c))
        pdf = torch.where(choose_d, pdf_d, torch.where(choose_s, pdf_s, pdf_c))
    else:
        # cw == 0 so the clearcoat branch is unreachable except the float
        # gap above dw+sw (see MatFeatures); fold it into specular.
        lobe = torch.where(choose_d, LOBE_DIFFUSE, LOBE_SPEC_REFL)
        sample_dir = vwhere(choose_d, dir_d, dir_s)
        pdf = torch.where(choose_d, pdf_d, pdf_s)
        choose_s = ~choose_d
    lobe = lobe.to(torch.int32)

    q = _half_vectors(v, n, sample_dir, tang, bitang)
    brdf_d = _metallic_scale(
        disney_diffuse(mat, q["n_dot_l"], q["n_dot_v"], q["l_dot_h"], feat),
        mat, feat,
    )
    brdf_s = disney_specular(
        mat, q["n_dot_l"], q["n_dot_v"], q["l_dot_h"], q["n_dot_h"],
        q["h_dot_x"], q["h_dot_y"], q["l_dot_x"], q["l_dot_y"],
        q["v_dot_x"], q["v_dot_y"], feat,
    )
    if feat.clearcoat:
        cc = disney_clearcoat(
            mat, q["n_dot_l"], q["n_dot_v"], q["n_dot_h"], q["l_dot_h"])
        brdf = vwhere(choose_d, brdf_d,
                      vwhere(choose_s, brdf_s, V3(cc, cc, cc)))
    else:
        brdf = vwhere(choose_d, brdf_d, brdf_s)
    pdf = pdf * torch.where(choose_d, dw, torch.where(choose_s, sw, cw))
    pdf = _scrub_pdf(pdf)
    return sample_dir, brdf, pdf, lobe
