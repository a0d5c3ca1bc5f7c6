// One depth of the wavefront sample's shading (kernel S): the body of
// render/pathtracer.py's ``shade_depth_eager`` (renderer/pathtracer.py:399-497)
// for one lane a thread. It reads the lane's hit (distance, normal, albedo,
// emissive flag, material id), B1's in-kernel NEE verdict, the path state
// and the depth's draws, and writes the depth's records, the deferred escape
// record and the updated path state in place, all but the ``tracing`` mask,
// which it writes anew (the mask handed to B1 at this depth stays as it
// was).
//
// It replaces no TPU kernel: the JAX package leaves this block to XLA, which
// fuses it. Run eagerly it was about 235 PyTorch elementwise kernels a
// sample, each a round trip of its operands through device memory; here
// every intermediate of the Disney BSDF, the cone sample, MIS and the
// firefly clamp stays in registers, so the kernel moves about 190 bytes a
// lane a depth (280 at depth 0) and is bound by its float32 work and lobe
// divergence rather than by bytes. The 128 x 14 material palette is staged
// once a block in shared memory; the blocks stride over the lanes so that
// the staging is paid a few times an SM, not once a 256 lanes.
//
// Numerics: built with -fmad=false and written in the eager code's
// operation order, with its functions (powf, logf, sinf/cosf, IEEE sqrtf and
// division, rsqrtf where PyTorch calls rsqrt), its NaN-propagating clamps and
// its Python constants rounded as PyTorch rounds them: a double folded in
// Python and cast to float, and a division by a Python number taken as a
// multiply by its float reciprocal, as PyTorch's CUDA division by a CPU
// scalar is. So every output matches the eager code's bits except where a
// device function of PyTorch's differs from the same function here in the
// last bit. Lanes that are not tracing write ``false`` to the new mask and
// return, leaving their state as the eager code leaves it; so do, for each
// record, the lanes that the eager code's masks leave.
//
// The depth's case (first, last) is a template parameter. The palette's
// Disney features (ops/bsdf.py MatFeatures) are the argument ``features``,
// a bit each: the branches on them take one way in every thread.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the bits of ``features`` (ops/shade_kernel.py feature_bits)
constexpr int F_SUBSURFACE = 1;
constexpr int F_METALLIC = 2;
constexpr int F_ANISOTROPIC = 4;
constexpr int F_SHEEN = 8;
constexpr int F_CLEARCOAT = 16;

constexpr int THREADS = 256;
constexpr int N_SLOTS = 128;
constexpr int N_PARAMS = 14;

// Python's float constants as PyTorch rounds them into float32
constexpr float PI_F = (float)3.141592653589793;            // PI
constexpr float RCP_PI = 1.0f / PI_F;                        // x / PI
constexpr float INV_PI = (float)(1.0 / 3.141592653589793);   // (1.0 / PI)
constexpr float TWO_PI = (float)(2.0 * 3.141592653589793);   // 2.0 * PI
constexpr float EPS = (float)1e-6;
constexpr float GRAZE = (float)(1.0 - 1e-5);
constexpr float SKY_REFLECTION_DIST = (float)1.0e4;

// The pointer slots of ``shade``'s table, in ops/shade_kernel.py's order.
enum Slot {
  CLOSEST, NX, NY, NZ, AX, AY, AZ, HIT_LIGHT, MAT_ID, KNEE_VIS,
  U_NEE0, U_NEE1, U_BSDF0, U_BSDF1, U_BSDF2, U_SKY0, U_SKY1, U_SKY2,
  POS, D = POS + 3, TRACING = D + 3, TRACING_OUT, THR, CONTRIB = THR + 3,
  ESC_DIR = CONTRIB + 3, ESC_U3 = ESC_DIR + 3, ESC_W = ESC_U3 + 3,
  OCT = ESC_W + 3, PPOS = OCT + 2, PMAT = PPOS + 3, PALB, IS_SKY = PALB + 3,
  LSBP, NEE_D, NEE_S = NEE_D + 3, INVPDF = NEE_S + 3, LOBE, BDIR,
  LSDIR = BDIR + 3, LOBE_IN = LSDIR + 3, REFL, PALETTE, FLOOR_H, LIGHT_DIR,
  COS_MAX, LIGHT_COLOR, STRANS, N_PTRS
};

struct Args {
  const void* p[N_PTRS];
  int nee, features;
  float light_weight, radiance_clamp;
  long long n;
};

struct V {
  float x, y, z;
};

__device__ __forceinline__ V mk(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V add(V a, V b) {
  return mk(a.x + b.x, a.y + b.y, a.z + b.z);
}
__device__ __forceinline__ V sub(V a, V b) {
  return mk(a.x - b.x, a.y - b.y, a.z - b.z);
}
__device__ __forceinline__ V mul(V a, V b) {
  return mk(a.x * b.x, a.y * b.y, a.z * b.z);
}
__device__ __forceinline__ V muls(V a, float s) {
  return mk(a.x * s, a.y * s, a.z * s);
}
__device__ __forceinline__ V neg(V a) { return mk(-a.x, -a.y, -a.z); }
__device__ __forceinline__ V sel(bool c, V a, V b) {
  return mk(c ? a.x : b.x, c ? a.y : b.y, c ? a.z : b.z);
}
__device__ __forceinline__ float dot(V a, V b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
__device__ __forceinline__ V cross(V a, V b) {
  return mk(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x);
}

// torch.clamp: NaN passes through, else fmaxf/fminf
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float saturate(float x) {
  return clamp(x, 0.0f, 1.0f);
}
__device__ __forceinline__ float sqr(float x) { return x * x; }
__device__ __forceinline__ float pow5(float x) {
  float x2 = x * x;
  return x2 * x2 * x;
}
__device__ __forceinline__ float mix(float a, float b, float t) {
  return a + (b - a) * t;
}
__device__ __forceinline__ V cmix(V a, V b, float t) {
  return add(a, muls(sub(b, a), t));
}
__device__ __forceinline__ V normalize(V v) {
  return muls(v, rsqrtf(clamp_min(dot(v, v), (float)1e-20)));
}
__device__ __forceinline__ float luminance(V c) {
  return c.x * (float)0.2125 + c.y * (float)0.7154 + c.z * (float)0.0721;
}
// reflect(i, n) = i - n * (2.0 * dot(n, i))
__device__ __forceinline__ V reflect(V i, V n) {
  return sub(i, muls(n, dot(n, i) * 2.0f));
}
// power_heuristic (renderer/pathtracer.py:349-353)
__device__ __forceinline__ float power_heuristic(float a, float b) {
  float a_sqr = a * a;
  float p_sum = clamp_min(a_sqr + b * b, (float)1e-4);
  return a_sqr / p_sum;
}

// make_orthonormal_basis (renderer/math_utils.py:32-37)
__device__ __forceinline__ void basis(V n, V& x, V& y) {
  bool ny = fabsf(n.y) > (float)0.9;
  V h = mk(ny ? 1.0f : 0.0f, ny ? 0.0f : 1.0f, 0.0f);
  y = normalize(cross(n, h));
  x = cross(n, y);
}

struct Mat {
  int feat;  // the palette's features
  V base;
  float subsurface, metallic, specular, specular_tint, roughness, anisotropic,
      sheen, sheen_tint, clearcoat, clearcoat_gloss;
};

// --- Disney BSDF (ops/bsdf.py) --------------------------------------------

__device__ __forceinline__ V spec_tint_of(const Mat& m) {
  float lum = luminance(m.base);
  float c = clamp_min(lum, (float)1e-20);
  bool pos = lum > 0.0f;
  return mk(pos ? m.base.x / c : 1.0f, pos ? m.base.y / c : 1.0f,
            pos ? m.base.z / c : 1.0f);
}

__device__ __forceinline__ V disney_diffuse(const Mat& m, float n_dot_l,
                                            float n_dot_v, float l_dot_h) {
  float r_r = m.roughness * 2.0f * sqr(l_dot_h);
  float f_l = pow5(1.0f - n_dot_l);
  float f_v = pow5(1.0f - n_dot_v);
  V f_lambert = muls(m.base, RCP_PI);
  V f_retro = muls(f_lambert, r_r * (f_l + f_v + f_l * f_v * (r_r - 1.0f)));
  V out = add(muls(f_lambert, (1.0f - f_l * 0.5f) * (1.0f - f_v * 0.5f)),
              f_retro);
  if (m.feat & F_SUBSURFACE) {
    float fss90 = l_dot_h * l_dot_h * m.roughness;
    float fss = mix(1.0f, fss90, f_l) * mix(1.0f, fss90, f_v);
    float rcp = 1.0f / clamp_min(n_dot_l + n_dot_v, (float)1e-7);
    float ss = 1.25f * (fss * (rcp - 0.5f) + 0.5f);
    V ssv = muls(m.base, INV_PI * ss);
    out = cmix(out, ssv, m.subsurface);
  }
  if (m.feat & F_SHEEN) {
    V sheen_col = spec_tint_of(m);
    float schlick = pow5(1.0f - l_dot_h);
    V one = mk(1.0f, 1.0f, 1.0f);
    V sheen = muls(muls(cmix(one, sheen_col, m.sheen_tint), m.sheen), schlick);
    out = add(out, sheen);
  }
  return out;
}

__device__ __forceinline__ V metallic_scale(V d, const Mat& m) {
  return (m.feat & F_METALLIC) ? muls(d, 1.0f - m.metallic) : d;
}

__device__ __forceinline__ float gtr2_aniso(float n_dot_h, float h_dot_x,
                                            float h_dot_y, float ax, float ay) {
  float denom = ax * PI_F * ay *
                sqr(sqr(h_dot_x / ax) + sqr(h_dot_y / ay) + sqr(n_dot_h));
  return 1.0f / clamp_min(denom, (float)1e-20);
}

__device__ __forceinline__ float smith_g_ggx_aniso(float n_dot_v, float v_dot_x,
                                                   float v_dot_y, float ax,
                                                   float ay) {
  float denom = n_dot_v + sqrtf(clamp_min(
      sqr(v_dot_x * ax) + sqr(v_dot_y * ay) + sqr(n_dot_v), 0.0f));
  return 1.0f / (denom == 0.0f ? (float)1e-20 : denom);
}

__device__ __forceinline__ V disney_fresnel(const Mat& m, float l_dot_h) {
  V one = mk(1.0f, 1.0f, 1.0f);
  V dielectric = muls(cmix(one, spec_tint_of(m), m.specular_tint),
                      m.specular * (float)0.08);
  V spec_col = (m.feat & F_METALLIC) ? cmix(dielectric, m.base, m.metallic) : dielectric;
  float f_l = pow5(1.0f - l_dot_h);
  return cmix(spec_col, one, f_l);
}

__device__ __forceinline__ void aniso_alphas(const Mat& m, float& ax,
                                             float& ay) {
  if (!(m.feat & F_ANISOTROPIC)) {
    ax = clamp_min(sqr(m.roughness), (float)1e-3);
    ay = ax;
    return;
  }
  float aspect = sqrtf(clamp_min(1.0f - m.anisotropic * (float)0.9, 0.0f));
  ax = clamp_min(sqr(m.roughness) / clamp_min(aspect, (float)1e-4),
                 (float)1e-3);
  ay = clamp_min(sqr(m.roughness) * aspect, (float)1e-3);
}

__device__ __forceinline__ float gtr1(float n_dot_h, float alpha) {
  float a2 = alpha * alpha;
  float t = 1.0f + (a2 - 1.0f) * n_dot_h * n_dot_h;
  float d = (a2 - 1.0f) / (logf(clamp_min(a2, (float)1e-20)) * PI_F * t);
  return alpha >= 1.0f ? INV_PI : d;
}

__device__ __forceinline__ float smith_g_ggx(float n_dot_v) {
  // alpha = 0.25: a2 = 0.0625
  float b = n_dot_v * n_dot_v;
  float s = sqrtf(clamp_min(b + 0.0625f - b * 0.0625f, 0.0f));
  return 1.0f / clamp_min(n_dot_v + s, (float)1e-20);
}

__device__ __forceinline__ float cc_alpha(const Mat& m) {
  return (float)0.1 + m.clearcoat_gloss * (float)(0.001 - 0.1);
}
__device__ __forceinline__ float cc_fresnel(float l_dot_h) {
  return (float)0.04 + pow5(1.0f - l_dot_h) * (float)(1.0 - 0.04);
}

struct Half {
  V h;
  float n_dot_l, n_dot_v, l_dot_h, n_dot_h, h_dot_x, h_dot_y, l_dot_x,
      l_dot_y, v_dot_x, v_dot_y;
};

__device__ __forceinline__ Half half_vectors(V v, V n, V l, V tang, V bitang) {
  Half q;
  q.h = normalize(add(l, v));
  q.n_dot_l = dot(n, l);
  q.n_dot_v = dot(n, v);
  q.l_dot_h = dot(l, q.h);
  q.n_dot_h = dot(n, q.h);
  q.h_dot_x = dot(q.h, tang);
  q.h_dot_y = dot(q.h, bitang);
  q.l_dot_x = dot(l, tang);
  q.l_dot_y = dot(l, bitang);
  q.v_dot_x = dot(v, tang);
  q.v_dot_y = dot(v, bitang);
  return q;
}

__device__ __forceinline__ void lobe_probabilities(const Mat& m, float& dw,
                                                   float& sw, float& cw) {
  float diffuse_w = clamp(1.0f - m.specular, (float)0.4, (float)0.9);
  if (m.feat & F_METALLIC) diffuse_w = (1.0f - m.metallic) * diffuse_w;
  float specular_w = 1.0f - diffuse_w;
  if (!(m.feat & F_CLEARCOAT)) {
    float w_sum = diffuse_w + specular_w;
    dw = diffuse_w / w_sum;
    sw = specular_w / w_sum;
    cw = 0.0f;
    return;
  }
  float clearcoat_w = m.clearcoat * (float)0.7;
  float w_sum = diffuse_w + specular_w + clearcoat_w;
  dw = diffuse_w / w_sum;
  sw = specular_w / w_sum;
  cw = clearcoat_w / w_sum;
}

// disney_eval_split_pdf: the pdf always, the two lobes' values only where
// ``want`` (elsewhere the caller discards them)
__device__ __forceinline__ float eval_split_pdf(const Mat& m, V v, V n, V l,
                                                V tang, V bitang, bool want,
                                                V& bsdf_d, V& bsdf_s) {
  Half q = half_vectors(v, n, l, tang, bitang);
  bool valid = (q.n_dot_l > 0.0f) & (q.n_dot_v > 0.0f);
  float ax, ay;
  aniso_alphas(m, ax, ay);
  float spec_d = gtr2_aniso(q.n_dot_h, q.h_dot_x, q.h_dot_y, ax, ay);
  float g1_v = smith_g_ggx_aniso(q.n_dot_v, q.v_dot_x, q.v_dot_y, ax, ay);
  float dw, sw, cw;
  lobe_probabilities(m, dw, sw, cw);
  float pdf_d = saturate(q.n_dot_l) * RCP_PI;
  float pdf_s = g1_v * fabsf(q.l_dot_h) * spec_d /
                clamp_min(fabsf(q.n_dot_l), (float)1e-20);
  float pdf = pdf_d * dw + pdf_s * sw;
  float cc_d = 0.0f;
  if (m.feat & F_CLEARCOAT) {
    cc_d = gtr1(fabsf(q.n_dot_h), cc_alpha(m));
    float v_dot_h = dot(v, q.h);
    float pdf_c = cc_d * fabsf(q.n_dot_h) /
                  (v_dot_h == 0.0f ? (float)1e-20 : v_dot_h * 4.0f);
    pdf = pdf + pdf_c * cw;
  }
  if (want) {
    V zero = mk(0.0f, 0.0f, 0.0f);
    V bd = metallic_scale(disney_diffuse(m, q.n_dot_l, q.n_dot_v, q.l_dot_h),
                          m);
    float g = smith_g_ggx_aniso(q.n_dot_l, q.l_dot_x, q.l_dot_y, ax, ay) * g1_v;
    V f = disney_fresnel(m, q.l_dot_h);
    V bs = muls(f, spec_d * g);
    if (m.feat & F_CLEARCOAT) {
      float cc_f = cc_fresnel(q.l_dot_h);
      float cc_g = smith_g_ggx(q.n_dot_l) * smith_g_ggx(q.n_dot_v);
      float cc_term = m.clearcoat * cc_d * cc_f * cc_g;
      bs = mk(bs.x + cc_term, bs.y + cc_term, bs.z + cc_term);
    }
    bsdf_d = sel(valid, bd, zero);
    bsdf_s = sel(valid, bs, zero);
  }
  return pdf;
}

// disney_specular (renderer/bsdf.py:86-105)
__device__ __forceinline__ V disney_specular(const Mat& m, const Half& q) {
  float ax, ay;
  aniso_alphas(m, ax, ay);
  float d = gtr2_aniso(q.n_dot_h, q.h_dot_x, q.h_dot_y, ax, ay);
  float g = smith_g_ggx_aniso(q.n_dot_l, q.l_dot_x, q.l_dot_y, ax, ay) *
            smith_g_ggx_aniso(q.n_dot_v, q.v_dot_x, q.v_dot_y, ax, ay);
  V f = disney_fresnel(m, q.l_dot_h);
  return muls(f, d * g);
}

// disney_clearcoat (renderer/bsdf.py:129-135)
__device__ __forceinline__ float disney_clearcoat(const Mat& m, const Half& q) {
  float d = gtr1(fabsf(q.n_dot_h), cc_alpha(m));
  float f = cc_fresnel(q.l_dot_h);
  float g = smith_g_ggx(q.n_dot_l) * smith_g_ggx(q.n_dot_v);
  return m.clearcoat * d * f * g;
}

// sample_diffuse (renderer/bsdf.py:184-189, math_utils.py:22-30)
__device__ __forceinline__ V sample_diffuse(V n, float u0, float u1,
                                            float& pdf) {
  float a = 1.0f - u0 * 2.0f;
  float b = sqrtf(clamp_min(1.0f - a * a, 0.0f));
  a = a * GRAZE;
  b = b * GRAZE;
  float phi = u1 * TWO_PI;
  V d = normalize(mk(n.x + b * cosf(phi), n.y + b * sinf(phi), n.z + a));
  pdf = saturate(dot(d, n)) * RCP_PI;
  return d;
}

// _ggx_vndf_sample + sample_specular (renderer/bsdf.py:226-304)
__device__ __forceinline__ V sample_specular(const Mat& m, V v, V n, V tang,
                                             V bitang, float u0, float u1,
                                             float& pdf) {
  float ax, ay;
  aniso_alphas(m, ax, ay);
  float vt0 = dot(tang, v), vt1 = dot(n, v), vt2 = dot(bitang, v);
  V big_v = normalize(mk(vt0 * ax, vt1, vt2 * ay));
  V t1 = big_v.y < (float)0.9999
             ? normalize(cross(big_v, mk(0.0f, 1.0f, 0.0f)))
             : mk(1.0f, 0.0f, 0.0f);
  V t2 = cross(t1, big_v);
  float a = 1.0f / (1.0f + big_v.y);
  float r = sqrtf(u0);
  bool lo = u1 < a;
  float phi = lo ? (u1 / clamp_min(a, (float)1e-20)) * PI_F
                 : (u1 - a) / clamp_min(1.0f - a, (float)1e-20) * PI_F + PI_F;
  float p1 = r * cosf(phi);
  float p2 = r * sinf(phi) * (lo ? 1.0f : big_v.y);
  float p3 = sqrtf(clamp_min(1.0f - p1 * p1 - p2 * p2, 0.0f));
  V mm = add(add(muls(t1, p1), muls(t2, p2)), muls(big_v, p3));
  mm = normalize(mk(mm.x * ax, mm.y, mm.z * ay));
  mm = add(add(muls(tang, mm.x), muls(bitang, mm.z)), muls(n, mm.y));
  if (dot(mm, v) < 0.0f) mm = neg(mm);
  V sampled = reflect(neg(v), mm);
  float n_dot_l = fabsf(dot(n, sampled));
  float n_dot_v = dot(n, v);
  float l_dot_h = fabsf(dot(sampled, mm));
  float n_dot_h = dot(n, mm);
  float h_dot_x = dot(mm, tang);
  float h_dot_y = dot(mm, bitang);
  float v_dot_x = dot(v, tang);
  float v_dot_y = dot(v, bitang);
  float d = gtr2_aniso(n_dot_h, h_dot_x, h_dot_y, ax, ay);
  float g = smith_g_ggx_aniso(n_dot_v, v_dot_x, v_dot_y, ax, ay);
  pdf = g * l_dot_h * d / clamp_min(n_dot_l, (float)1e-20);
  return sampled;
}

// sample_clearcoat (renderer/bsdf.py:201-224)
__device__ __forceinline__ V sample_clearcoat(const Mat& m, V v, V n, V tang,
                                              V bitang, float u0, float u1,
                                              float& pdf) {
  float alpha = cc_alpha(m);
  float a2 = sqr(alpha);
  float p = powf(clamp_min(a2, (float)1e-20), 1.0f - u0);
  float cos_theta = sqrtf(clamp_min((1.0f - p) / (1.0f - a2), (float)1e-4));
  float sin_theta = sqrtf(clamp_min(1.0f - cos_theta * cos_theta, (float)1e-4));
  float phi = u1 * TWO_PI;
  V mm = add(add(muls(tang, sin_theta * cosf(phi)),
                 muls(bitang, sin_theta * sinf(phi))),
             muls(n, cos_theta));
  if (dot(mm, v) < 0.0f) mm = neg(mm);
  V sampled = reflect(neg(v), mm);
  float n_dot_h = fabsf(dot(n, mm));
  float v_dot_h = dot(v, mm);
  float d = gtr1(n_dot_h, alpha);
  pdf = d * n_dot_h / (v_dot_h == 0.0f ? (float)1e-20 : v_dot_h * 4.0f);
  return sampled;
}

// sample_disney (renderer/bsdf.py:395-458): only the chosen lobe's sample
// and value, which is all the eager code keeps of the three
__device__ __forceinline__ V sample_disney(const Mat& m, V v, V n, V tang,
                                           V bitang, float u_lobe, float u0,
                                           float u1, V& brdf, float& pdf,
                                           int& lobe) {
  float dw, sw, cw;
  lobe_probabilities(m, dw, sw, cw);
  bool choose_d = u_lobe <= dw;
  bool choose_s = !choose_d && (u_lobe <= dw + sw);
  if (!(m.feat & F_CLEARCOAT)) choose_s = !choose_d;
  V dir;
  float weight;
  if (choose_d) {
    dir = sample_diffuse(n, u0, u1, pdf);
    lobe = 0;
    weight = dw;
  } else if (choose_s) {
    dir = sample_specular(m, v, n, tang, bitang, u0, u1, pdf);
    lobe = 1;
    weight = sw;
  } else {
    dir = sample_clearcoat(m, v, n, tang, bitang, u0, u1, pdf);
    lobe = 2;
    weight = cw;
  }
  pdf = pdf * weight;
  if (!isfinite(pdf)) pdf = 1.0f;
  Half q = half_vectors(v, n, dir, tang, bitang);
  if (choose_d) {
    brdf = metallic_scale(disney_diffuse(m, q.n_dot_l, q.n_dot_v, q.l_dot_h),
                          m);
  } else if (choose_s) {
    brdf = disney_specular(m, q);
  } else {
    float cc = disney_clearcoat(m, q);
    brdf = mk(cc, cc, cc);
  }
  return dir;
}

// --- the kernel -------------------------------------------------------------

__device__ __forceinline__ V ld3(const Args& a, int slot, long long i) {
  return mk(((const float*)a.p[slot])[i], ((const float*)a.p[slot + 1])[i],
            ((const float*)a.p[slot + 2])[i]);
}
__device__ __forceinline__ void st3(const Args& a, int slot, long long i, V v) {
  ((float*)a.p[slot])[i] = v.x;
  ((float*)a.p[slot + 1])[i] = v.y;
  ((float*)a.p[slot + 2])[i] = v.z;
}
__device__ __forceinline__ float ldf(const Args& a, int slot, long long i) {
  return ((const float*)a.p[slot])[i];
}
__device__ __forceinline__ float firefly(float x, float rc) {
  return clamp(x, 0.0f, rc);
}

template <bool FIRST, bool LAST>
__device__ __forceinline__ void shade_lane(const Args& a, const float* pal,
                                           long long i) {
  bool* tracing_out = (bool*)a.p[TRACING_OUT];
  if (!((const bool*)a.p[TRACING])[i]) {
    tracing_out[i] = false;
    return;
  }
  const float closest = ldf(a, CLOSEST, i);
  const V nrm = ld3(a, NX, i);
  const V alb = ld3(a, AX, i);
  const bool hit_light = ((const bool*)a.p[HIT_LIGHT])[i];
  const int mat_id = ((const int*)a.p[MAT_ID])[i];
  const V pos = ld3(a, POS, i);
  const V d = ld3(a, D, i);
  const bool finite_closest = isfinite(closest);
  const V hit_pos = add(pos, muls(d, finite_closest ? closest : 0.0f));

  if (FIRST) {
    // encode_unit_vector_3x16_soa (renderer/math_utils.py:202-207)
    float l1 = clamp_min(fabsf(nrm.x) + fabsf(nrm.y) + fabsf(nrm.z),
                         (float)1e-20);
    float x = nrm.x / l1, y = nrm.y / l1;
    float sx = x >= 0.0f ? 1.0f : -1.0f;
    float sy = y >= 0.0f ? 1.0f : -1.0f;
    float fold_x = (1.0f - fabsf(y)) * sx;
    float fold_y = (1.0f - fabsf(x)) * sy;
    float ex = (nrm.z <= 0.0f ? fold_x : x) * 0.5f + 0.5f;
    float ey = (nrm.z <= 0.0f ? fold_y : y) * 0.5f + 0.5f;
    ((__half*)a.p[OCT])[i] = __float2half_rn(ex);
    ((__half*)a.p[OCT + 1])[i] = __float2half_rn(ey);
    if (finite_closest) st3(a, PPOS, i, hit_pos);
    // encode_material_soa (renderer/math_utils.py:231-236)
    long long word = (long long)mat_id & 0xFF;
    word |= ((long long)(alb.x * 255.0f) & 0xFF) << 8;
    word |= ((long long)(alb.y * 255.0f) & 0xFF) << 16;
    word |= ((long long)(alb.z * 255.0f) & 0xFF) << 24;
    ((long long*)a.p[PMAT])[i] = word;
    st3(a, PALB, i, alb);
  } else if (a.p[REFL] != nullptr) {
    // depth 1: the first bounce's reflection distance
    float* refl = (float*)a.p[REFL];
    bool add_refl = ((const int*)a.p[LOBE_IN])[i] != 0;
    refl[i] = refl[i] + (add_refl ? (finite_closest ? closest
                                                    : SKY_REFLECTION_DIST)
                                  : 0.0f);
  }

  const bool surf = !hit_light && finite_closest;
  const bool term_sky = !hit_light && !finite_closest;
  const bool term_light = hit_light && finite_closest;
  const V thr = ld3(a, THR, i);
  V contrib = ld3(a, CONTRIB, i);

  if (term_sky) {
    // a ray escapes at most once: the sky is fetched after the loop
    st3(a, ESC_DIR, i, d);
    st3(a, ESC_U3, i, ld3(a, U_SKY0, i));
    st3(a, ESC_W, i, thr);
  }
  if (FIRST) {
    ((bool*)a.p[IS_SKY])[i] = term_sky;
    if (term_sky) st3(a, PPOS, i, mk(0.0f, 0.0f, 0.0f));
  } else if (term_light) {
    contrib = add(contrib, mul(thr, alb));
    st3(a, CONTRIB, i, contrib);
  }
  tracing_out[i] = surf;
  if (!surf) return;

  // --- surface shading
  const V spos = add(hit_pos, muls(nrm, EPS));
  const V view = neg(d);
  V tang, bitang;
  basis(nrm, tang, bitang);
  Mat m;
  m.feat = a.features;
  m.base = alb;
  const bool in_palette = mat_id >= 0 && mat_id < N_SLOTS;
  const float* row = pal + (in_palette ? mat_id : 0) * N_PARAMS;
  // fetch_material: a row of the palette, an all-zero row outside it
  m.subsurface = in_palette ? row[3] : 0.0f;
  m.metallic = in_palette ? row[4] : 0.0f;
  m.specular = in_palette ? row[5] : 0.0f;
  m.specular_tint = in_palette ? row[6] : 0.0f;
  m.roughness = in_palette ? row[7] : 0.0f;
  m.anisotropic = in_palette ? row[8] : 0.0f;
  m.sheen = in_palette ? row[9] : 0.0f;
  m.sheen_tint = in_palette ? row[10] : 0.0f;
  m.clearcoat = in_palette ? row[11] : 0.0f;
  m.clearcoat_gloss = in_palette ? row[12] : 0.0f;

  const float cos_max = *(const float*)a.p[COS_MAX];
  const V ldir = mk(((const float*)a.p[LIGHT_DIR])[0],
                    ((const float*)a.p[LIGHT_DIR])[1],
                    ((const float*)a.p[LIGHT_DIR])[2]);
  // the cone pdf (cone_sample_pdf: 1.0 / (2.0 * PI * (1.0 - cos_max)))
  const float cone_pdf = 1.0f / ((1.0f - cos_max) * TWO_PI);
  float nee_visible = 0.0f;
  V light_dir = mk(0.0f, 0.0f, 0.0f);
  if (a.nee) {
    // sample_cone_oriented (renderer/math_utils.py:44-59)
    const float u0 = ldf(a, U_NEE0, i), u1 = ldf(a, U_NEE1, i);
    float cos_theta = (1.0f - u0) + u0 * cos_max;
    float sin_theta = sqrtf(clamp_min(1.0f - cos_theta * cos_theta, 0.0f));
    float phi = u1 * TWO_PI;
    V lx, ly;
    basis(ldir, lx, ly);
    float cx = sin_theta * cosf(phi), cy = sin_theta * sinf(phi);
    light_dir = add(add(muls(lx, cx), muls(ly, cy)), muls(ldir, cos_theta));
    const float ndl = dot(light_dir, nrm);
    const bool shadow_mask = ndl > 0.0f;
    // B1 settled voxel occlusion; the floor plane is a closed-form check
    // (quirky extent bound included)
    const float floor_h = *(const float*)a.p[FLOOR_H];
    float dyl = light_dir.y;
    float fd = (floor_h - spos.y) / (dyl == 0.0f ? (float)1e-20 : dyl);
    V hpf = add(spos, muls(light_dir, fd));
    V q = mk(hpf.x - hpf.y, hpf.y - hpf.y, hpf.z - hpf.y);
    bool floor_occ = (fd > EPS) && (sqrtf(clamp_min(dot(q, q), 0.0f)) < 10.0f);
    const bool visible = shadow_mask &&
                         ((const int*)a.p[KNEE_VIS])[i] != 0 && !floor_occ;
    nee_visible = visible ? 1.0f : 0.0f;
    if (FIRST || visible) {
      V bsdf_d, bsdf_s;
      float pdf = eval_split_pdf(m, view, nrm, light_dir, tang, bitang,
                                 visible, bsdf_d, bsdf_s);
      if (FIRST) ((float*)a.p[LSBP])[i] = pdf;
      if (visible) {
        float light_mis = 1.0f;
        if (!FIRST) {
          float light_pdf = 1.0f >= cos_max ? cone_pdf : 0.0f;
          light_mis = power_heuristic(light_pdf, pdf);
        }
        V strans = mk(1.0f, 1.0f, 1.0f);
        if (a.p[STRANS] != nullptr) {
          const float* s = (const float*)a.p[STRANS];
          strans = mk(s[0], s[1], s[2]);
        }
        const float* lc = (const float*)a.p[LIGHT_COLOR];
        float sc = light_mis * a.light_weight * clamp_min(ndl, 0.0f);
        V scale = mk(sc * lc[0] * strans.x, sc * lc[1] * strans.y,
                     sc * lc[2] * strans.z);
        V nee_d = mul(bsdf_d, scale);
        V nee_s = mul(bsdf_s, scale);
        const float rc = a.radiance_clamp;
        if (FIRST) {
          V fd_ = ld3(a, NEE_D, i), fs_ = ld3(a, NEE_S, i);
          V td = mul(thr, nee_d), ts = mul(thr, nee_s);
          st3(a, NEE_D, i, add(fd_, mk(firefly(td.x, rc), firefly(td.y, rc),
                                       firefly(td.z, rc))));
          st3(a, NEE_S, i, add(fs_, mk(firefly(ts.x, rc), firefly(ts.y, rc),
                                       firefly(ts.z, rc))));
        } else {
          V t = mul(thr, add(nee_d, nee_s));
          contrib = add(contrib, mk(firefly(t.x, rc), firefly(t.y, rc),
                                    firefly(t.z, rc)));
          st3(a, CONTRIB, i, contrib);
        }
      }
    }
  }

  // --- next bounce (renderer/pathtracer.py:479-497); none after the last
  if (LAST) return;
  V brdf;
  float pdf;
  int lobe;
  const V new_d = sample_disney(m, view, nrm, tang, bitang, ldf(a, U_BSDF0, i),
                                ldf(a, U_BSDF1, i), ldf(a, U_BSDF2, i), brdf,
                                pdf, lobe);
  V bounce_weight = muls(brdf, saturate(dot(new_d, nrm)));
  if (FIRST) {
    ((float*)a.p[INVPDF])[i] = 1.0f / pdf;
    ((int*)a.p[LOBE])[i] = lobe;
    st3(a, BDIR, i, new_d);
    if (a.nee) st3(a, LSDIR, i, light_dir);
  } else {
    bounce_weight = mk(bounce_weight.x / pdf, bounce_weight.y / pdf,
                       bounce_weight.z / pdf);
    float bsdf_light_pdf = dot(ldir, new_d) >= cos_max ? cone_pdf : 0.0f;
    bounce_weight = muls(bounce_weight,
                         power_heuristic(pdf, nee_visible * bsdf_light_pdf));
  }
  st3(a, THR, i, mul(thr, bounce_weight));
  st3(a, D, i, new_d);
  st3(a, POS, i, spos);
}

template <bool FIRST, bool LAST>
__global__ void __launch_bounds__(THREADS) shade_kernel(const Args a) {
  __shared__ float pal[N_SLOTS * N_PARAMS];
  const float* palette = (const float*)a.p[PALETTE];
  for (int k = threadIdx.x; k < N_SLOTS * N_PARAMS; k += blockDim.x)
    pal[k] = palette[k];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < a.n; i += stride)
    shade_lane<FIRST, LAST>(a, pal, i);
}

template <bool FIRST, bool LAST>
cudaError_t launch(const Args& a, cudaStream_t st) {
  static int blocks_per_sm = 0, sms = 0;
  if (sms == 0) {
    int dev;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks_per_sm, shade_kernel<FIRST, LAST>, THREADS, 0);
    if (blocks_per_sm < 1) blocks_per_sm = 1;
  }
  long long need = (a.n + THREADS - 1) / THREADS;
  long long cap = 4LL * sms * blocks_per_sm;
  int grid = (int)(need < cap ? need : cap);
  shade_kernel<FIRST, LAST><<<grid, THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// ``p``: N_PTRS device pointers in ops/shade_kernel.py's slot order (null
// where a slot is unused at this depth); ``first``/``last``: depth 0 and the
// last depth; ``nee``: the sun is on (B1's verdicts in KNEE_VIS);
// ``features``: the palette's Disney features (F_* bits).
extern "C" int shade(const void* const* p, int first, int last, int nee,
                     int features, float light_weight, float radiance_clamp,
                     long long n, void* stream) {
  if (n <= 0) return 0;
  Args a;
  for (int k = 0; k < N_PTRS; ++k) a.p[k] = p[k];
  a.nee = nee;
  a.features = features;
  a.light_weight = light_weight;
  a.radiance_clamp = radiance_clamp;
  a.n = n;
  cudaStream_t st = (cudaStream_t)stream;
  if (first && last) return (int)launch<true, true>(a, st);
  if (first) return (int)launch<true, false>(a, st);
  if (last) return (int)launch<false, true>(a, st);
  return (int)launch<false, false>(a, st);
}

extern "C" int shade_slots() { return N_PTRS; }
