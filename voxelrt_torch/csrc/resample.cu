// Temporal resample for moving frames (kernel B4).
//
// Replaces the TPU kernel voxelrt/ops/resample.py:_taps_kernel (via
// temporal_taps). Per output pixel it fuses the bilinear upsample of the
// current colour with the gated history filter: a 4x4 Catmull-Rom (or 2x2
// bilinear) neighbourhood of the reprojected history, each tap gated on
// normal agreement and optionally on depth agreement, normalised by the
// surviving weight and clamped to the min/max of the in-bounds taps
// (anti-ringing). Source tables are flat over the active aw x ah region,
// index x*ah + y: current colour and history as bf16 pairs in 32-bit words,
// the previous normals as an octahedral bf16 pair, and one float32 table
// (linear previous depth for the diffuse pass, reflection-depth history for
// the specular pass).
//
// What bounds it on an H100: memory. A lane reads 32 bytes of coordinates,
// depth and normal and writes 32-36 bytes; the six tables of one 4-byte word
// per texel are read once (68 MB moved in all at 921,600 lanes over 230,400
// texels). The arithmetic, 16 taps of some 40 float operations, is far
// below what those bytes cost.
//
// What the design does about it: one thread per output pixel, consecutive
// threads on consecutive lanes. Lane x*h + y varies in y across a warp and
// so do the table indices x*ah + y, so the per-lane reads and writes are
// coalesced (the 4-float history output is one 16-byte store) and a warp's
// taps fall on a few neighbouring table columns. The tables (5.5 MB at
// 640x360) stay resident in the 50 MB L2, so the 16-tap gather costs L2
// rather than device-memory bandwidth. The TPU kernel's slab loops and
// min-reduce exist only because a TPU lane cannot address its fast memory
// freely; a GPU thread can, so each thread reads its taps directly.
//
// Arithmetic follows the TPU kernel's order exactly (corner order and
// w = wx*wy for the current colour; ox outer, oy inner for the taps; weight
// wgx*wgy, then the normal gate, the depth gate and the bounds flag), and the
// file is built with -fmad=false, so every rounding matches the plain
// PyTorch twin in voxelrt_torch/ops/resample.py. The min/max helpers
// propagate NaN as torch.minimum/maximum and jnp.minimum/maximum do (CUDA's
// fminf/fmaxf would drop it); the render path's own history is built from
// scrubbed colour and is finite.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float unpack_hi(int w) {
  return __int_as_float(w & (int)0xFFFF0000);
}

__device__ __forceinline__ float unpack_lo(int w) {
  return __int_as_float((int)((unsigned)w << 16));
}

// min/max that return NaN when either operand is NaN.
__device__ __forceinline__ float nmin(float a, float b) {
  return (b < a || b != b) ? b : a;
}

__device__ __forceinline__ float nmax(float a, float b) {
  return (b > a || b != b) ? b : a;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float catmullrom(float x) {
  float x2 = x * x;
  float x3 = x2 * x;
  float f1 = 1.5f * x3 - 2.5f * x2 + 1.0f;
  float f2 = -0.5f * x3 + 2.5f * x2 - 4.0f * x + 2.0f;
  return x < 1.0f ? f1 : (x < 2.0f ? f2 : 0.0f);
}

template <bool CATMULL>
__device__ __forceinline__ float tap_weight(int o, float f) {
  float d = fabsf((float)o - f);
  if (CATMULL) return catmullrom(d);
  return nmax(1.0f - d, 0.0f);
}

// Non-finite -> -9, then clip to [-9, 1e6]: reprojection lands anywhere
// (NaN for sky); out-of-bounds taps get zero weight.
__device__ __forceinline__ float sane_coord(float f) {
  f = isfinite(f) ? f : -9.0f;
  return fminf(fmaxf(f, -9.0f), 1.0e6f);
}

template <bool CATMULL, bool GATE_DEPTH, bool WITH_EXTRA>
__global__ void taps_kernel(
    const int* __restrict__ cur0, const int* __restrict__ cur1,
    const int* __restrict__ h0t, const int* __restrict__ h1t,
    const int* __restrict__ pnt, const float* __restrict__ pdt,
    const float* __restrict__ ext, const float* __restrict__ fxcp,
    const float* __restrict__ fycp, const float* __restrict__ fxhp,
    const float* __restrict__ fyhp, const float* __restrict__ cdp,
    const float* __restrict__ cnp, float* __restrict__ out_cur,
    float* __restrict__ out_ws, float4* __restrict__ out_hist,
    float* __restrict__ out_ex, long long m, int ires_x, int ires_y) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int stride = ires_y;

  // --- current-colour bilinear ---------------------------------------------
  {
    float fxc = fxcp[i];
    float fyc = fycp[i];
    float ixc = floorf(fxc);
    float iyc = floorf(fyc);
    float gx = fxc - ixc;
    float gy = fyc - iyc;
    int ixi = (int)ixc;
    int iyi = (int)iyc;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    const int cxs[4] = {0, 1, 0, 1};
    const int cys[4] = {0, 0, 1, 1};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float wx = cxs[c] ? gx : 1.0f - gx;
      float wy = cys[c] ? gy : 1.0f - gy;
      float w = wx * wy;
      int ax = clampi(ixi + cxs[c], 0, ires_x - 1);
      int ay = clampi(iyi + cys[c], 0, ires_y - 1);
      int t = ax * stride + ay;
      int c0 = __ldg(cur0 + t);
      int c1 = __ldg(cur1 + t);
      a0 = a0 + w * unpack_hi(c0);
      a1 = a1 + w * unpack_lo(c0);
      a2 = a2 + w * unpack_hi(c1);
    }
    out_cur[3 * i + 0] = a0;
    out_cur[3 * i + 1] = a1;
    out_cur[3 * i + 2] = a2;
  }

  // --- gated history taps -----------------------------------------------------
  float fxh = sane_coord(fxhp[i]);
  float fyh = sane_coord(fyhp[i]);
  int ix = (int)floorf(fxh);
  int iy = (int)floorf(fyh);
  float fx = fxh - (float)ix;
  float fy = fyh - (float)iy;
  float cd = cdp[i];
  float cn0 = cnp[3 * i + 0];
  float cn1 = cnp[3 * i + 1];
  float cn2 = cnp[3 * i + 2];

  const float BIGF = 999999.0f;
  float cs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float cmin[4] = {BIGF, BIGF, BIGF, BIGF};
  float cmax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float e_sum = 0.0f, e_min = BIGF, e_max = 0.0f;
  float w_sum = 0.0f;

  constexpr int T0 = CATMULL ? -1 : 0;
  constexpr int T1 = CATMULL ? 3 : 2;
#pragma unroll
  for (int ox = T0; ox < T1; ++ox) {
    float wgx = tap_weight<CATMULL>(ox, fx);
#pragma unroll
    for (int oy = T0; oy < T1; ++oy) {
      float wgt = wgx * tap_weight<CATMULL>(oy, fy);
      int tx = ix + ox;
      int ty = iy + oy;
      bool inb = (tx >= 0) && (tx < ires_x) && (ty >= 0) && (ty < ires_y);
      int t = clampi(tx, 0, ires_x - 1) * stride + clampi(ty, 0, ires_y - 1);
      int h0 = __ldg(h0t + t);
      int h1 = __ldg(h1t + t);
      int pn = __ldg(pnt + t);

      // octahedral normal from the bf16 pair
      float ex = unpack_hi(pn) * 2.0f - 1.0f;
      float ey = unpack_lo(pn) * 2.0f - 1.0f;
      float z = 1.0f - fabsf(ex) - fabsf(ey);
      float tt = nmax(-z, 0.0f);
      float x = ex + (ex >= 0.0f ? -tt : tt);
      float y = ey + (ey >= 0.0f ? -tt : tt);
      float inv = rsqrtf(nmax(x * x + y * y + z * z, 1e-20f));
      float nx = x * inv, ny = y * inv, nz = z * inv;
      bool ok_n = (cn0 * nx + cn1 * ny + cn2 * nz) > 0.642f;
      wgt = wgt * (ok_n ? 1.0f : 0.0f);
      if (GATE_DEPTH) {
        float tap_lin = __ldg(pdt + t);
        bool ok_d = (fabsf(tap_lin - cd) / nmax(fabsf(cd), 1e-20f)) < 0.05f;
        wgt = wgt * (ok_d ? 1.0f : 0.0f);
      }
      wgt = wgt * (inb ? 1.0f : 0.0f);

      float c[4] = {unpack_hi(h0), unpack_lo(h0), unpack_hi(h1),
                    unpack_lo(h1)};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        cmin[k] = inb ? nmin(cmin[k], c[k]) : cmin[k];
        cmax[k] = inb ? nmax(cmax[k], c[k]) : cmax[k];
        cs[k] = cs[k] + c[k] * wgt;
      }
      if (WITH_EXTRA) {
        float e = __ldg(ext + t);
        e_min = inb ? nmin(e_min, e) : e_min;
        e_max = inb ? nmax(e_max, e) : e_max;
        e_sum = e_sum + e * wgt;
      }
      w_sum = w_sum + wgt;
    }
  }

  float safe_w = fabsf(w_sum) < 1e-20f ? 1e-20f : w_sum;
  const float flo[4] = {0.0f, 0.0f, 0.0f, 1.0f};
  float o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // clip as min(max(v, lo), hi): with no in-bounds tap lo > hi and the
    // result is hi = 0, as jnp.clip gives.
    float v = nmin(nmax(cs[k] / safe_w, cmin[k]), cmax[k]);
    o[k] = nmax(v, flo[k]);
  }
  out_hist[i] = make_float4(o[0], o[1], o[2], o[3]);
  out_ws[i] = w_sum;
  if (WITH_EXTRA) out_ex[i] = nmin(nmax(e_sum / safe_w, e_min), e_max);
}

}  // namespace

#define TAPS_LAUNCH(C, G, E)                                                  \
  taps_kernel<C, G, E><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>( \
      (const int*)cur0, (const int*)cur1, (const int*)h0, (const int*)h1,     \
      (const int*)pn, (const float*)pd, (const float*)ex, (const float*)fxc,  \
      (const float*)fyc, (const float*)fxh, (const float*)fyh,                \
      (const float*)cd, (const float*)cn, (float*)out_cur, (float*)out_ws,    \
      (float4*)out_hist, (float*)out_ex, m, ires_x, ires_y)

// pd may be null when gate_depth is 0; ex and out_ex when with_extra is 0.
extern "C" int temporal_taps(const void* cur0, const void* cur1,
                             const void* h0, const void* h1, const void* pn,
                             const void* pd, const void* ex, const void* fxc,
                             const void* fyc, const void* fxh,
                             const void* fyh, const void* cd, const void* cn,
                             void* out_cur, void* out_ws, void* out_hist,
                             void* out_ex, long long m, int ires_x,
                             int ires_y, int catmull, int gate_depth,
                             int with_extra, void* stream) {
  if (m > 0) {
    int threads = 128;
    long long blocks = (m + threads - 1) / threads;
    int variant = (catmull ? 4 : 0) | (gate_depth ? 2 : 0) |
                  (with_extra ? 1 : 0);
    switch (variant) {
      case 0: TAPS_LAUNCH(false, false, false); break;
      case 1: TAPS_LAUNCH(false, false, true); break;
      case 2: TAPS_LAUNCH(false, true, false); break;
      case 3: TAPS_LAUNCH(false, true, true); break;
      case 4: TAPS_LAUNCH(true, false, false); break;
      case 5: TAPS_LAUNCH(true, false, true); break;
      case 6: TAPS_LAUNCH(true, true, false); break;
      default: TAPS_LAUNCH(true, true, true); break;
    }
  }
  return (int)cudaGetLastError();
}
