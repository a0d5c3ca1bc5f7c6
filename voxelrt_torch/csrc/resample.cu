// Temporal resample for moving frames (kernel B4).
//
// Replaces the TPU kernel voxelrt/ops/resample.py:_taps_kernel (via
// temporal_taps). Per output pixel it fuses the bilinear upsample of the
// current colour with the gated history filter: a 4x4 Catmull-Rom (or 2x2
// bilinear) neighbourhood of the reprojected history, each tap gated on
// normal agreement and optionally on depth agreement, normalised by the
// surviving weight and clamped to the min/max of the in-bounds taps
// (anti-ringing).
//
// Sources are read as the frame buffers hold them, views of the active
// aw x ah region with the full buffer's row stride: current colour (3 f32 a
// texel), history (4 f32), previous normals (2 f16, octahedral), the
// previous non-linear depth (f32, linearised here with proj_inv) and an
// optional extra f32 scalar. Every colour and normal value is rounded to
// bf16 as it is loaded, with the TPU path's packing rule (round to nearest
// even in wrapping 32-bit integer arithmetic), so the kernel uses exactly
// the values the JAX package's packed words hold. Per lane it reads the
// texture coordinate (2 f32), the reprojected position (x, y of 3 f32), the
// linear centre depth and the centre normal, and forms the tap coordinates
// itself (tc * aw - 0.5, as the eager caller would).
//
// Bytes: the sources are 36-40 B a texel over 230,400 active texels and a
// lane moves 28-32 B in and 32-36 B out, about 0.02 ms at 3.35 TB/s for
// 921,600 lanes.
//
// What bounds it on an H100 in practice: instructions. A Catmull-Rom lane
// runs 16 taps of tens of instructions each (the twin's separate multiplies
// and adds, the gates, min/max on four channels) and the block's staging,
// several times what its bytes cost.
//
// What the design does about it: a block takes a tile of TX x TY output
// lanes (lane x*h + y; a warp is 32 consecutive y of one column, so per-lane
// reads and writes are coalesced and the history output is one 16-byte
// store). It reduces its lanes' history tap indices (floor(fxh) - 1 .. + 2
// for Catmull-Rom, + 0 .. + 1 for bilinear) to a box: that of the lanes
// whose taps all lie inside the region, so that a sky lane (reprojected to
// -9, its taps clamped to the edge) or a far one does not stretch it. Where
// the box fits its shared-memory budget the block loads it once, a warp down
// each column: history words rounded and packed, the normal decoded once a
// texel (the same operations a tap would run, so the dot product sees the
// same bits), the depth linearised once a texel; the taps then read shared
// memory, and the per-tap decode, linearisation and gathers are gone. If
// no staged value is NaN (the render path's history never is), the taps'
// min/max are plain fminf/fmaxf, which give torch.minimum/maximum's bits
// there. A lane whose clamped taps leave the box, every lane of a block
// whose box does not fit (a sudden turn) and every lane of one whose box
// holds a NaN gathers its taps from global memory with the NaN-propagating
// min/max. A lane whose taps all lie inside
// the region skips the clamps and the bounds mask, and the depth gate
// compares against a per-lane threshold instead of dividing (exact; see
// depth_gate_threshold). The current colour's four corners a lane are read
// from memory (neighbouring lanes share them in L1). ``counts``, when given,
// receives the blocks, those whose box did not fit, the lanes that gathered
// their history taps from global memory, and the texels staged.
//
// Arithmetic follows the TPU kernel's order exactly (corner order and
// w = wx*wy for the current colour; ox outer, oy inner for the taps; weight
// wgx*wgy, then the normal gate, the depth gate and the bounds flag), and the
// file is built with -fmad=false, so every rounding matches the plain
// PyTorch twin in voxelrt_torch/ops/resample.py. The min/max helpers are
// PyTorch's own on the card: they propagate NaN and take fminf/fmaxf's sign
// of a zero, so the clamps give the twin's bits.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TY = 32;  // lanes of a column in a tile: one warp
constexpr int TX = 8;   // columns in a tile
constexpr int THREADS = TX * TY;
constexpr int HBOX = 1024;  // history texels a block may stage (28 KB)

struct Args {
  const float* cur;  // texel (x, y) at cur + x * cur_rs + y * 3
  const float* hist;  // at hist + x * hist_rs + y * 4, 16-byte aligned
  const unsigned int* nrm;  // two f16 a texel, at nrm + x * nrm_rs + y
  const float* dep;  // non-linear previous depth, at dep + x * dep_rs + y
  const float* ext;  // extra scalar, at ext + x * ext_rs + y
  long long cur_rs, hist_rs, nrm_rs, dep_rs, ext_rs;
  const float* proj_inv;  // 4x4 row-major
  const float* tc;  // per lane: texcoord (2), reprojection (3), centre
  const float* rp;  // depth (1) and centre normal (3)
  const float* cd;
  const float* cn;
  float* out_cur;
  float* out_ws;
  float4* out_hist;
  float* out_ex;
  // null, or: blocks, blocks whose history box did not fit, lanes that
  // gathered their history taps from global memory, texels staged
  int* counts;
  int w, h, aw, ah;
};

// f32 -> the f32 whose bits are its bf16 rounding (nearest even), the rule
// of ops/resample.py:_bf16_bits in wrapping 32-bit arithmetic.
__device__ __forceinline__ unsigned bf16_bits(float x) {
  unsigned b = __float_as_uint(x);
  return ((b + (((b >> 16) & 1u) + 0x7FFFu)) >> 16) & 0xFFFFu;
}

__device__ __forceinline__ int pack2(float a, float b) {
  return (int)((bf16_bits(a) << 16) | bf16_bits(b));
}

__device__ __forceinline__ float unpack_hi(int w) {
  return __int_as_float(w & (int)0xFFFF0000);
}

__device__ __forceinline__ float unpack_lo(int w) {
  return __int_as_float((int)((unsigned)w << 16));
}

// torch.minimum/maximum (and torch.clamp) on the card: NaN when either
// operand is NaN (the first if both are), else fminf/fmaxf, which order -0
// below +0.
__device__ __forceinline__ float nmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float nmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__device__ __forceinline__ int clampi(long long v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : (int)v);
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

// One history texel as the taps use it.
struct Texel {
  int h0, h1;  // pack2(r, g), pack2(b, w)
  float nx, ny, nz;  // decoded previous normal
  float d;  // linear previous depth (GATE_DEPTH)
  float e;  // extra (WITH_EXTRA)
};

template <bool GATE_DEPTH, bool WITH_EXTRA>
__device__ __forceinline__ Texel load_texel(const Args& a, int x, int y,
                                            float p32, float p33) {
  Texel t;
  float4 c = *reinterpret_cast<const float4*>(a.hist + x * a.hist_rs + y * 4);
  t.h0 = pack2(c.x, c.y);
  t.h1 = pack2(c.z, c.w);
  unsigned n = __ldg(a.nrm + x * a.nrm_rs + y);
  int pn = pack2(__half2float(__ushort_as_half((unsigned short)(n & 0xFFFFu))),
                 __half2float(__ushort_as_half((unsigned short)(n >> 16))));
  // octahedral normal from the bf16 pair
  float ex = unpack_hi(pn) * 2.0f - 1.0f;
  float ey = unpack_lo(pn) * 2.0f - 1.0f;
  float z = 1.0f - fabsf(ex) - fabsf(ey);
  float tt = nmax(-z, 0.0f);
  float xx = ex + (ex >= 0.0f ? -tt : tt);
  float yy = ey + (ey >= 0.0f ? -tt : tt);
  float inv = rsqrtf(nmax(xx * xx + yy * yy + z * z, 1e-20f));
  t.nx = xx * inv;
  t.ny = yy * inv;
  t.nz = z * inv;
  t.d = 0.0f;
  t.e = 0.0f;
  if (GATE_DEPTH) {
    float d = __ldg(a.dep + x * a.dep_rs + y);
    t.d = 1.0f / ((d * 2.0f - 1.0f) * p32 + p33);
  }
  if (WITH_EXTRA) t.e = __ldg(a.ext + x * a.ext_rs + y);
  return t;
}

__device__ __forceinline__ int load_cur(const Args& a, int x, int y,
                                        int* c1) {
  const float* p = a.cur + x * a.cur_rs + y * 3;
  *c1 = pack2(__ldg(p + 2), 0.0f);
  return pack2(__ldg(p), __ldg(p + 1));
}

// The depth gate (|d - cd| / max(|cd|, 1e-20)) < 0.05f without its
// division: the rounded quotient is below 0.05f exactly when the exact one
// is at most the midpoint between 0.05f and the float below it (a tie rounds
// to that float, whose significand is even), so when |d - cd| is at most
// that midpoint times the divisor, rounded down to a float (exact in double:
// 25 by 24 significant bits). An infinite divisor passes every finite
// |d - cd| (FLT_MAX); a NaN one passes none. Returns the per-lane threshold.
__device__ __forceinline__ float depth_gate_threshold(float cd) {
  float m = nmax(fabsf(cd), 1e-20f);
  if (isinf(m)) return FLT_MAX;
  return __double2float_rd(0x1.9999990000000p-5 * (double)m);
}

// The gated history taps of one lane and the anti-ringing clamp.
// ``fetch(qx, qy)`` returns the texel at clamped coordinates. FAST: no
// value the lane can read is NaN, so the NaN-propagating min/max reduce to
// fminf/fmaxf, which give the same bits there. INNER: every tap of the lane
// lies inside the region, so none is clamped or masked.
template <bool CATMULL, bool GATE_DEPTH, bool WITH_EXTRA, bool FAST,
          bool INNER, typename Fetch>
__device__ __forceinline__ void history_taps(const Args& a, long long i,
                                             float fxh, float fyh, int ix,
                                             int iy, Fetch fetch) {
  constexpr int T0 = CATMULL ? -1 : 0;
  constexpr int T1 = CATMULL ? 3 : 2;
  constexpr int NT = T1 - T0;
  const int aw = a.aw, ah = a.ah;
  float fx = fxh - (float)ix;
  float fy = fyh - (float)iy;
  const float dthr = GATE_DEPTH ? depth_gate_threshold(a.cd[i]) : 0.0f;
  const float cd = GATE_DEPTH ? a.cd[i] : 0.0f;
  float cn0 = a.cn[3 * i + 0];
  float cn1 = a.cn[3 * i + 1];
  float cn2 = a.cn[3 * i + 2];
  float wx[NT], wy[NT];
#pragma unroll
  for (int o = 0; o < NT; ++o) {
    wx[o] = tap_weight<CATMULL>(o + T0, fx);
    wy[o] = tap_weight<CATMULL>(o + T0, fy);
  }

  const float BIGF = 999999.0f;
  float cs[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float cmin[4] = {BIGF, BIGF, BIGF, BIGF};
  float cmax[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float e_sum = 0.0f, e_min = BIGF, e_max = 0.0f;
  float w_sum = 0.0f;

#pragma unroll
  for (int ox = T0; ox < T1; ++ox) {
#pragma unroll
    for (int oy = T0; oy < T1; ++oy) {
      float wgt = wx[ox - T0] * wy[oy - T0];
      int tx = ix + ox;
      int ty = iy + oy;
      bool inb = INNER || ((tx >= 0) && (tx < aw) && (ty >= 0) && (ty < ah));
      Texel t = INNER ? fetch(tx, ty)
                      : fetch(clampi(tx, 0, aw - 1), clampi(ty, 0, ah - 1));
      bool ok_n = (cn0 * t.nx + cn1 * t.ny + cn2 * t.nz) > 0.642f;
      wgt = wgt * (ok_n ? 1.0f : 0.0f);
      if (GATE_DEPTH) {
        bool ok_d = fabsf(t.d - cd) <= dthr;
        wgt = wgt * (ok_d ? 1.0f : 0.0f);
      }
      if (!INNER) wgt = wgt * (inb ? 1.0f : 0.0f);

      float c[4] = {unpack_hi(t.h0), unpack_lo(t.h0), unpack_hi(t.h1),
                    unpack_lo(t.h1)};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (inb) {
          cmin[k] = FAST ? fminf(cmin[k], c[k]) : nmin(cmin[k], c[k]);
          cmax[k] = FAST ? fmaxf(cmax[k], c[k]) : nmax(cmax[k], c[k]);
        }
        cs[k] = cs[k] + c[k] * wgt;
      }
      if (WITH_EXTRA) {
        if (inb) {
          e_min = FAST ? fminf(e_min, t.e) : nmin(e_min, t.e);
          e_max = FAST ? fmaxf(e_max, t.e) : nmax(e_max, t.e);
        }
        e_sum = e_sum + t.e * wgt;
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
  a.out_hist[i] = make_float4(o[0], o[1], o[2], o[3]);
  a.out_ws[i] = w_sum;
  if (WITH_EXTRA) a.out_ex[i] = nmin(nmax(e_sum / safe_w, e_min), e_max);
}

// Four blocks an SM: 64 registers a thread. ptxas spills a few words in the
// Catmull-Rom variants; on an H100 that is about 10% faster than their
// 75-80 registers at three blocks an SM.
template <bool CATMULL, bool GATE_DEPTH, bool WITH_EXTRA>
__global__ void __launch_bounds__(THREADS, 4)
    taps_kernel(const Args a) {
  __shared__ int2 s_hist[HBOX];
  __shared__ float s_nx[HBOX], s_ny[HBOX], s_nz[HBOX];
  __shared__ float s_d[GATE_DEPTH ? HBOX : 1];
  __shared__ float s_e[WITH_EXTRA ? HBOX : 1];
  // Boxes, as minima of (x0, y0, -x1, -y1): the history taps of the lanes
  // whose taps all lie inside the region (0-3), the clamped history taps of
  // every lane (4-7).
  __shared__ int s_box[8];

  constexpr int T0 = CATMULL ? -1 : 0;
  constexpr int T1 = CATMULL ? 3 : 2;
  const int tid = threadIdx.y * TY + threadIdx.x;
  const int x = blockIdx.y * TX + threadIdx.y;
  const int y = blockIdx.x * TY + threadIdx.x;
  const bool valid = x < a.w && y < a.h;
  const long long i = (long long)x * a.h + y;
  const int aw = a.aw, ah = a.ah;

  if (tid < 8) s_box[tid] = INT_MAX;

  // per-lane coordinates, formed as the eager caller forms them
  float fxh = 0.0f, fyh = 0.0f;
  int ix = 0, iy = 0;
  int q[4] = {0, 0, 0, 0};  // the lane's clamped history footprint
  bool inner = false;  // no tap of the lane clamped
  int bx[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) bx[k] = INT_MAX;
  if (valid) {
    fxh = sane_coord(a.rp[3 * i] * (float)aw - 0.5f);
    fyh = sane_coord(a.rp[3 * i + 1] * (float)ah - 0.5f);
    ix = (int)floorf(fxh);
    iy = (int)floorf(fyh);
    q[0] = clampi(ix + T0, 0, aw - 1);
    q[1] = clampi(iy + T0, 0, ah - 1);
    q[2] = clampi(ix + T1 - 1, 0, aw - 1);
    q[3] = clampi(iy + T1 - 1, 0, ah - 1);
    inner = q[0] == ix + T0 && q[1] == iy + T0 && q[2] == ix + T1 - 1 &&
            q[3] == iy + T1 - 1;
    if (inner) {
      bx[0] = q[0];
      bx[1] = q[1];
      bx[2] = -q[2];
      bx[3] = -q[3];
    }
    bx[4] = q[0];
    bx[5] = q[1];
    bx[6] = -q[2];
    bx[7] = -q[3];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int v = __reduce_min_sync(0xFFFFFFFFu, bx[k]);
    if ((tid & 31) == 0) atomicMin(&s_box[k], v);
  }
  __syncthreads();
  // The box of the lanes whose taps all fall inside the region, so that a
  // sky lane (reprojected to -9) or a far one does not stretch it; a block
  // with none of those takes every lane's clamped taps.
  const int hb = s_box[0] != INT_MAX ? 0 : 4;
  const int hx0 = s_box[hb], hy0 = s_box[hb + 1];
  const int hx1 = -s_box[hb + 2], hy1 = -s_box[hb + 3];
  const int hbh = hy1 - hy0 + 1;
  const int hbw = hx1 - hx0 + 1;
  const bool stage_h = hbw * hbh <= HBOX;
  // a lane whose clamped taps leave the box gathers them from global memory
  const bool lane_h = stage_h && q[0] >= hx0 && q[1] >= hy0 && q[2] <= hx1 &&
                      q[3] <= hy1;
  if (a.counts != nullptr && tid == 0) {
    atomicAdd(a.counts, 1);
    if (!stage_h) atomicAdd(a.counts + 1, 1);
    if (stage_h) atomicAdd(a.counts + 3, hbw * hbh);
  }
  const float p32 = GATE_DEPTH ? __ldg(a.proj_inv + 14) : 0.0f;
  const float p33 = GATE_DEPTH ? __ldg(a.proj_inv + 15) : 0.0f;

  // --- stage the history box: a warp down each column -------------------------
  bool nan_seen = false;
  if (stage_h) {
    for (int c = threadIdx.y; c < hbw; c += TX) {
      for (int r = threadIdx.x; r < hbh; r += TY) {
        Texel t = load_texel<GATE_DEPTH, WITH_EXTRA>(a, hx0 + c, hy0 + r,
                                                     p32, p33);
        int k = c * hbh + r;
        s_hist[k] = make_int2(t.h0, t.h1);
        s_nx[k] = t.nx;
        s_ny[k] = t.ny;
        s_nz[k] = t.nz;
        if (GATE_DEPTH) s_d[k] = t.d;
        if (WITH_EXTRA) s_e[k] = t.e;
        float v[4] = {unpack_hi(t.h0), unpack_lo(t.h0), unpack_hi(t.h1),
                      unpack_lo(t.h1)};
        nan_seen |= (v[0] != v[0]) | (v[1] != v[1]) | (v[2] != v[2]) |
                    (v[3] != v[3]) | (WITH_EXTRA && t.e != t.e);
      }
    }
  }
  // A box holding a NaN sends its lanes to the global route, whose min/max
  // propagate it. (Every thread reaches the barrier.)
  const bool box_nan = __syncthreads_or(nan_seen);
  const bool from_box = lane_h && !box_nan;
  if (a.counts != nullptr) {
    unsigned far = __ballot_sync(0xFFFFFFFFu, valid && !from_box);
    if ((tid & 31) == 0 && far) atomicAdd(a.counts + 2, __popc(far));
  }
  if (!valid) return;

  // --- current-colour bilinear, from memory ----------------------------------
  {
    float fxc = a.tc[2 * i] * (float)aw - 0.5f;
    float fyc = a.tc[2 * i + 1] * (float)ah - 0.5f;
    float ixc = floorf(fxc);
    float iyc = floorf(fyc);
    float gx = fxc - ixc;
    float gy = fyc - iyc;
    long long ixi = (long long)ixc;
    long long iyi = (long long)iyc;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
    const int cxs[4] = {0, 1, 0, 1};
    const int cys[4] = {0, 0, 1, 1};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float wx = cxs[c] ? gx : 1.0f - gx;
      float wy = cys[c] ? gy : 1.0f - gy;
      float w = wx * wy;
      int c1;
      int c0 = load_cur(a, clampi(ixi + cxs[c], 0, aw - 1),
                        clampi(iyi + cys[c], 0, ah - 1), &c1);
      a0 = a0 + w * unpack_hi(c0);
      a1 = a1 + w * unpack_lo(c0);
      a2 = a2 + w * unpack_hi(c1);
    }
    a.out_cur[3 * i + 0] = a0;
    a.out_cur[3 * i + 1] = a1;
    a.out_cur[3 * i + 2] = a2;
  }

  // --- gated history taps -----------------------------------------------------
  auto box_texel = [&](int qx, int qy) {
    int k = (qx - hx0) * hbh + (qy - hy0);
    int2 s = s_hist[k];
    Texel t;
    t.h0 = s.x;
    t.h1 = s.y;
    t.nx = s_nx[k];
    t.ny = s_ny[k];
    t.nz = s_nz[k];
    t.d = GATE_DEPTH ? s_d[k] : 0.0f;
    t.e = WITH_EXTRA ? s_e[k] : 0.0f;
    return t;
  };
  auto memory_texel = [&](int qx, int qy) {
    return load_texel<GATE_DEPTH, WITH_EXTRA>(a, qx, qy, p32, p33);
  };
  if (from_box && inner) {
    history_taps<CATMULL, GATE_DEPTH, WITH_EXTRA, true, true>(
        a, i, fxh, fyh, ix, iy, box_texel);
  } else if (from_box) {
    history_taps<CATMULL, GATE_DEPTH, WITH_EXTRA, true, false>(
        a, i, fxh, fyh, ix, iy, box_texel);
  } else {
    history_taps<CATMULL, GATE_DEPTH, WITH_EXTRA, false, false>(
        a, i, fxh, fyh, ix, iy, memory_texel);
  }
}

}  // namespace

#define TAPS_LAUNCH(C, G, E) \
  taps_kernel<C, G, E><<<grid, block, 0, (cudaStream_t)stream>>>(a)

// Pointers: the five source views and their row strides in elements (dep
// may be null when gate_depth is 0, ext and out_ex when with_extra is 0),
// proj_inv, the four per-lane inputs, the four outputs, and counts (may be
// null). w x h output lanes over an aw x ah source region.
extern "C" int temporal_taps(
    const void* cur, long long cur_rs, const void* hist, long long hist_rs,
    const void* nrm, long long nrm_rs, const void* dep, long long dep_rs,
    const void* ext, long long ext_rs, const void* proj_inv, const void* tc,
    const void* rp, const void* cd, const void* cn, void* out_cur,
    void* out_ws, void* out_hist, void* out_ex, void* counts, int w, int h,
    int aw, int ah, int catmull, int gate_depth, int with_extra,
    void* stream) {
  if (w <= 0 || h <= 0) return (int)cudaGetLastError();
  Args a;
  a.cur = (const float*)cur;
  a.hist = (const float*)hist;
  a.nrm = (const unsigned int*)nrm;
  a.dep = (const float*)dep;
  a.ext = (const float*)ext;
  a.cur_rs = cur_rs;
  a.hist_rs = hist_rs;
  a.nrm_rs = nrm_rs / 2;  // in pairs of f16
  a.dep_rs = dep_rs;
  a.ext_rs = ext_rs;
  a.proj_inv = (const float*)proj_inv;
  a.tc = (const float*)tc;
  a.rp = (const float*)rp;
  a.cd = (const float*)cd;
  a.cn = (const float*)cn;
  a.out_cur = (float*)out_cur;
  a.out_ws = (float*)out_ws;
  a.out_hist = (float4*)out_hist;
  a.out_ex = (float*)out_ex;
  a.counts = (int*)counts;
  a.w = w;
  a.h = h;
  a.aw = aw;
  a.ah = ah;
  dim3 block(TY, TX);
  dim3 grid((unsigned)((h + TY - 1) / TY), (unsigned)((w + TX - 1) / TX));
  int variant = (catmull ? 4 : 0) | (gate_depth ? 2 : 0) | (with_extra ? 1 : 0);
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
  return (int)cudaGetLastError();
}
