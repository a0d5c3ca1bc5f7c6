// Skybox texel fetches from bf16-packed RGB maps (kernels B2 and B3).
//
// Replaces the TPU kernels voxelrt/ops/texfetch.py:_point_kernel (B2, via
// point_fetch_words) and voxelrt/ops/texfetch.py:_bilinear_kernel (B3, via
// bilinear_fetch_packed). Packing: texel t -> word[2t] = bf16(r) << 16 |
// bf16(g), word[2t+1] = bf16(b) << 16. The interleaved table of both sky
// maps (ops/texfetch.py interleave_words) holds 16 bytes a texel: the
// scattering map's two words, then the transmittance map's two.
//
// B3 has three entries. bilinear_fetch_packed takes texel-space coordinates
// (fx, fy), the JAX kernel's own interface. bilinear_fetch_dirs and
// bilinear_fetch_dirs2 take the direction instead (three strided component
// views, read in place, and the jitter's three uniforms when given) and map
// it to (fx, fy) in the kernel (sky_project.cuh), so that a sky lookup is
// one launch with no eager kernels around it; dirs2 fetches both maps at the
// same coordinates, one aligned 16-byte load a corner from the interleaved
// table.
//
// What bounds them on an H100: memory. B2 reads a 4-byte index, gathers one
// 8-byte word pair from the 8 MB map (1024^2 texels) and writes 8 bytes per
// lane; B3 reads 8 bytes of coordinates (12 or 24 of direction and jitter),
// gathers four texels and writes 12 bytes a map. The maps stay resident in
// the 50 MB L2, so a gather costs L2 sectors (32 B) rather than HBM bytes:
// corners (ax, ay) and (ax, ay + 1) share a sector most of the time, the
// ax + 1 row lies res texels away. dirs2's 16-byte record brings both maps
// in the sectors that one map's corners took from two arrays.
//
// What the design does about it: one thread per lane, consecutive threads on
// consecutive lanes so the coordinate reads and the output writes are
// coalesced; each texel is one aligned load through the read-only path. The
// TPU kernels' VMEM slab loop (a min-reduce over distinct (8,128) slabs)
// exists only because a TPU lane cannot address VMEM freely; a GPU thread
// can, so it is gone.
//
// B3 decodes the bf16 words with integer masks and __int_as_float exactly as
// texfetch.py:96-98 does, and accumulates the four corners in the TPU
// kernel's order; the file is built with -fmad=false, so every rounding
// matches the plain PyTorch twins in voxelrt_torch/ops/texfetch.py.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sky_project.cuh"

namespace {

__global__ void point_kernel(const int2* __restrict__ tab,
                             const int* __restrict__ wid,
                             int* __restrict__ w0, int* __restrict__ w1,
                             long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  int2 p = __ldg(tab + (wid[i] >> 1));
  w0[i] = p.x;
  w1[i] = p.y;
}

__device__ __forceinline__ int pymod(int a, int m) {
  int r = a % m;
  return r < 0 ? r + m : r;
}

// The four corners of a wraparound bilinear fetch at (fx, fy): texel
// indices ax * res + ay and weights, in the TPU kernel's corner order.
struct Corners {
  int tex[4];
  float w[4];
};

__device__ __forceinline__ Corners corners(float fx, float fy, int res) {
  // NaN/garbage guards: clamp instead of poisoning indices.
  fx = isfinite(fx) ? fx : 0.0f;
  fy = isfinite(fy) ? fy : 0.0f;
  fx = fminf(fmaxf(fx, -1.0e6f), 1.0e6f);
  fy = fminf(fmaxf(fy, -1.0e6f), 1.0e6f);
  float ix = floorf(fx);
  float iy = floorf(fy);
  float gx = fx - ix;
  float gy = fy - iy;
  int ixi = (int)ix;
  int iyi = (int)iy;
  Corners c;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int cx = k & 1, cy = k >> 1;
    float wx = cx ? gx : 1.0f - gx;
    float wy = cy ? gy : 1.0f - gy;
    c.w[k] = wx * wy;
    c.tex[k] = pymod(ixi + cx, res) * res + pymod(iyi + cy, res);
  }
  return c;
}

// acc += w * texel, the texel's words (w0, w1) decoded from bf16.
__device__ __forceinline__ void add_texel(int w0, int w1, float w,
                                          float3& acc) {
  float r = __int_as_float(w0 & (int)0xFFFF0000);
  float g = __int_as_float((int)((unsigned)w0 << 16));
  float b = __int_as_float(w1 & (int)0xFFFF0000);
  acc.x = acc.x + w * r;
  acc.y = acc.y + w * g;
  acc.z = acc.z + w * b;
}

__global__ void bilinear_kernel(const int2* __restrict__ tab,
                                const float* __restrict__ fxp,
                                const float* __restrict__ fyp,
                                float* __restrict__ out, long long n,
                                int res) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  Corners c = corners(fxp[i], fyp[i], res);
  float3 acc = make_float3(0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int2 p = __ldg(tab + c.tex[k]);
    add_texel(p.x, p.y, c.w[k], acc);
  }
  out[i] = acc.x;
  out[n + i] = acc.y;
  out[2 * n + i] = acc.z;
}

// Three float32 component views of one per-lane vector, each with its own
// element stride.
struct Vec3View {
  const float* x;
  const float* y;
  const float* z;
  long long sx, sy, sz;
};

struct Proj {
  int res;
  float res_f, scale, offset;
};

// Lane i's texel-space coordinates: its direction, jittered when kJitter,
// projected onto the map.
template <bool kJitter>
__device__ __forceinline__ void lane_coords(const Vec3View& d,
                                            const Vec3View& u, long long i,
                                            const Proj& p, float& fx,
                                            float& fy) {
  float x = __ldg(d.x + i * d.sx);
  float y = __ldg(d.y + i * d.sy);
  float z = __ldg(d.z + i * d.sz);
  if (kJitter)
    skyproj::jitter(x, y, z, __ldg(u.x + i * u.sx), __ldg(u.y + i * u.sy),
                    __ldg(u.z + i * u.sz));
  skyproj::texel_coords(x, y, z, p.res_f, p.scale, p.offset, fx, fy);
}

template <bool kJitter>
__global__ void dirs_kernel(const int2* __restrict__ tab, Vec3View d,
                            Vec3View u, float* __restrict__ out, long long n,
                            Proj p) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float fx, fy;
  lane_coords<kJitter>(d, u, i, p, fx, fy);
  Corners c = corners(fx, fy, p.res);
  float3 acc = make_float3(0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int2 q = __ldg(tab + c.tex[k]);
    add_texel(q.x, q.y, c.w[k], acc);
  }
  out[i] = acc.x;
  out[n + i] = acc.y;
  out[2 * n + i] = acc.z;
}

// Both maps at the jittered direction's coordinates, one 16-byte load a
// corner from the interleaved table.
__global__ void dirs2_kernel(const int4* __restrict__ tab, Vec3View d,
                             Vec3View u, float* __restrict__ out, long long n,
                             Proj p) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float fx, fy;
  lane_coords<true>(d, u, i, p, fx, fy);
  Corners c = corners(fx, fy, p.res);
  float3 s = make_float3(0.0f, 0.0f, 0.0f);
  float3 t = make_float3(0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int4 q = __ldg(tab + c.tex[k]);
    add_texel(q.x, q.y, c.w[k], s);
    add_texel(q.z, q.w, c.w[k], t);
  }
  out[i] = s.x;
  out[n + i] = s.y;
  out[2 * n + i] = s.z;
  out[3 * n + i] = t.x;
  out[4 * n + i] = t.y;
  out[5 * n + i] = t.z;
}

constexpr int kThreads = 256;

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

Proj make_proj(int res) {
  double fres = 1.0 / res;  // project_sky_soa's Python arithmetic
  return Proj{res, (float)res, (float)(1.0 - fres), (float)(0.5 * fres)};
}

Vec3View view3(const void* x, const void* y, const void* z, long long sx,
               long long sy, long long sz) {
  return Vec3View{(const float*)x, (const float*)y, (const float*)z,
                  sx, sy, sz};
}

}  // namespace

extern "C" int point_fetch_words(const void* tab, const void* wid, void* w0,
                                 void* w1, long long n, void* stream) {
  if (n > 0) {
    point_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int2*)tab, (const int*)wid, (int*)w0, (int*)w1, n);
  }
  return (int)cudaGetLastError();
}

// out: (3, n) float32, the r, g and b rows.
extern "C" int bilinear_fetch_packed(const void* tab, const void* fx,
                                     const void* fy, void* out, long long n,
                                     int res, void* stream) {
  if (n > 0) {
    bilinear_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int2*)tab, (const float*)fx, (const float*)fy, (float*)out, n,
        res);
  }
  return (int)cudaGetLastError();
}

// d*/sd*: the direction's components and their element strides; u*/su*
// the jitter's uniforms (ux null: no jitter). out: (3, n) float32.
extern "C" int bilinear_fetch_dirs(const void* tab, const void* dx,
                                   const void* dy, const void* dz,
                                   long long sdx, long long sdy,
                                   long long sdz, const void* ux,
                                   const void* uy, const void* uz,
                                   long long sux, long long suy,
                                   long long suz, void* out, long long n,
                                   int res, void* stream) {
  if (n > 0) {
    Vec3View d = view3(dx, dy, dz, sdx, sdy, sdz);
    Vec3View u = view3(ux, uy, uz, sux, suy, suz);
    cudaStream_t s = (cudaStream_t)stream;
    if (ux != nullptr)
      dirs_kernel<true><<<blocks_for(n), kThreads, 0, s>>>(
          (const int2*)tab, d, u, (float*)out, n, make_proj(res));
    else
      dirs_kernel<false><<<blocks_for(n), kThreads, 0, s>>>(
          (const int2*)tab, d, u, (float*)out, n, make_proj(res));
  }
  return (int)cudaGetLastError();
}

// tab: the interleaved table, 16-byte aligned. out: (6, n) float32, the
// scattering map's r, g, b rows, then the transmittance map's.
extern "C" int bilinear_fetch_dirs2(const void* tab, const void* dx,
                                    const void* dy, const void* dz,
                                    long long sdx, long long sdy,
                                    long long sdz, const void* ux,
                                    const void* uy, const void* uz,
                                    long long sux, long long suy,
                                    long long suz, void* out, long long n,
                                    int res, void* stream) {
  if (n > 0) {
    dirs2_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int4*)tab, view3(dx, dy, dz, sdx, sdy, sdz),
        view3(ux, uy, uz, sux, suy, suz), (float*)out, n, make_proj(res));
  }
  return (int)cudaGetLastError();
}
