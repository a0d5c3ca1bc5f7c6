// B3's two-map fetch on the split table layout, for tools/b3_ab_torch.py:
// two 8-byte loads a corner, one from each map's own packed words, where
// csrc/texfetch.cu's dirs2_kernel makes one 16-byte load from the
// interleaved table. The product source is included whole, so both kernels
// share its projection, corner and decode code and are built with the same
// flags (ops/_cuda.py NVCC_FLAGS, with -I voxelrt_torch/csrc).

#include "texfetch.cu"

namespace {

__global__ void dirs2_split_kernel(const int2* __restrict__ tab_s,
                                   const int2* __restrict__ tab_t, Vec3View d,
                                   Vec3View u, float* __restrict__ out,
                                   long long n, Proj p) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  float fx, fy;
  lane_coords<true>(d, u, i, p, fx, fy);
  Corners c = corners(fx, fy, p.res);
  float3 s = make_float3(0.0f, 0.0f, 0.0f);
  float3 t = make_float3(0.0f, 0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int2 a = __ldg(tab_s + c.tex[k]);
    int2 b = __ldg(tab_t + c.tex[k]);
    add_texel(a.x, a.y, c.w[k], s);
    add_texel(b.x, b.y, c.w[k], t);
  }
  out[i] = s.x;
  out[n + i] = s.y;
  out[2 * n + i] = s.z;
  out[3 * n + i] = t.x;
  out[4 * n + i] = t.y;
  out[5 * n + i] = t.z;
}

}  // namespace

// bilinear_fetch_dirs2's arguments, with the two maps' words in place of
// the interleaved table.
extern "C" int bilinear_fetch_dirs2_split(
    const void* tab_s, const void* tab_t, const void* dx, const void* dy,
    const void* dz, long long sdx, long long sdy, long long sdz,
    const void* ux, const void* uy, const void* uz, long long sux,
    long long suy, long long suz, void* out, long long n, int res,
    void* stream) {
  if (n > 0) {
    dirs2_split_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
        (const int2*)tab_s, (const int2*)tab_t,
        view3(dx, dy, dz, sdx, sdy, sdz), view3(ux, uy, uz, sux, suy, suz),
        (float*)out, n, make_proj(res));
  }
  return (int)cudaGetLastError();
}
