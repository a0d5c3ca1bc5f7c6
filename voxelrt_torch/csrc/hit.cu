// The glue of render/pathtracer.py's ``next_hit`` around B1's closest-hit
// dispatch (kernel H), one lane a thread, in two launches a dispatch:
//
// * ``hit_prepare``, before B1: from the lane's position, direction and
//   ``tracing`` mask, B1's inputs as ``hit_prepare_eager`` forms them: the
//   origin in grid space (pos / voxel_dx - grid_offset), ``tmax`` (inf for a
//   tracing lane, 0 for a dead one) and, with in-kernel NEE, ``alt_t``: the
//   floor crossing in grid units, inf where the floor is not crossed.
// * ``hit_merge``, after B1: from the same lane inputs and B1's distance,
//   cell, normal and colour word, the lane's ``Hit`` as ``hit_merge_eager``
//   forms it: the nearer of the floor plane and the voxel, its normal
//   (the floor's flipped for a ray from below), its albedo (the voxel's
//   colour word decoded, darkened by 0.9 near a cell's edges), whether it
//   is emissive, and its material id.
//
// The floor plane's crossing (the reference's quirky extent test included)
// is computed in registers by both launches rather than stored between
// them: it costs a division and a square root, where storing it would keep
// two more rows alive through B1's dispatch.
//
// It replaces no TPU kernel: the JAX package leaves this glue to XLA, which
// fuses it. Run eagerly it was about 43 kernels a sample, each a round trip
// of its operands through device memory. Here a launch reads each input
// once and writes each output once: about 135 bytes a tracing lane over
// both launches, and 35 a dead lane (its mask twice and its Hit) beside the
// rows a dead lane still gets (its grid origin, tmax and alt_t); bound by
// bytes.
//
// Numerics: built with -fmad=false and written in the eager code's
// operation order; the eager code's Python constants enter as PyTorch
// rounds them into float32, and its division by 255.0 (a CPU scalar) as
// PyTorch's CUDA kernel takes it, a multiply by the float reciprocal.
// Divisions and square roots are IEEE-rounded. So every output equals the
// eager code's bits, dead lanes and misses included.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

// Python's float constants as PyTorch rounds them into float32
constexpr float EPS = (float)1e-6;        // ops/sampling.py EPS
constexpr float TINY = (float)1e-20;      // the dy == 0 guard
constexpr float EDGE_DARKEN = (float)0.9;
constexpr float RCP_255 = 1.0f / 255.0f;  // x / 255.0 as x * (1 / 255)

// The pointer slots of both entries' table, in ops/hit_kernel.py's order.
enum Slot {
  // read by both launches
  PX, PY, PZ, DX, DY, DZ, MASK, FLOOR_H,
  // written by hit_prepare: B1's inputs
  OX, OY, OZ, TMAX, ALT_T,
  // read by hit_merge: B1's outputs and the floor's surface
  DIST, IX, IY, IZ, BNX, BNY, BNZ, WORD, FLOOR_COLOR, FLOOR_MAT, EDGES,
  // written by hit_merge: the Hit
  CLOSEST, NX, NY, NZ, AX, AY, AZ, LIGHT, MAT_ID, N_PTRS
};

struct Args {
  const void* p[N_PTRS];
  float inv_size, offset, voxel_dx;
  long long n;
};

template <typename T>
__device__ __forceinline__ const T* in(const Args& a, int s) {
  return (const T*)a.p[s];
}
template <typename T>
__device__ __forceinline__ T* out(const Args& a, int s) {
  return (T*)a.p[s];
}

// torch.clamp: NaN passes through, else fmaxf/fminf
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

// The floor plane's crossing (pathtracer.py ``floor_plane``): writes its
// distance along the ray and returns whether it is valid (ahead of the ray
// and inside the reference's extent, whose vector less the scalar hit_pos.y
// is a quirky broadcast kept as it is).
__device__ __forceinline__ bool floor_crossing(float fh, float px, float py,
                                               float pz, float dx, float dy,
                                               float dz, float& dist) {
  dist = (fh - py) / (dy == 0.0f ? TINY : dy);
  const float hx = px + dx * dist;
  const float hy = py + dy * dist;
  const float hz = pz + dz * dist;
  const float ex = hx - hy, ey = hy - hy, ez = hz - hy;
  const float e2 = ex * ex + ey * ey + ez * ez;
  const float extent = sqrtf(isnan(e2) ? e2 : fmaxf(e2, 0.0f));
  return dist > EPS && extent < 10.0f;
}

__global__ void __launch_bounds__(THREADS) hit_prepare_kernel(const Args a) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const bool tracing = in<bool>(a, MASK)[i];
  const float px = in<float>(a, PX)[i];
  const float py = in<float>(a, PY)[i];
  const float pz = in<float>(a, PZ)[i];
  out<float>(a, OX)[i] = px * a.inv_size - a.offset;
  out<float>(a, OY)[i] = py * a.inv_size - a.offset;
  out<float>(a, OZ)[i] = pz * a.inv_size - a.offset;
  out<float>(a, TMAX)[i] = tracing ? INFINITY : 0.0f;
  if (a.p[ALT_T] == nullptr) return;
  float alt = INFINITY;
  float dist;
  if (tracing && floor_crossing(*in<float>(a, FLOOR_H), px, py, pz,
                                in<float>(a, DX)[i], in<float>(a, DY)[i],
                                in<float>(a, DZ)[i], dist))
    alt = dist * a.inv_size;
  out<float>(a, ALT_T)[i] = alt;
}

__device__ __forceinline__ int near_edge(float c, float lo, float hi) {
  return (c < lo || c > hi) ? 1 : 0;
}

__global__ void __launch_bounds__(THREADS) hit_merge_kernel(const Args a) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  // a dead lane's Hit: no hit
  float closest = INFINITY;
  float nx = 0.0f, ny = 0.0f, nz = 0.0f;
  float ax = 1.0f, ay = 1.0f, az = 1.0f;
  bool light = false;
  int mat = 0;
  if (in<bool>(a, MASK)[i]) {
    const float px = in<float>(a, PX)[i];
    const float py = in<float>(a, PY)[i];
    const float pz = in<float>(a, PZ)[i];
    const float dx = in<float>(a, DX)[i];
    const float dy = in<float>(a, DY)[i];
    const float dz = in<float>(a, DZ)[i];
    float fd;
    if (floor_crossing(*in<float>(a, FLOOR_H), px, py, pz, dx, dy, dz, fd) &&
        fd < INFINITY) {
      closest = fd;
      // the floor's normal (0, 1, 0), negated for a ray from below
      if (dy > 0.0f) {
        nx = -0.0f;
        ny = -1.0f;
        nz = -0.0f;
      } else {
        ny = 1.0f;
      }
      const float* fc = in<float>(a, FLOOR_COLOR);
      ax = fc[0];
      ay = fc[1];
      az = fc[2];
      mat = *in<int>(a, FLOOR_MAT);
      light = mat == 2;
    }
    const float t = in<float>(a, DIST)[i];
    const int ix = in<int>(a, IX)[i];
    const int iy = in<int>(a, IY)[i];
    const int iz = in<int>(a, IZ)[i];
    const float bnx = in<float>(a, BNX)[i];
    const float bny = in<float>(a, BNY)[i];
    const float bnz = in<float>(a, BNZ)[i];
    const uint32_t word = (uint32_t)in<int>(a, WORD)[i];
    const float vox = t * a.voxel_dx;
    if (vox < closest) {
      closest = vox;
      nx = bnx;
      ny = bny;
      nz = bnz;
      // the hit's place in its cell, from the grid-space origin
      const float ux = clamp(
          ((px * a.inv_size - a.offset) + dx * t) - (float)ix, 0.0f, 1.0f);
      const float uy = clamp(
          ((py * a.inv_size - a.offset) + dy * t) - (float)iy, 0.0f, 1.0f);
      const float uz = clamp(
          ((pz * a.inv_size - a.offset) + dz * t) - (float)iz, 0.0f, 1.0f);
      const float lo = *in<float>(a, EDGES);
      const float hi = 1.0f - lo;
      const int count = near_edge(ux, lo, hi) + near_edge(uy, lo, hi) +
                        near_edge(uz, lo, hi);
      const float dark = 1.0f - EDGE_DARKEN * (count >= 2 ? 1.0f : 0.0f);
      ax = (float)(word & 0xFFu) * RCP_255 * dark;
      ay = (float)((word >> 8) & 0xFFu) * RCP_255 * dark;
      az = (float)((word >> 16) & 0xFFu) * RCP_255 * dark;
      mat = (int)(word >> 24);
      light = mat == 2;
    }
  }
  out<float>(a, CLOSEST)[i] = closest;
  out<float>(a, NX)[i] = nx;
  out<float>(a, NY)[i] = ny;
  out<float>(a, NZ)[i] = nz;
  out<float>(a, AX)[i] = ax;
  out<float>(a, AY)[i] = ay;
  out<float>(a, AZ)[i] = az;
  out<bool>(a, LIGHT)[i] = light;
  out<int>(a, MAT_ID)[i] = mat;
}

int launch(void (*kernel)(const Args), const void* const* p, float inv_size,
           float offset, float voxel_dx, long long n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  Args a;
  for (int s = 0; s < N_PTRS; ++s) a.p[s] = p[s];
  a.inv_size = inv_size;
  a.offset = offset;
  a.voxel_dx = voxel_dx;
  a.n = n;
  const long long blocks = (n + THREADS - 1) / THREADS;
  kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int hit_slots() { return N_PTRS; }

extern "C" int hit_prepare(const void* const* p, float inv_size, float offset,
                           long long n, void* stream) {
  return launch(hit_prepare_kernel, p, inv_size, offset, 0.0f, n, stream);
}

extern "C" int hit_merge(const void* const* p, float inv_size, float offset,
                         float voxel_dx, long long n, void* stream) {
  return launch(hit_merge_kernel, p, inv_size, offset, voxel_dx, n, stream);
}
