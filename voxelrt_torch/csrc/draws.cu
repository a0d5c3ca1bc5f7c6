// The wavefront sample's PCG3D draws (kernel D): for every lane, the
// uniforms of a contiguous range of draw slots, as render/pathtracer.py's
// ``Pcg3dDraws`` reads them, with the lane's key fold in the same launch.
//
// A lane's key is ``fold_in(sample_key, pid)`` (ops/prng.py: Threefry-2x32,
// 20 rounds, of the counter pair (0, pid) under the sample key), where pid =
// u * image_height + v is the lane's pixel id. Slot s is component s % 3 of
// the PCG3D hash (ops/sampling.py ``pcg3d``) of (key0, key1, salt), salt =
// 0x9E3779B9 * (s / 3 + 1) mod 2**32, and its uniform is the hash's top 24
// bits times 2**-24 (``u32_to_uniform``). Everything is native uint32
// arithmetic, whose wraparound multiply is the low 32 bits that ``_mul32``
// forms in int64, and the conversion is exact, so every output equals
// ``Pcg3dDraws`` bit for bit.
//
// It replaces no TPU kernel: the JAX package leaves the draws to XLA, which
// fuses them. Run eagerly in int64 they were about 58 elementwise kernels a
// sample, each a round trip of 8 bytes a lane through device memory. Here a
// launch reads each lane's pixel (two float32) and sample key (two int64)
// once, keeps the fold and the hashes in registers, and writes each slot's
// float32 once, slot-major so that a warp's stores to a slot are one
// contiguous run: about 24 + 4 * slots bytes a lane, bound by bytes. The
// fold is computed again in each launch (a few hundred integer operations a
// lane), which is cheaper than storing the folded key and reading it back.
// Sample keys given as scalars (one key for every lane) are read from the
// arguments, not from memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Args {
  const float* u;
  const float* v;
  const long long* k0;  // the lanes' sample key words, or null: k0s, k1s
  const long long* k1;
  uint32_t k0s, k1s;
  long long height;
  int s0, ns;  // the slot range [s0, s0 + ns)
  float* out;  // (ns, n), slot-major
  long long n;
};

__device__ __forceinline__ void mix(uint32_t& x0, uint32_t& x1, int r) {
  x0 += x1;
  x1 = (x1 << r) | (x1 >> (32 - r));
  x1 ^= x0;
}

// Threefry-2x32 with 20 rounds of the counter pair (0, x1) under (k0, k1):
// ops/prng.py ``threefry2x32``
__device__ __forceinline__ void fold_in(uint32_t k0, uint32_t k1, uint32_t x1,
                                        uint32_t& y0, uint32_t& y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  uint32_t x0 = ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    if (i % 2 == 0) {
      mix(x0, x1, 13); mix(x0, x1, 15); mix(x0, x1, 26); mix(x0, x1, 6);
    } else {
      mix(x0, x1, 17); mix(x0, x1, 29); mix(x0, x1, 16); mix(x0, x1, 24);
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  y0 = x0;
  y1 = x1;
}

// ops/sampling.py ``pcg3d``
__device__ __forceinline__ void pcg3d(uint32_t& a, uint32_t& b, uint32_t& c) {
  a = a * 1664525u + 1013904223u;
  b = b * 1664525u + 1013904223u;
  c = c * 1664525u + 1013904223u;
  a += b * c;
  b += c * a;
  c += a * b;
  a ^= a >> 16;
  b ^= b >> 16;
  c ^= c >> 16;
  a += b * c;
  b += c * a;
  c += a * b;
}

// ops/sampling.py ``u32_to_uniform``: exact in float32
__device__ __forceinline__ float to_uniform(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__global__ void __launch_bounds__(THREADS) pcg3d_draws_kernel(const Args a) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= a.n) return;
  const uint32_t k0 = a.k0 ? (uint32_t)a.k0[i] : a.k0s;
  const uint32_t k1 = a.k1 ? (uint32_t)a.k1[i] : a.k1s;
  // the pixel id as the eager code forms it: each coordinate truncated to
  // int64, then taken as u32
  const long long pid = (long long)a.u[i] * a.height + (long long)a.v[i];
  uint32_t kd0, kd1;
  fold_in(k0, k1, (uint32_t)pid, kd0, kd1);
  const int s1 = a.s0 + a.ns;
  for (int t = a.s0 / 3; 3 * t < s1; ++t) {
    uint32_t h[3] = {kd0, kd1, 0x9E3779B9u * (uint32_t)(t + 1)};
    pcg3d(h[0], h[1], h[2]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const int s = 3 * t + c;
      if (s >= a.s0 && s < s1)
        a.out[(long long)(s - a.s0) * a.n + i] = to_uniform(h[c]);
    }
  }
}

}  // namespace

extern "C" int pcg3d_draws(const void* u, const void* v, const void* k0,
                           const void* k1, unsigned k0s, unsigned k1s,
                           long long height, int s0, int ns, void* out,
                           long long n, void* stream) {
  if (n <= 0 || ns <= 0) return (int)cudaGetLastError();
  Args a;
  a.u = (const float*)u;
  a.v = (const float*)v;
  a.k0 = (const long long*)k0;
  a.k1 = (const long long*)k1;
  a.k0s = k0s;
  a.k1s = k1s;
  a.height = height;
  a.s0 = s0;
  a.ns = ns;
  a.out = (float*)out;
  a.n = n;
  const long long blocks = (n + THREADS - 1) / THREADS;
  pcg3d_draws_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
