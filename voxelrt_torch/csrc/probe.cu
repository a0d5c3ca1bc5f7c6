// Loop-construct probe (kernel P).
//
// Replaces the TPU probe voxelrt's tools/pallas_probe.py:kern: per (8, 128)
// block of float32 lanes a loop of `iters` iterations over 8 float carries
// and one int32 accumulator, with one construct per variant inside the loop:
//   base     nothing but the carries;
//   orred    block-wide OR of (1 << (int(c0) & 31));
//   ctz      count of trailing zeros of the loop counter, by binary search;
//   reduce   block-wide sum of int(c0);
//   reduce2  that sum and the block-wide max of int(c1);
//   rolls    block-wide OR of int(c0) by a log-step sweep;
//   gather   one table read per lane at word (idx + i) of the first
//            1024-word slab, the accumulator taking lane 0's word;
//   fetch    two reads per lane (idx, idx + 1) from the slab picked by i & 31;
//   cond     a branch on the loop counter's parity;
//   alu20    a chain of 10 dependent multiply-adds on c0.
// Outputs: out = c0 + float(acc), as the TPU kernel; and aux = the sum of
// carries 1-7 plus float(the lane's own sum of table words), which keeps the
// per-lane work of every variant observable (the TPU kernel computes it on
// all lanes too and discards it).
//
// It exists to measure, on this card, what one iteration of each construct
// costs inside a loop shaped like B1's (csrc/dda.cu): neither bytes (2 MB in,
// 4 MB out, a 128 KB table that stays in L1/L2) nor operations bound it, but
// the latency of the loop's dependent chain: a block-wide reduction is a
// redux or shuffle sequence, a shared-memory round trip and a barrier; a
// table read is an L1/L2 hit on the read-only path.
//
// Design: one CUDA block of 1024 threads per (8, 128) block, one lane per
// thread, the variant a template parameter, `iters` a run-time argument.
// Block-wide OR, sum and max are a warp redux (or, for `rolls`, five
// __shfl_xor_sync steps, the same log-step sweep as the TPU's rolls), one
// shared-memory slot per warp in a buffer that alternates between uses (so
// one barrier per reduction is enough) and a second warp step. Table reads
// go through __ldg with the word index that the TPU's roll-trick gather
// computes (row (w >> 7) & 7, lane w & 127 of the slab).
// Built with -fmad=false, so alu20 rounds as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Variant { BASE, ORRED, CTZ, REDUCE, REDUCE2, ROLLS, GATHER, FETCH, COND,
               ALU20 };

enum Op { OP_OR, OP_SUM, OP_MAX, OP_OR_SWEEP };

template <int OP>
__device__ __forceinline__ int warp_all(int v) {
  if (OP == OP_OR) return (int)__reduce_or_sync(0xffffffffu, (unsigned)v);
  if (OP == OP_SUM) {
    return (int)__reduce_add_sync(0xffffffffu, (unsigned)v);
  }
  if (OP == OP_MAX) return __reduce_max_sync(0xffffffffu, v);
  for (int sh = 16; sh >= 1; sh >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, sh);
  return v;
}

// The reduction of v over the block's 1024 threads, returned to every thread.
// `parity` is a per-thread copy of the buffer in use; every thread calls this
// the same number of times.
template <int OP>
__device__ __forceinline__ int block_all(int v, int (*slot)[32], int& parity) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_all<OP>(v);
  if (lane == 0) slot[parity][warp] = v;
  __syncthreads();
  int r = warp_all<OP>(slot[parity][lane]);
  parity ^= 1;
  return r;
}

__device__ __forceinline__ int slab_word(const int* slab, int w) {
  return __ldg(slab + (((w >> 7) & 7) << 7) + (w & 127));
}

template <int V>
__global__ void __launch_bounds__(1024) probe_kernel(
    const float* __restrict__ x, const int* __restrict__ tab,
    float* __restrict__ out, float* __restrict__ aux, int iters) {
  __shared__ int slot[2][32];
  __shared__ int lane0[2];
  int parity = 0;
  const long long g = (long long)blockIdx.x * 1024 + threadIdx.x;
  const float x0 = x[g];
  float c[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) c[k] = x0 + (float)k;
  const int idx = (int)x0 & 1023;
  unsigned acc = 0u;       // wraps like the TPU kernel's int32
  unsigned lane_sum = 0u;  // the lane's own table words
  for (int i = 0; i < iters; ++i) {
    if (V == ORRED) {
      int bits = 1 << ((int)c[0] & 31);
      acc += (unsigned)block_all<OP_OR>(bits, slot, parity);
    } else if (V == CTZ) {
      int L = i & (-i);
      int gz = 0;
      bool t = (L & 0xFFFF) == 0;
      gz += t ? 16 : 0;
      L = t ? (L >> 16) & 0xFFFF : L & 0xFFFF;
      t = (L & 0xFF) == 0;
      gz += t ? 8 : 0;
      L = t ? L >> 8 : L & 0xFF;
      t = (L & 0xF) == 0;
      gz += t ? 4 : 0;
      L = t ? L >> 4 : L & 0xF;
      t = (L & 3) == 0;
      gz += t ? 2 : 0;
      L = t ? L >> 2 : L & 3;
      gz += (L & 1) == 0 ? 1 : 0;
      acc += (unsigned)gz;
    } else if (V == REDUCE) {
      acc += (unsigned)block_all<OP_SUM>((int)c[0], slot, parity);
    } else if (V == REDUCE2) {
      acc += (unsigned)block_all<OP_SUM>((int)c[0], slot, parity);
      acc += (unsigned)block_all<OP_MAX>((int)c[1], slot, parity);
    } else if (V == ROLLS) {
      acc += (unsigned)block_all<OP_OR_SWEEP>((int)c[0], slot, parity);
    } else if (V == GATHER || V == FETCH) {
      int w;
      if (V == GATHER) {
        w = slab_word(tab, idx + i);
      } else {
        const int* slab = tab + (i & 31) * 1024;
        w = slab_word(slab, idx) + slab_word(slab, idx + 1);
      }
      lane_sum += (unsigned)w;
      // the accumulator takes lane (0, 0)'s words
      if (threadIdx.x == 0) lane0[parity] = w;
      __syncthreads();
      acc += (unsigned)lane0[parity];
      parity ^= 1;
    } else if (V == COND) {
      if ((i & 1) == 0) acc += 1u;
    } else if (V == ALU20) {
      float v = c[0];
#pragma unroll
      for (int k = 0; k < 10; ++k) v = v * 1.0001f + 0.001f;
      c[0] = v;
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) c[k] = c[k] + 1.0f;
  }
  out[g] = c[0] + (float)(int)acc;
  float rest = c[1];
#pragma unroll
  for (int k = 2; k < 8; ++k) rest = rest + c[k];
  aux[g] = rest + (float)(int)lane_sum;
}

template <int V>
void launch(const float* x, const int* tab, float* out, float* aux, int iters,
            int n_blocks, cudaStream_t stream) {
  probe_kernel<V><<<n_blocks, 1024, 0, stream>>>(x, tab, out, aux, iters);
}

}  // namespace

// x, out, aux: n_blocks * 1024 float32; tab: 256 * 128 int32. Returns
// cudaGetLastError(), or -1 for an unknown variant.
extern "C" int probe(const void* x, const void* tab, void* out, void* aux,
                     int variant, int iters, int n_blocks, void* stream) {
  if (n_blocks <= 0) return 0;
  const float* xf = (const float*)x;
  const int* ti = (const int*)tab;
  float* of = (float*)out;
  float* af = (float*)aux;
  cudaStream_t s = (cudaStream_t)stream;
  switch (variant) {
    case BASE: launch<BASE>(xf, ti, of, af, iters, n_blocks, s); break;
    case ORRED: launch<ORRED>(xf, ti, of, af, iters, n_blocks, s); break;
    case CTZ: launch<CTZ>(xf, ti, of, af, iters, n_blocks, s); break;
    case REDUCE: launch<REDUCE>(xf, ti, of, af, iters, n_blocks, s); break;
    case REDUCE2: launch<REDUCE2>(xf, ti, of, af, iters, n_blocks, s); break;
    case ROLLS: launch<ROLLS>(xf, ti, of, af, iters, n_blocks, s); break;
    case GATHER: launch<GATHER>(xf, ti, of, af, iters, n_blocks, s); break;
    case FETCH: launch<FETCH>(xf, ti, of, af, iters, n_blocks, s); break;
    case COND: launch<COND>(xf, ti, of, af, iters, n_blocks, s); break;
    case ALU20: launch<ALU20>(xf, ti, of, af, iters, n_blocks, s); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
