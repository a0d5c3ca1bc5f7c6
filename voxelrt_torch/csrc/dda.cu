// Closest-hit voxel traversal with sun-cone NEE (kernel B1).
//
// Replaces the TPU kernel voxelrt/ops/dda_pallas.py:_traverse_kernel (via
// raytrace_pallas): rays in grid space [0, res)^3, an AABB clip, an
// empty-space march that jumps to the exit of the box certified empty by the
// 4-bit chebyshev distance field over 8^3 cells (dist3_words) or of the free
// LOD2 X-slab, a rank-compressed 64-bit mask fetch at an occupied 4^3 cell
// (solid cells read all ones) followed by a <=9-step in-cell voxel DDA, the
// face normal, and the hit colour word from the morton-rank compressed
// colour table (direct or palette mode). In NEE mode a retired primary with
// a surface (a voxel hit, or the caller's floor crossing alt_t when closer)
// becomes its sun-cone shadow ray, and the kernel reports whether that ray
// escapes (nee_visible).
//
// Shadow mode (template parameter SHADOW; the TPU kernel's any_hit with
// fetch_colors off, used by the explicit sun-shadow dispatch) runs the same
// march and in-cell DDA, which stops on the first occupied voxel of the
// ray's path, but tracks no normal, fetches no colour and writes the
// distance only: 4 bytes out per ray instead of 44.
//
// What bounds it on an H100: neither HBM bandwidth nor FLOP rate. Per ray it
// moves ~60-100 bytes of inputs and outputs, but it runs a data-dependent
// loop of tens to hundreds of dependent steps, each a few table reads (L1/L2
// hits: the tables of a 128^3 scene total well under 2 MB) and ~100 integer
// and float operations. A warp runs as long as its slowest lane, so the
// limit is issue slots lost to lanes that have nothing (left) to do and the
// latency of the dependent table reads.
//
// What the design does about it. One thread per ray, a per-thread loop with
// divergent exits, each thread taking the JAX kernel's per-ray sequence of
// steps (which the JAX package's own tests show bitwise identical to its
// queued TPU form). Three launches per dispatch keep the warps full:
//   1. compact_kernel builds the list of alive rays (one ballot and popc per
//      warp, a block-wide prefix in shared memory, one atomicAdd per block
//      into a device counter) and writes the canonical miss for every dead
//      lane (dda_pallas.py:1148-1156). The count stays on the device.
//   2. closest_kernel / anyhit_kernel trace the alive list only (threads
//      past the device count exit) and scatter each ray's outputs to its
//      original index. In NEE mode a converted primary writes its shadow
//      ray (origin, direction, index: 28 B) into scratch and appends it to
//      a second list with one atomicAdd per warp, instead of marching it in
//      the same thread while its warp's other lanes wait.
//   3. nee_shadow_kernel traces that list densely and writes nee_visible.
// The sun-open certificate (sun_open_words, one bit per 4^3 cell: the
// whole sun cone escapes the grid from anywhere in the cell) retires shadow
// rays early with the JAX kernel's verdicts: at every advance, before the
// occupancy test, a live ray standing in a certified cell retires as a
// miss (dda_pallas.py:482-496; a second word read at the LOD2 word's
// index), and with nee_src_open a converted shadow ray whose clip misses
// the grid or whose entry cell is certified is visible without a march
// (dda_pallas.py:864-905). The TPU kernel's lock-step (rows, 128) blocks,
// per-slot ray queues with refill rounds, roll-trick gathers, slab scans,
// march unrolling and fetch deferral are TPU scheduling devices and are not
// carried over. The per-step state is kept in the TPU kernel's packed word
// (position + normal) so that out-of-range march targets alias exactly as
// they do there. Tables are read through the read-only cache.
//
// Numerics: built with -fmad=false and written in the JAX kernel's operation
// order, so results match the plain PyTorch twin
// (voxelrt_torch/ops/dda_kernel.py) except where cosf/sinf/sqrtf differ in
// the last bit from the twin's device functions. Per-ray outputs do not
// depend on the order of either list.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float BIG = 3.0e38f;
constexpr float EPS = 1e-6f;
constexpr int RESOLVE_STEPS = 9;
constexpr int COMPACT_THREADS = 256;
constexpr int TRACE_THREADS = 128;

struct Tables {
  const int* lod2;
  const int* solid;
  const int* dist3;
  const int* rankb;
  const int* occm;
  const int* occb;
  const int* mlo;
  const int* mhi;
  const int* colors;
  const int* palette;  // null in direct mode
  const int* sun;      // sun-open bits, LOD2 layout
  int res;
  int max_advances;
};
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float inv_x, inv_y, inv_z, sx, sy, sz, far;
};

struct State {
  float t;
  int word;
  int adv, active, hit, exh;
};

__device__ __forceinline__ int ld(const int* p, int i) { return __ldg(p + i); }

__device__ __forceinline__ int pack_word(int px, int py, int pz, float nx,
                                         float ny, float nz) {
  unsigned w = (unsigned)(px + 1) | ((unsigned)(py + 1) << 8) |
               ((unsigned)(pz + 1) << 16) |
               ((unsigned)((int)nx + 1) << 24) |
               ((unsigned)((int)ny + 1) << 26) |
               ((unsigned)((int)nz + 1) << 28);
  return (int)w;
}

__device__ __forceinline__ void unpack_word(int w, int& px, int& py, int& pz,
                                            float& nx, float& ny, float& nz) {
  px = (w & 255) - 1;
  py = ((w >> 8) & 255) - 1;
  pz = ((w >> 16) & 255) - 1;
  nx = (float)(((w >> 24) & 3) - 1);
  ny = (float)(((w >> 26) & 3) - 1);
  nz = (float)(((w >> 28) & 3) - 1);
}

__device__ __forceinline__ float fsign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : x);
}

__device__ __forceinline__ float clipf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ void slab(float o, float d, float inv, float s,
                                     float fres, float& lo, float& hi,
                                     bool& out) {
  float w = d == 0.0f ? 0.0f : inv;
  float sg = s < 0.0f ? -1.0f : 1.0f;
  float a = ((0.0f - o) * w) * sg;
  float b = ((fres - o) * w) * sg;
  lo = fminf(a, b);
  hi = fmaxf(a, b);
  bool deg = d == 0.0f;
  if (deg) {
    lo = -BIG;
    hi = BIG;
  }
  out = deg && ((o < 0.0f) || (o > fres));
}

// Ray/AABB clip + entry state (dda_pallas.py init_rays).
template <bool SHADOW>
__device__ void init_ray(const Tables& T, float ox, float oy, float oz,
                         float dx, float dy, float dz, float tmin, float tmax,
                         Ray& r, State& s) {
  const float fres = (float)T.res;
  r.ox = ox; r.oy = oy; r.oz = oz; r.dx = dx; r.dy = dy; r.dz = dz;
  r.inv_x = 1.0f / fmaxf(fabsf(dx), 1e-20f);
  r.inv_y = 1.0f / fmaxf(fabsf(dy), 1e-20f);
  r.inv_z = 1.0f / fmaxf(fabsf(dz), 1e-20f);
  r.sx = fsign(dx); r.sy = fsign(dy); r.sz = fsign(dz);
  float lx, hx, ly, hy, lz, hz;
  bool oxo, oyo, ozo;
  slab(ox, dx, r.inv_x, r.sx, fres, lx, hx, oxo);
  slab(oy, dy, r.inv_y, r.sy, fres, ly, hy, oyo);
  slab(oz, dz, r.inv_z, r.sz, fres, lz, hz, ozo);
  float near_ = fmaxf(fmaxf(lx, ly), lz);
  float far_box = fminf(fminf(hx, hy), hz);
  bool alive = (near_ <= far_box) && !(oxo || oyo || ozo) &&
               (tmin < far_box) && (tmax > near_);
  float t0 = fmaxf(near_, tmin);
  float te = t0 + EPS;
  float qx = ox + dx * te, qy = oy + dy * te, qz = oz + dz * te;
  float px0 = clipf(floorf(qx), 0.0f, fres - 1.0f);
  float py0 = clipf(floorf(qy), 0.0f, fres - 1.0f);
  float pz0 = clipf(floorf(qz), 0.0f, fres - 1.0f);
  r.far = fminf(tmax, far_box) - EPS;
  float idx_ = fabsf(qx - fres * 0.5f);
  float idy_ = fabsf(qy - fres * 0.5f);
  float idz_ = fabsf(qz - fres * 0.5f);
  float mx = fmaxf(fmaxf(idx_, idy_), idz_);
  float nx0 = alive ? (idx_ == mx ? 1.0f : 0.0f) : 0.0f;
  float ny0 = alive ? (idy_ == mx ? 1.0f : 0.0f) : 0.0f;
  float nz0 = alive ? (idz_ == mx ? 1.0f : 0.0f) : 0.0f;
  if (SHADOW) nx0 = ny0 = nz0 = 0.0f;
  s.word = pack_word(alive ? (int)px0 : -1, alive ? (int)py0 : -1,
                     alive ? (int)pz0 : -1, nx0, ny0, nz0);
  s.t = alive ? t0 : BIG;
  s.adv = 0;
  s.active = alive ? 1 : 0;
  s.hit = 0;
  s.exh = 0;
}

// Watertight advance to a box exit (dda_pallas.py box_exit).
__device__ __forceinline__ void box_exit(const Ray& r, float t, float lox,
                                         float loy, float loz, float extx,
                                         float exty, float extz, float& fx,
                                         float& fy, float& fz, float& txx,
                                         float& tyy, float& tzz,
                                         float& mint) {
  fx = (r.ox + r.dx * t) - lox;
  fy = (r.oy + r.dy * t) - loy;
  fz = (r.oz + r.dz * t) - loz;
  float dxx = r.dx > 0.0f ? extx - fx : fx;
  float dyy = r.dy > 0.0f ? exty - fy : fy;
  float dzz = r.dz > 0.0f ? extz - fz : fz;
  txx = r.dx == 0.0f ? BIG : dxx * r.inv_x;
  tyy = r.dy == 0.0f ? BIG : dyy * r.inv_y;
  tzz = r.dz == 0.0f ? BIG : dzz * r.inv_z;
  mint = fmaxf(fminf(fminf(txx, tyy), tzz), 0.0f);
}

// One step of the per-ray sequence: a miss test, then either a whole-cell
// resolve (occupied 4^3 cell) or an empty-space march advance.
// ``sun``: a live ray standing in a sun-open cell retires as a miss first.
template <bool SHADOW>
__device__ void step(const Tables& T, const Ray& r, State& s, bool sun) {
  const int res = T.res;
  const int r2 = res >> 2;
  const int r3 = res >> 3;
  const float fres = (float)res;
  int px, py, pz;
  float nx, ny, nz;
  unpack_word(s.word, px, py, pz, nx, ny, nz);
  bool inb = px >= 0 && px < res && py >= 0 && py < res && pz >= 0 &&
             pz < res;
  // A ray whose t reached BIG can cross no face: its direction is zero
  // (every exit BIG), so its far clip is BIG too and t > far never fires.
  // Without the second test it would spin in its cell until its advance
  // budget ran out (the JAX kernel does: 513 advances, then exhausted).
  if (s.t > r.far || s.t >= BIG || !inb) {
    s.t = BIG;
    s.active = 0;
    return;
  }
  int cell = ((pz >> 2) * r2 + (py >> 2)) * r2 + (px >> 2);
  int cw = cell >> 5;
  int cb = cell & 31;
  if (sun && ((ld(T.sun, cw) >> cb) & 1) != 0) {
    s.t = BIG;
    s.active = 0;
    return;
  }
  int w2 = ld(T.lod2, cw);
  bool occ2 = ((w2 >> cb) & 1) != 0;
  float o_t;
  int o_px, o_py, o_pz;
  float o_nx, o_ny, o_nz;
  int hit1 = 0;
  int steps1 = 0;
  int marched = 0;
  if (occ2) {
    // fetch + in-register resolve of the whole cell
    int ws = ld(T.solid, cw);
    int base = ld(T.rankb, cw);
    bool solid_here = ((ws >> cb) & 1) != 0;
    unsigned below = ((unsigned)w2 & ~(unsigned)ws) & ((1u << cb) - 1u);
    int mask_lo = -1, mask_hi = -1;
    if (!solid_here) {
      int rank = base + __popc(below);
      mask_lo = ld(T.mlo, rank);
      mask_hi = ld(T.mhi, rank);
    }
    float rt = s.t;
    int rpx = px, rpy = py, rpz = pz;
    float rnx = nx, rny = ny, rnz = nz;
    bool moving = true;
    bool rhit = false;
    int cbx = rpx & ~3, cby = rpy & ~3, cbz = rpz & ~3;
    float fx0 = (r.ox + r.dx * rt) - (float)rpx;
    float fy0 = (r.oy + r.dy * rt) - (float)rpy;
    float fz0 = (r.oz + r.dz * rt) - (float)rpz;
    float tmx = r.dx == 0.0f ? BIG
                             : rt + (r.dx > 0.0f ? 1.0f - fx0 : fx0) * r.inv_x;
    float tmy = r.dy == 0.0f ? BIG
                             : rt + (r.dy > 0.0f ? 1.0f - fy0 : fy0) * r.inv_y;
    float tmz = r.dz == 0.0f ? BIG
                             : rt + (r.dz > 0.0f ? 1.0f - fz0 : fz0) * r.inv_z;
    for (int k = 0; k <= RESOLVE_STEPS; ++k) {
      int local = ((rpz & 3) * 4 + (rpy & 3)) * 4 + (rpx & 3);
      int mword = local < 32 ? mask_lo : mask_hi;
      bool occ0 = ((mword >> (local & 31)) & 1) != 0;
      bool in_far = rt <= r.far;
      bool hit_now = moving && occ0 && in_far;
      rhit = rhit || hit_now;
      moving = moving && !hit_now && in_far;
      if (k == RESOLVE_STEPS || !moving) break;
      float mint_abs = fmaxf(fminf(fminf(tmx, tmy), tmz), rt);
      // <= and not ==: an axis whose crossing rounding put behind the ray
      // steps too (see march below)
      bool ax = tmx <= mint_abs, ay = tmy <= mint_abs, az = tmz <= mint_abs;
      float anx = (ax ? 1.0f : 0.0f) * r.sx;
      float any_ = (ay ? 1.0f : 0.0f) * r.sy;
      float anz = (az ? 1.0f : 0.0f) * r.sz;
      rt = mint_abs;
      if (ax) tmx = tmx + r.inv_x;
      if (ay) tmy = tmy + r.inv_y;
      if (az) tmz = tmz + r.inv_z;
      rpx = rpx + (int)anx;
      rpy = rpy + (int)any_;
      rpz = rpz + (int)anz;
      rnx = anx; rny = any_; rnz = anz;
      steps1 += 1;
      bool exited = ((rpx & ~3) != cbx) || ((rpy & ~3) != cby) ||
                    ((rpz & ~3) != cbz);
      moving = !exited;
    }
    o_t = rt;
    o_px = rpx; o_py = rpy; o_pz = rpz;
    o_nx = rnx; o_ny = rny; o_nz = rnz;
    hit1 = rhit ? 1 : 0;
  } else {
    // empty-space march: candidate A (dist3 cube) or B (free LOD2 X-slab)
    marched = 1;
    int c3x = px >> 3, c3y = py >> 3, c3z = pz >> 3;
    int c3 = (c3z * r3 + c3y) * r3 + c3x;
    int w3 = ld(T.dist3, c3 >> 3);
    int d3 = (w3 >> ((c3 & 7) * 4)) & 15;
    bool skip = d3 >= 1;
    int rad = d3 - 1;
    float loxA = (float)(skip ? (c3x - rad) * 8 : px & ~3);
    float loyA = (float)(skip ? (c3y - rad) * 8 : py & ~3);
    float lozA = (float)(skip ? (c3z - rad) * 8 : pz & ~3);
    float extA = (float)(skip ? (2 * rad + 1) * 8 : 4);
    float fx, fy, fz, txx, tyy, tzz, mint;
    box_exit(r, s.t, loxA, loyA, lozA, extA, extA, extA, fx, fy, fz, txx,
             tyy, tzz, mint);
    float lox = loxA, loy = loyA, loz = lozA;
    float extx = extA, exty = extA, extz = extA;
    if (w2 == 0) {
      float loyB = (float)(py & ~3);
      float lozB = (float)(pz & ~3);
      float fxB, fyB, fzB, txxB, tyyB, tzzB, mintB;
      box_exit(r, s.t, 0.0f, loyB, lozB, fres, 4.0f, 4.0f, fxB, fyB, fzB,
               txxB, tyyB, tzzB, mintB);
      if (mintB > mint) {
        lox = 0.0f; loy = loyB; loz = lozB;
        extx = fres; exty = 4.0f; extz = 4.0f;
        fx = fxB; fy = fyB; fz = fzB;
        txx = txxB; tyy = tyyB; tzz = tzzB;
        mint = mintB;
      }
    }
    float ex = clipf(floorf(fx + mint * r.dx), 0.0f, extx - 1.0f);
    float ey = clipf(floorf(fy + mint * r.dy), 0.0f, exty - 1.0f);
    float ez = clipf(floorf(fz + mint * r.dz), 0.0f, extz - 1.0f);
    // An axis steps when its exit is the nearest, or lies behind the ray
    // (mint clamped to 0): the ray's position has then rounded past that
    // face while its cell index has not, and with == no axis would step and
    // the ray would stall there until its advance budget ran out. Where
    // every exit lies ahead, <= and == agree.
    o_nx = (txx <= mint ? 1.0f : 0.0f) * r.sx;
    o_ny = (tyy <= mint ? 1.0f : 0.0f) * r.sy;
    o_nz = (tzz <= mint ? 1.0f : 0.0f) * r.sz;
    o_px = (int)((lox + ex) + o_nx);
    o_py = (int)((loy + ey) + o_ny);
    o_pz = (int)((loz + ez) + o_nz);
    o_t = s.t + mint;
  }
  if (SHADOW) o_nx = o_ny = o_nz = 0.0f;
  int o_adv = s.adv + marched + steps1;
  bool exhausted = o_adv >= T.max_advances;
  s.t = o_t;
  s.word = pack_word(o_px, o_py, o_pz, o_nx, o_ny, o_nz);
  s.adv = o_adv;
  s.hit = s.hit | hit1;
  s.exh = s.exh | ((exhausted && hit1 == 0) ? 1 : 0);
  s.active = (hit1 == 0 && !exhausted) ? 1 : 0;
}

template <bool SHADOW>
__device__ __forceinline__ void run(const Tables& T, const Ray& r, State& s,
                                    bool sun) {
  while (s.active) step<SHADOW>(T, r, s, sun);
}

__device__ __forceinline__ int part1by2(int v) {
  v = (v | (v << 8)) & 0x0300F00F;
  v = (v | (v << 4)) & 0x030C30C3;
  v = (v | (v << 2)) & 0x09249249;
  return v;
}

__device__ int hit_color(const Tables& T, int px, int py, int pz) {
  int mcell = part1by2(px >> 2) | (part1by2(py >> 2) << 1) |
              (part1by2(pz >> 2) << 2);
  int mw = mcell >> 5;
  int mb = mcell & 31;
  int wm = ld(T.occm, mw);
  int occ_rank = ld(T.occb, mw) +
                 __popc((unsigned)wm & ((1u << mb) - 1u));
  int local = ((pz & 3) * 4 + (py & 3)) * 4 + (px & 3);
  if (T.palette != nullptr) {
    int q = (local * 171) >> 9;  // local / 3
    int col = ld(T.colors, occ_rank * 22 + q);
    int slot = local - 3 * q;
    int pidx = (col >> (10 * slot)) & 1023;
    return ld(T.palette, pidx);
  }
  return ld(T.colors, occ_rank * 64 + local);
}

struct Rays {
  const float* ox;
  const float* oy;
  const float* oz;
  const float* dx;
  const float* dy;
  const float* dz;
  float tmin;
  const float* tmax;
};

// Per-ray outputs; in shadow mode only t is set, without NEE vis is null.
struct Outs {
  float* t;
  int* ix;
  int* iy;
  int* iz;
  float* nx;
  float* ny;
  float* nz;
  int* iters;
  int* color;
  int* active;
  int* vis;
};

// In-kernel NEE inputs, and the second list the converted shadow rays go
// to: rays holds 6 rows of n floats (origin, direction), idx their
// original indices.
struct Nee {
  const float* u0;
  const float* u1;
  const float* alt;
  const float* scal;  // L, X, Y, cone_cos, eps_grid, shadow_tmin
  float* rays;
  int* idx;
  long long n;
};

// counts[0]: alive rays, counts[1]: NEE shadow rays listed for the second
// pass, counts[2]: NEE shadow rays settled at conversion.

// Pass 1: the alive list, and the canonical miss for every dead lane.
template <bool SHADOW>
__global__ void __launch_bounds__(COMPACT_THREADS) compact_kernel(
    const bool* __restrict__ alive, long long n, int* __restrict__ list,
    int* __restrict__ counts, Outs o) {
  __shared__ int warp_base[COMPACT_THREADS / 32];
  __shared__ int block_base;
  const long long i = blockIdx.x * (long long)COMPACT_THREADS + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool in = i < n;
  const bool a = in && (alive == nullptr || alive[i]);
  const unsigned b = __ballot_sync(0xffffffffu, a);
  if (lane == 0) warp_base[warp] = __popc(b);
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < COMPACT_THREADS / 32; ++w) {
      int c = warp_base[w];
      warp_base[w] = total;
      total += c;
    }
    block_base = total > 0 ? atomicAdd(counts, total) : 0;
  }
  __syncthreads();
  if (a) {
    list[block_base + warp_base[warp] + __popc(b & ((1u << lane) - 1u))] =
        (int)i;
  } else if (in) {
    // canonical miss (dda_pallas.py:1148-1156)
    o.t[i] = INFINITY;
    if (SHADOW) return;
    o.ix[i] = -1; o.iy[i] = -1; o.iz[i] = -1;
    o.nx[i] = 0.0f; o.ny[i] = 0.0f; o.nz[i] = 0.0f;
    o.iters[i] = 0; o.color[i] = 0; o.active[i] = 0;
    if (o.vis != nullptr) o.vis[i] = 0;
  }
}

// Pass 2, shadow mode: the distance of each alive ray's any-hit march.
__global__ void __launch_bounds__(TRACE_THREADS) anyhit_kernel(
    Tables T, Rays R, const int* __restrict__ list,
    const int* __restrict__ counts, float* __restrict__ out_t, int sun) {
  const int j = blockIdx.x * TRACE_THREADS + threadIdx.x;
  if (j >= counts[0]) return;
  const int i = list[j];
  Ray r;
  State s;
  init_ray<true>(T, R.ox[i], R.oy[i], R.oz[i], R.dx[i], R.dy[i], R.dz[i],
                 R.tmin, R.tmax[i], r, s);
  run<true>(T, r, s, sun != 0);
  out_t[i] = s.t >= BIG ? INFINITY : s.t;
}

// Pass 2, closest hit: the alive rays' hits, and with NEE each converted
// primary's shadow ray listed for pass 3 (or settled at conversion).
template <bool NEE>
__global__ void __launch_bounds__(TRACE_THREADS) closest_kernel(
    Tables T, Rays R, const int* __restrict__ list,
    int* __restrict__ counts, Outs o, Nee N, int sun, int src_open) {
  const int j0 = blockIdx.x * TRACE_THREADS;
  const int cnt = counts[0];
  if (j0 >= cnt) return;  // the whole block: no lane reaches the ballots
  const int j = j0 + threadIdx.x;
  // NEE: 0 no shadow ray, 1 listed for pass 3, 2 settled visible here
  int kind = 0;
  int i = 0;
  float spx = 0.0f, spy = 0.0f, spz = 0.0f;
  float ldx = 0.0f, ldy = 0.0f, ldz = 0.0f;
  if (j < cnt) {
    i = list[j];
    Ray r;
    State s;
    init_ray<false>(T, R.ox[i], R.oy[i], R.oz[i], R.dx[i], R.dy[i], R.dz[i],
                    R.tmin, R.tmax[i], r, s);
    run<false>(T, r, s, sun != 0);
    int px, py, pz;
    float hnx, hny, hnz;
    unpack_word(s.word, px, py, pz, hnx, hny, hnz);
    // normal flipped toward the ray (raytracer.py:151-153)
    bool flip = ((r.dx * hnx + r.dy * hny) + r.dz * hnz) > 0.0f;
    o.t[i] = s.t >= BIG ? INFINITY : s.t;
    o.ix[i] = px; o.iy[i] = py; o.iz[i] = pz;
    o.nx[i] = flip ? -hnx : hnx;
    o.ny[i] = flip ? -hny : hny;
    o.nz[i] = flip ? -hnz : hnz;
    o.iters[i] = s.adv;
    o.active[i] = s.active | s.exh;
    o.color[i] = s.hit ? hit_color(T, px, py, pz) : 0;
    if (NEE) {
      // The retired primary becomes its sun-cone shadow ray, from the voxel
      // hit or the closer floor crossing (dda_pallas.py nee_conv_data).
      const float* nee = N.scal;
      float a = N.alt[i];
      bool have_vox = s.hit != 0 && s.t < BIG;
      bool use_alt = isfinite(a) && (a < (have_vox ? s.t : BIG));
      bool surf = have_vox || use_alt;
      float hnx_ = flip ? -hnx : hnx, hny_ = flip ? -hny : hny;
      float hnz_ = flip ? -hnz : hnz;
      float fny = r.dy > 0.0f ? -1.0f : 1.0f;
      float snx = use_alt ? 0.0f : hnx_;
      float sny = use_alt ? fny : hny_;
      float snz = use_alt ? 0.0f : hnz_;
      float st = use_alt ? a : s.t;
      float epsg = nee[10];
      spx = (r.ox + r.dx * st) + snx * epsg;
      spy = (r.oy + r.dy * st) + sny * epsg;
      spz = (r.oz + r.dz * st) + snz * epsg;
      float uu1 = N.u0[i], uu2 = N.u1[i];
      float cos_t = (1.0f - uu1) + uu1 * nee[9];
      float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
      float phi = 6.2831854820251465f * uu2;  // float32(2 * pi)
      float cphi = cosf(phi) * sin_t;
      float sphi = sinf(phi) * sin_t;
      ldx = (cphi * nee[3] + sphi * nee[6]) + cos_t * nee[0];
      ldy = (cphi * nee[4] + sphi * nee[7]) + cos_t * nee[1];
      ldz = (cphi * nee[5] + sphi * nee[8]) + cos_t * nee[2];
      float ndl = (ldx * snx + ldy * sny) + ldz * snz;
      if (surf && ndl > -1e-3f) {
        kind = 1;
        if (src_open) {
          // dda_pallas.py nee_instant: the clip misses the grid, or the
          // entry cell is sun-open
          Ray rs;
          State ss;
          init_ray<true>(T, spx, spy, spz, ldx, ldy, ldz, nee[11], BIG, rs,
                         ss);
          int qx, qy, qz;
          float qnx, qny, qnz;
          unpack_word(ss.word, qx, qy, qz, qnx, qny, qnz);
          const int r2 = T.res >> 2;
          int cell = ((qz >> 2) * r2 + (qy >> 2)) * r2 + (qx >> 2);
          if (!ss.active || ((ld(T.sun, cell >> 5) >> (cell & 31)) & 1) != 0)
            kind = 2;
        }
      }
      o.vis[i] = kind == 2 ? 1 : 0;
    }
  }
  if (NEE) {
    // warp-aggregated appends to the second list
    const int lane = threadIdx.x & 31;
    const unsigned listed = __ballot_sync(0xffffffffu, kind == 1);
    const unsigned settled = __ballot_sync(0xffffffffu, kind == 2);
    if (lane == 0 && settled != 0u) atomicAdd(counts + 2, __popc(settled));
    if (listed != 0u) {
      const int leader = __ffs(listed) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(counts + 1, __popc(listed));
      base = __shfl_sync(0xffffffffu, base, leader);
      if (kind == 1) {
        const long long k = base + __popc(listed & ((1u << lane) - 1u));
        N.rays[k] = spx;
        N.rays[N.n + k] = spy;
        N.rays[2 * N.n + k] = spz;
        N.rays[3 * N.n + k] = ldx;
        N.rays[4 * N.n + k] = ldy;
        N.rays[5 * N.n + k] = ldz;
        N.idx[k] = i;
      }
    }
  }
}

// Pass 3: the listed NEE shadow rays, densely; visible = escaped (no hit,
// advance budget not exhausted).
__global__ void __launch_bounds__(TRACE_THREADS) nee_shadow_kernel(
    Tables T, Nee N, const int* __restrict__ counts, int* __restrict__ vis,
    int sun) {
  const int k = blockIdx.x * TRACE_THREADS + threadIdx.x;
  if (k >= counts[1]) return;
  const float* p = N.rays;
  Ray r;
  State s;
  init_ray<true>(T, p[k], p[N.n + k], p[2 * N.n + k], p[3 * N.n + k],
                 p[4 * N.n + k], p[5 * N.n + k], N.scal[11], BIG, r, s);
  run<true>(T, r, s, sun != 0);
  vis[N.idx[k]] = (s.hit == 0 && s.exh == 0) ? 1 : 0;
}

}  // namespace

// One B1 dispatch: the passes above, on ``stream``, with nothing read back
// to the host. ``counts`` (3 ints) must be zero on entry; ``list`` holds n
// ints; with NEE ``nee_rays`` 6n floats and ``nee_idx`` n ints.
extern "C" int traverse(
    const void* lod2, const void* solid, const void* dist3, const void* rankb,
    const void* occm, const void* occb, const void* mlo, const void* mhi,
    const void* colors, const void* palette, const void* sun_open, int res,
    int max_advances, const void* ox, const void* oy, const void* oz,
    const void* dx, const void* dy, const void* dz, float tmin,
    const void* tmax, const void* alive,
    const void* u0, const void* u1, const void* alt, const void* nee,
    void* out_t, void* out_ix, void* out_iy, void* out_iz, void* out_nx,
    void* out_ny, void* out_nz, void* out_iters, void* out_color,
    void* out_active, void* out_vis, void* list, void* counts,
    void* nee_rays, void* nee_idx, int shadow, int use_sun_open,
    int nee_sun, int nee_src_open, long long n, void* stream) {
  if (n <= 0) return 0;
  if (n > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  Tables T;
  T.lod2 = (const int*)lod2; T.solid = (const int*)solid;
  T.dist3 = (const int*)dist3; T.rankb = (const int*)rankb;
  T.occm = (const int*)occm; T.occb = (const int*)occb;
  T.mlo = (const int*)mlo; T.mhi = (const int*)mhi;
  T.colors = (const int*)colors; T.palette = (const int*)palette;
  T.sun = (const int*)sun_open;
  T.res = res; T.max_advances = max_advances;
  Rays R;
  R.ox = (const float*)ox; R.oy = (const float*)oy; R.oz = (const float*)oz;
  R.dx = (const float*)dx; R.dy = (const float*)dy; R.dz = (const float*)dz;
  R.tmin = tmin; R.tmax = (const float*)tmax;
  Outs o;
  o.t = (float*)out_t; o.ix = (int*)out_ix; o.iy = (int*)out_iy;
  o.iz = (int*)out_iz; o.nx = (float*)out_nx; o.ny = (float*)out_ny;
  o.nz = (float*)out_nz; o.iters = (int*)out_iters;
  o.color = (int*)out_color; o.active = (int*)out_active;
  o.vis = (int*)out_vis;
  Nee N;
  N.u0 = (const float*)u0; N.u1 = (const float*)u1;
  N.alt = (const float*)alt; N.scal = (const float*)nee;
  N.rays = (float*)nee_rays; N.idx = (int*)nee_idx; N.n = n;
  int* cnt = (int*)counts;
  int* lst = (int*)list;
  cudaStream_t st = (cudaStream_t)stream;
  const bool* al = (const bool*)alive;
  const unsigned cblocks =
      (unsigned)((n + COMPACT_THREADS - 1) / COMPACT_THREADS);
  const unsigned tblocks = (unsigned)((n + TRACE_THREADS - 1) / TRACE_THREADS);
  cudaError_t err;
  if (shadow) {
    compact_kernel<true><<<cblocks, COMPACT_THREADS, 0, st>>>(al, n, lst, cnt,
                                                              o);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    anyhit_kernel<<<tblocks, TRACE_THREADS, 0, st>>>(T, R, lst, cnt, o.t,
                                                     use_sun_open);
    return (int)cudaGetLastError();
  }
  compact_kernel<false><<<cblocks, COMPACT_THREADS, 0, st>>>(al, n, lst, cnt,
                                                             o);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (nee == nullptr) {
    closest_kernel<false><<<tblocks, TRACE_THREADS, 0, st>>>(
        T, R, lst, cnt, o, N, use_sun_open, 0);
    return (int)cudaGetLastError();
  }
  closest_kernel<true><<<tblocks, TRACE_THREADS, 0, st>>>(
      T, R, lst, cnt, o, N, use_sun_open, nee_src_open);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  nee_shadow_kernel<<<tblocks, TRACE_THREADS, 0, st>>>(T, N, cnt, o.vis,
                                                       nee_sun);
  return (int)cudaGetLastError();
}
