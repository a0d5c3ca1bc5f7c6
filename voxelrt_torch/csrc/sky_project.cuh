// Direction -> skybox texel coordinates, computed as the port's eager
// PyTorch glue computes them on the card, operation for operation:
// voxelrt_torch/ops/texfetch.py texel_coords (the jitter vnormalize(d +
// u3 * 0.0015) of ops/v3.py, project_sky_soa, then `* res - 0.5`).
//
// What keeps it bit-equal to PyTorch's CUDA kernels:
//  - the CUDA math functions PyTorch's float32 kernels call: rsqrtf,
//    atan2f, acosf, sqrtf (no fast-math flags);
//  - every Python constant rounded as PyTorch rounds a scalar operand: the
//    Python double, then float32; a division by a Python scalar is a
//    multiply by the float32 reciprocal, computed in float, as PyTorch's
//    CUDA true-division kernel takes a CPU-scalar divisor;
//  - each multiply and add rounded on its own: the file is built with
//    -fmad=false (ops/_cuda.py), as the eager kernels run them;
//  - torch.clamp's NaN propagation and torch.sign's (0 < v) - (v < 0), so
//    NaN, infinite and zero components take the same way through.
#pragma once

#include <math.h>

namespace skyproj {

constexpr double kPiD = 3.141592653589793;  // sampling.PI
constexpr float kPi = static_cast<float>(kPiD);
constexpr float kHalfPi = static_cast<float>(kPiD * 0.5);
constexpr float kInvTwoPi = 1.0f / static_cast<float>(2.0 * kPiD);
constexpr float kTwoOverPi = static_cast<float>(2.0 / kPiD);
constexpr float kEps = static_cast<float>(1e-20);
constexpr float kJitter = static_cast<float>(0.0015);

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float sign(float v) {
  return static_cast<float>((0.0f < v) - (v < 0.0f));
}

// vnormalize(d + u3 * 0.0015): the bilinear escape fetch's jitter.
__device__ __forceinline__ void jitter(float& x, float& y, float& z, float ux,
                                       float uy, float uz) {
  x = x + ux * kJitter;
  y = y + uy * kJitter;
  z = z + uz * kJitter;
  float inv = rsqrtf(clamp_min(x * x + y * y + z * z, kEps));
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// Texel-space coordinates of the skybox map for direction (x, y, z):
// project_sky_soa's (u, v), then u * res - 0.5. ``scale`` and ``offset`` are
// float32(1 - 1/res) and float32(0.5 * (1/res)).
__device__ __forceinline__ void texel_coords(float x, float y, float z,
                                             float res_f, float scale,
                                             float offset, float& fx,
                                             float& fy) {
  float inv = rsqrtf(clamp_min(x * x + z * z, kEps));
  float azimuth = atan2f(x * inv, -(z * inv)) + kPi;
  float elevation = kHalfPi - acosf(clamp(y, -1.0f, 1.0f));
  float cx = azimuth * kInvTwoPi;
  float cy = 0.5f + 0.5f * sign(elevation) *
                        sqrtf(kTwoOverPi * fabsf(elevation));
  fx = (cx * scale + offset) * res_f - 0.5f;
  fy = (cy * scale + offset) * res_f - 0.5f;
}

}  // namespace skyproj
