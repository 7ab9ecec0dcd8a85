// Helpers shared by the bundle-adjustment kernels.
#pragma once

#include <cuda_runtime.h>

namespace ctt {

// Sum over aligned groups of G lanes (G a power of two <= 32). Every lane of
// the warp must call it.
__device__ __forceinline__ float group_sum(float x, int G) {
  for (int off = G >> 1; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// IRLS weight rho'(s) and cost rho(s) of a squared residual norm.
// loss: 0 trivial, 1 huber, 2 cauchy (ba_residual.py robust_weight / robust_cost).
__device__ __forceinline__ float robust_weight(float sq, int loss, float scale) {
  if (loss == 0) return 1.f;
  const float s = sq / (scale * scale);
  if (loss == 1) return s <= 1.f ? 1.f : 1.f / sqrtf(fmaxf(s, 1e-30f));
  return 1.f / (1.f + s);
}

__device__ __forceinline__ float robust_cost(float sq, int loss, float scale) {
  if (loss == 0) return sq;
  const float a2 = scale * scale;
  const float s = sq / a2;
  if (loss == 1) return s <= 1.f ? sq : a2 * (2.f * sqrtf(fmaxf(s, 0.f)) - 1.f);
  return a2 * log1pf(s);
}

// Smallest power of two >= n, clamped to [1, 32]: the lanes a point gets.
inline int group_size(int n) {
  int g = 1;
  while (g < n && g < 32) g <<= 1;
  return g;
}

// Closed-form inverse of the symmetric 3x3 block [[a,b,c],[b,d,e],[c,e,f]]
// by adjugate / determinant; a zero block when |det| <= 1e-12 (as
// colmap_tpu's _inv3x3_spd).
__device__ __forceinline__ void inv3x3_sym(float a, float b, float c, float d, float e,
                                           float f, float* inv) {
  const float co00 = d * f - e * e;
  const float co01 = c * e - b * f;
  const float co02 = b * e - c * d;
  const float co11 = a * f - c * c;
  const float co12 = b * c - a * e;
  const float co22 = a * d - b * b;
  const float det = a * co00 + b * co01 + c * co02;
  const float s = fabsf(det) > 1e-12f ? 1.f / det : 0.f;
  inv[0] = co00 * s; inv[1] = co01 * s; inv[2] = co02 * s;
  inv[3] = co01 * s; inv[4] = co11 * s; inv[5] = co12 * s;
  inv[6] = co02 * s; inv[7] = co12 * s; inv[8] = co22 * s;
}

// Shared memory a block may take for the frame/camera tables before the
// kernels fall back to global atomics.
constexpr int kMaxTableBytes = 96 * 1024;

}  // namespace ctt
