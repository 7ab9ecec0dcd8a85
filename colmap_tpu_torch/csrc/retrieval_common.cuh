// Shared by the retrieval kernels K28-K31.
//
// Descriptors and centroids are float32 rows of D <= 128 values, D a multiple
// of 4 (SIFT's 128), read as float4. Every distance is the squared L2 distance
// Σ (x - c)² taken directly, never as |x|² - 2 x·c + |c|²: on uint8-valued
// SIFT rows |x|² reaches 8.3e6, where that expansion leaves float32 an
// absolute error of order 1 and turns near-ties into wrong answers.
#pragma once

#include <cuda_runtime.h>

namespace ctt {
namespace ret {

constexpr int kMaxDim = 128;
constexpr int kMaxVec = kMaxDim / 4;

__device__ __forceinline__ float4 zero4() { return make_float4(0.f, 0.f, 0.f, 0.f); }

// Adds the four squared differences of one float4 to four partial sums.
__device__ __forceinline__ void acc_sq(float4 x, float4 c, float4& acc) {
  const float dx = x.x - c.x, dy = x.y - c.y, dz = x.z - c.z, dw = x.w - c.w;
  acc.x = fmaf(dx, dx, acc.x);
  acc.y = fmaf(dy, dy, acc.y);
  acc.z = fmaf(dz, dz, acc.z);
  acc.w = fmaf(dw, dw, acc.w);
}

__device__ __forceinline__ float total(float4 acc) { return (acc.x + acc.y) + (acc.z + acc.w); }

inline int blocks_for(long long n, int per_block) { return (int)((n + per_block - 1) / per_block); }

}  // namespace ret
}  // namespace ctt
