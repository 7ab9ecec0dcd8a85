// Reductions, packing and the closed-form cubic shared by the mapper and
// verification kernels (K6-K9, K11, K12).
#pragma once

#include <cuda_runtime.h>

namespace ctt {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kPiF = 3.14159265358979f;

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

__device__ __forceinline__ int warp_sum_int(int x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
  return x;
}

// Sum of n values per thread over the whole block (blockDim.x a multiple of
// 32, at most 1024). scratch holds 32 * n floats. Every thread of the block
// must call it; every thread gets the sums in vals.
template <int NV>
__device__ void block_sum(float* vals, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const float s = warp_sum(vals[k]);
    if (lane == 0) scratch[warp * NV + k] = s;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    float s = 0.f;
    for (int w = 0; w < nwarps; ++w) s += scratch[w * NV + k];
    vals[k] = s;
  }
  __syncthreads();
}

// The packed best of a RANSAC batch (optim/ransac.py pack_best): support in
// the high 32 bits and 0xFFFFFFFF - index in the low 32 bits, so that one
// atomicMax keeps the first model of largest support.
__device__ __forceinline__ unsigned long long pack_best(int count, int index) {
  return ((unsigned long long)(unsigned)count << 32) | (unsigned long long)(0xFFFFFFFFu - (unsigned)index);
}

__device__ __forceinline__ bool all_finite(const float* x, int n) {
  bool ok = true;
  for (int i = 0; i < n; ++i) ok = ok && isfinite(x[i]);
  return ok;
}

// Real roots of x^3 + b x^2 + c x + d (polynomial.py solve_cubic, a = 1).
__device__ inline void solve_cubic_monic(float b_, float c_, float d_, float* r, bool* m) {
  const float p = c_ - b_ * b_ / 3.f;
  const float q = 2.f * b_ * b_ * b_ / 27.f - b_ * c_ / 3.f + d_;
  const float shift = -b_ / 3.f;
  const float disc = (q / 2.f) * (q / 2.f) + (p / 3.f) * (p / 3.f) * (p / 3.f);
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float single = cbrtf(-q / 2.f + sq) + cbrtf(-q / 2.f - sq) + shift;
  const float p_neg = fminf(p, -1e-30f);
  const float mm = 2.f * sqrtf(-p_neg / 3.f);
  const float theta = acosf(fminf(fmaxf(3.f * q / (p_neg * mm), -1.f), 1.f)) / 3.f;
  const bool three = disc <= 0.f;
  for (int k = 0; k < 3; ++k) {
    const float rk = mm * cosf(theta - 2.f * kPiF * k / 3.f) + shift;
    r[k] = three ? rk : single;
    m[k] = k == 0 ? true : three;
  }
}

}  // namespace ctt
