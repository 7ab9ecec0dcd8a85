// Reductions shared by the global-SfM kernels K21-K23.
//
// Every sum over a node's, a point's or a camera's list is a gather over a
// CSR list in a fixed order: a warp or a block walks the list with a
// stride, then reduces by shuffles (and, for a block, through shared
// memory) in a fixed tree. No float atomics: a result does not depend on
// scheduling, and two runs on the same inputs agree to the bit.
#pragma once

#include <cuda_runtime.h>

namespace ctt {
namespace gsfm {

constexpr int kBlock = 256;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sums N values per thread over the block (kBlock threads); the result is
// valid in every thread. `scratch` holds N * kBlock / 32 values.
template <int N, typename T>
__device__ __forceinline__ void block_sum(T* v, T* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  constexpr int W = kBlock / 32;
#pragma unroll
  for (int k = 0; k < N; ++k) v[k] = warp_sum(v[k]);
  __syncthreads();
  if (lane == 0)
#pragma unroll
    for (int k = 0; k < N; ++k) scratch[k * W + warp] = v[k];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < N; ++k) {
    T s = 0;
    for (int w = 0; w < W; ++w) s += scratch[k * W + w];
    v[k] = s;
  }
}

}  // namespace gsfm
}  // namespace ctt
