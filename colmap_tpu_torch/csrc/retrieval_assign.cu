// K28 retrieval_assign: the nearest centroid of each descriptor row within
// its group.
//
// Replaces colmap_tpu/retrieval/visual_index.py `_assign_words` (l.56), the
// assignment halves of `_kmeans_step` (l.39) and `_tree_kmeans_level_step`
// (l.93), and `build_vocabulary_tree`'s host re-assignment (l.241-253).
// There each is a distance GEMM on the MXU plus an argmin; the tree level
// pads every node's samples into (M, S, D) blocks.
//
// Function: out[i] = argmin_j Σ_d (x[i, d] - c[g(i) G + j, d])², j < G, the
// lowest j on exact ties; g(i) = group[i], or 0 when no groups are given.
// Two forms:
//   flat (one group of G = W words, the k-means vocabulary): one row a
//     thread, held in registers; the block walks the centroids in tiles of
//     kTile rows in shared memory, which every thread reads as broadcasts;
//   grouped (G = B children of the row's tree node): one row a thread,
//     the node's B centroids read from global memory (L1/L2). The builder
//     hands the level's samples in node order, so a warp's rows mostly
//     share a node and its loads.
// Bound on the card: operations. Flat at the builder's shapes (2M rows x
// 1024 words x 128) is 3 f32 operations per (row, word, dim), 7.9e11 in
// all (11.7 ms at 67 TFLOP/s), against 1 GB of rows (0.3 ms). The design
// keeps each row in registers and each centroid element a shared-memory
// broadcast, so the loop is sub + FMA with one LDS.128 per 8 of them.
#include <cuda_runtime.h>
#include <math.h>

#include "retrieval_common.cuh"

namespace ctt {
namespace ret {

constexpr int kAssignBlock = 128;
constexpr int kTile = 32;

__device__ __forceinline__ void load_row(const float4* __restrict__ x, long long row, int D4,
                                         bool valid, float4 (&xr)[kMaxVec]) {
#pragma unroll
  for (int k = 0; k < kMaxVec; ++k) {
    xr[k] = (valid && k < D4) ? __ldg(x + row * D4 + k) : zero4();
  }
}

__global__ void __launch_bounds__(kAssignBlock)
assign_flat_kernel(int N, int D4, int G, const float4* __restrict__ x,
                   const float4* __restrict__ cents, int* __restrict__ out) {
  __shared__ float4 tile[kTile][kMaxVec];
  const long long row = (long long)blockIdx.x * kAssignBlock + threadIdx.x;
  const bool valid = row < N;
  float4 xr[kMaxVec];
  load_row(x, row, D4, valid, xr);
  float best = INFINITY;
  int best_j = 0;
  for (int t0 = 0; t0 < G; t0 += kTile) {
    const int nt = min(kTile, G - t0);
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * kMaxVec; e += kAssignBlock) {
      const int j = e / kMaxVec, k = e % kMaxVec;
      tile[j][k] = (j < nt && k < D4) ? __ldg(cents + (long long)(t0 + j) * D4 + k) : zero4();
    }
    __syncthreads();
    for (int j = 0; j < nt; ++j) {
      float4 acc = zero4();
#pragma unroll
      for (int k = 0; k < kMaxVec; ++k) acc_sq(xr[k], tile[j][k], acc);
      const float d = total(acc);
      if (d < best) {
        best = d;
        best_j = t0 + j;
      }
    }
  }
  if (valid) out[row] = best_j;
}

__global__ void __launch_bounds__(kAssignBlock)
assign_grouped_kernel(int N, int D4, int G, const float4* __restrict__ x,
                      const float4* __restrict__ cents, const int* __restrict__ group,
                      int* __restrict__ out) {
  const long long row = (long long)blockIdx.x * kAssignBlock + threadIdx.x;
  if (row >= N) return;
  float4 xr[kMaxVec];
  load_row(x, row, D4, true, xr);
  const float4* c = cents + (long long)__ldg(group + row) * G * D4;
  float best = INFINITY;
  int best_j = 0;
  for (int j = 0; j < G; ++j) {
    float4 acc = zero4();
#pragma unroll
    for (int k = 0; k < kMaxVec; ++k) {
      if (k < D4) acc_sq(xr[k], __ldg(c + (long long)j * D4 + k), acc);
    }
    const float d = total(acc);
    if (d < best) {
      best = d;
      best_j = j;
    }
  }
  out[row] = best_j;
}

}  // namespace ret
}  // namespace ctt

// x (N, D), cents (num_groups * G, D) float32 row-major, D = 4 * D4 <= 128;
// group (N,) int32 in [0, num_groups) or null for one group; out (N,) int32.
extern "C" int retrieval_assign_f32(int N, int D, int G, const float* x, const float* cents,
                                    const int* group, int* out, void* stream) {
  using namespace ctt::ret;
  cudaStream_t s = (cudaStream_t)stream;
  const int D4 = D / 4;
  if (N > 0 && G > 0) {
    const int blocks = blocks_for(N, kAssignBlock);
    if (group == nullptr) {
      assign_flat_kernel<<<blocks, kAssignBlock, 0, s>>>(
          N, D4, G, reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(cents),
          out);
    } else {
      assign_grouped_kernel<<<blocks, kAssignBlock, 0, s>>>(
          N, D4, G, reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(cents),
          group, out);
    }
  }
  return (int)cudaGetLastError();
}
