// K29 retrieval_update: the k-means update, the mean of each segment's rows.
//
// Replaces the update halves of colmap_tpu/retrieval/visual_index.py
// `_kmeans_step` (l.39: segment_sum of rows and ones by word) and
// `_tree_kmeans_level_step` (l.93: a one-hot einsum over padded (M, S, D)
// blocks, masked).
//
// Function: for each segment s (a word, or node x child of a tree level)
// count[s] = |rows of s|, new[s] = Σ rows / count[s], or old[s] when the
// count is 0 (l.49-51, l.109-113).
// Layout: the rows of segment s are x[order[offsets[s]:offsets[s + 1]]],
// order from a stable sort of the assignment (the wrapper's torch.sort). One
// block of four warps a segment; lane l holds dims 4l..4l+3; warp w sums the
// segment's rows w, w + 4, ... in order, in float64, and the four partials
// are added in a fixed order. No atomics: two runs give the same bits, and
// the float64 sums leave the result within half a float32 ulp of the mean.
// Bound on the card: bytes, each row read once (2M x 512 B = 1 GB, 0.3 ms).
#include <cuda_runtime.h>

#include "retrieval_common.cuh"

namespace ctt {
namespace ret {

constexpr int kUpdateWarps = 4;

__global__ void __launch_bounds__(kUpdateWarps * 32)
update_kernel(int D4, const float4* __restrict__ x, const int* __restrict__ order,
              const int* __restrict__ offsets, const float* __restrict__ old,
              float* __restrict__ out, int* __restrict__ counts) {
  __shared__ double part[kUpdateWarps][kMaxDim];
  const int s = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int start = __ldg(offsets + s), end = __ldg(offsets + s + 1);
  double a0 = 0.0, a1 = 0.0, a2 = 0.0, a3 = 0.0;
  if (lane < D4) {
#pragma unroll 4
    for (int k = start + warp; k < end; k += kUpdateWarps) {
      const float4 v = __ldg(x + (long long)__ldg(order + k) * D4 + lane);
      a0 += v.x;
      a1 += v.y;
      a2 += v.z;
      a3 += v.w;
    }
  }
  part[warp][4 * lane] = a0;
  part[warp][4 * lane + 1] = a1;
  part[warp][4 * lane + 2] = a2;
  part[warp][4 * lane + 3] = a3;
  __syncthreads();
  const int d = threadIdx.x, D = 4 * D4, n = end - start;
  if (d < D) {
    const long long o = (long long)s * D + d;
    if (n > 0) {
      double sum = part[0][d];
#pragma unroll
      for (int w = 1; w < kUpdateWarps; ++w) sum += part[w][d];
      out[o] = (float)(sum / (double)n);
    } else {
      out[o] = old[o];
    }
  }
  if (threadIdx.x == 0) counts[s] = n;
}

}  // namespace ret
}  // namespace ctt

// x (N, D) float32, D = 4 * D4 <= 128; order (N,) int32; offsets (S + 1,)
// int32; old and out (S, D) float32; counts (S,) int32.
extern "C" int retrieval_update_f32(int S, int D, const float* x, const int* order,
                                    const int* offsets, const float* old, float* out,
                                    int* counts, void* stream) {
  using namespace ctt::ret;
  if (S > 0) {
    update_kernel<<<S, kUpdateWarps * 32, 0, (cudaStream_t)stream>>>(
        D / 4, reinterpret_cast<const float4*>(x), order, offsets, old, out, counts);
  }
  return (int)cudaGetLastError();
}
