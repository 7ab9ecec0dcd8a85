// K31 retrieval_gram: S = W Wᵀ, the all-pairs bag-of-words similarity.
//
// Replaces colmap_tpu/retrieval/visual_index.py `rank_images_bow`'s jitted
// `w @ w.T` (l.487), a dense GEMM on the MXU.
//
// Function: S[i, j] = Σ_k W[i, k] W[j, k] for W (n, K) float32 row-major,
// the n images' idf-weighted, L2-normalized word histograms.
// Layout: one block of 64 threads a 32 x 32 tile of S, over the tiles on and
// above the diagonal only; a block writes its tile and the mirror tile. K is
// walked in steps of 32 through shared memory, both operands stored k-major;
// each thread holds a 4 x 4 patch and adds one FMA a k in k order. S[i, j]
// and S[j, i] are then the same float32 sum in the same order (an FMA's
// product commutes), so S is exactly symmetric, and every entry is one
// fixed-order sum: two runs give the same bits.
// Bound on the card: the histograms are sparse (at most one word a
// descriptor, about 2000 of 32 768 a row), so the products the result needs
// are few and reading W once bounds it; this dense kernel reads W's tiles
// once a tile pair and multiplies the zeros too.
#include <cuda_runtime.h>

#include "retrieval_common.cuh"

namespace ctt {
namespace ret {

constexpr int kGramTile = 32;
constexpr int kGramStep = 32;
constexpr int kGramThreads = 64;
constexpr int kGramPad = kGramTile + 4;  // rows stay 16-byte aligned for float4 reads

__global__ void __launch_bounds__(kGramThreads)
gram_kernel(int n, int K, int tiles, const float* __restrict__ w, float* __restrict__ s) {
  __shared__ __align__(16) float a[kGramStep][kGramPad];
  __shared__ __align__(16) float b[kGramStep][kGramPad];
  // Tile pair (ti, tj), ti <= tj, of this block: blocks run row by row over
  // the upper triangle of the tiles.
  int t = blockIdx.x, ti = 0;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  const int tj = ti + t;
  const int i0 = ti * kGramTile, j0 = tj * kGramTile;
  const int tx = threadIdx.x & 7, ty = threadIdx.x >> 3;
  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kGramStep) {
    __syncthreads();
    for (int e = threadIdx.x; e < kGramTile * kGramStep; e += kGramThreads) {
      const int r = e / kGramStep, kk = e % kGramStep, k = k0 + kk;
      a[kk][r] = (k < K && i0 + r < n) ? __ldg(w + (long long)(i0 + r) * K + k) : 0.f;
      b[kk][r] = (k < K && j0 + r < n) ? __ldg(w + (long long)(j0 + r) * K + k) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kGramStep; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&a[kk][4 * ty]);
      const float4 bv = *reinterpret_cast<const float4*>(&b[kk][4 * tx]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(ar[r], br[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + 4 * tx + c;
      if (i < n && j < n) {
        s[(long long)i * n + j] = acc[r][c];
        if (ti != tj) s[(long long)j * n + i] = acc[r][c];
      }
    }
  }
}

}  // namespace ret
}  // namespace ctt

// w (n, K) float32 row-major; s (n, n) float32.
extern "C" int retrieval_gram_f32(int n, int K, const float* w, float* s, void* stream) {
  using namespace ctt::ret;
  if (n > 0) {
    const int tiles = blocks_for(n, kGramTile);
    gram_kernel<<<tiles * (tiles + 1) / 2, kGramThreads, 0, (cudaStream_t)stream>>>(
        n, K, tiles, w, s);
  }
  return (int)cudaGetLastError();
}
