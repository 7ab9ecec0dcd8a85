// K47 sprt: Wald's sequential probability ratio test over RANSAC hypotheses.
//
// Replaces colmap_tpu/optim/sprt.py sprt_evaluate (l.53), an eager jnp
// program: each hypothesis' log likelihood ratio is the running sum over
// its rows of log_in = log(delta / epsilon) on an inlier (r <= max_sq),
// log_out = log((1 - delta) / (1 - epsilon)) on an outlier and 0 on an
// invalid row; it is rejected at the first row where the sum exceeds log A.
// colmap_tpu forms the whole (M, N) cumulative sum. Here the ratio after row
// i is evaluated as L(i) = n_in(i) log_in + n_out(i) log_out from the exact
// integer counts of inliers and outliers so far (one float64 evaluation a
// row, no float64 running sum; it differs from the sum by about N ulps of
// |L|), and every row is tested, whatever the signs of log_in and log_out.
//
// One block of 256 threads a hypothesis walks its rows in tiles of 2048:
// a thread takes 8 consecutive rows, read as two float4 of residuals (from
// the 16-byte aligned address at or before the row's start; elements
// outside the row take no part) and the 8 mask bytes (one 8-byte load where
// aligned), all issued before any arithmetic, and the next tile's loads go
// out before this tile's scan. The counts are packed into one 64-bit value
// (n_in << 32 | n_out), scanned across the block (warp shuffles, one shared
// pass over the 8 warps' totals) and carried from tile to tile. The first
// row beyond log A is the block-wide minimum of the threads' first rows
// (a warp minimum, one shared atomicMin), and the block stops at that tile:
// a survivor of 8192 rows takes 4 tiles. Outputs: accepted (1 byte) and the
// 1-based row of rejection (N for survivors).
//
// Bound on the card: bytes. A hypothesis reads 4 bytes for each row it
// evaluates (the rows up to its rejection, which this run's data decides)
// and the mask once; a row's work is a comparison, a count and one float64
// evaluation, far less time than its bytes at the float64 peak. At 256 x
// 8192 the bytes take about 1 us, so the kernel is bound in practice by
// its launch and a few dependent tile round trips.
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace ctt {

constexpr int kSprtThreads = 256, kSprtRows = 8, kSprtTile = kSprtThreads * kSprtRows;

struct SprtRows {
  float4 a, b;
  unsigned char m[kSprtRows];
};

// The 8 rows from element e of the 16-byte aligned base (row index e -
// lead); elements outside [0, N) read as residual 0 and mask 0.
__device__ __forceinline__ SprtRows sprt_load(const float* base, const unsigned char* mask,
                                              long long e, int lead, long long N) {
  SprtRows x;
  const long long span = N + lead;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  x.a = e < span ? __ldg(reinterpret_cast<const float4*>(base + e)) : zero;
  x.b = e + 4 < span ? __ldg(reinterpret_cast<const float4*>(base + e + 4)) : zero;
  const long long i = e - lead;
  if (i >= 0 && i + kSprtRows <= N && ((uintptr_t)(mask + i) & 7) == 0) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(mask + i));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x.m[j] = (unsigned char)(w.x >> (8 * j));
      x.m[4 + j] = (unsigned char)(w.y >> (8 * j));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kSprtRows; ++j)
      x.m[j] = (i + j >= 0 && i + j < N) ? __ldg(mask + i + j) : 0;
  }
  return x;
}

__global__ void __launch_bounds__(kSprtThreads)
sprt_block_kernel(int N, double max_sq, double log_A, double log_in, double log_out,
                  const float* __restrict__ res, const unsigned char* __restrict__ mask,
                  unsigned char* __restrict__ accepted, int* __restrict__ num_eval) {
  __shared__ unsigned long long warp_tot[kSprtThreads / 32];
  __shared__ int first;
  const int h = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* row = res + (size_t)h * N;
  const int lead = (int)(((uintptr_t)row & 15) >> 2);  // row - lead is 16-byte aligned
  const float* base = row - lead;
  const long long tiles = ((long long)N + lead + kSprtTile - 1) / kSprtTile;
  if (tid == 0) first = INT_MAX;
  unsigned long long carry = 0;  // (n_in << 32) | n_out before the tile
  long long e = (long long)kSprtRows * tid;
  SprtRows cur = sprt_load(base, mask, e, lead, N);
  for (long long tile = 0; tile < tiles; ++tile, e += kSprtTile) {
    const SprtRows x = cur;
    if (tile + 1 < tiles) cur = sprt_load(base, mask, e + kSprtTile, lead, N);
    const float r[kSprtRows] = {x.a.x, x.a.y, x.a.z, x.a.w, x.b.x, x.b.y, x.b.z, x.b.w};
    unsigned long long step[kSprtRows], local = 0;
#pragma unroll
    for (int j = 0; j < kSprtRows; ++j) {
      step[j] = x.m[j] ? ((double)r[j] <= max_sq ? (1ull << 32) : 1ull) : 0ull;
      local += step[j];
    }
    unsigned long long incl = local;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned long long y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    unsigned long long before = carry, total = 0;
#pragma unroll
    for (int w = 0; w < kSprtThreads / 32; ++w) {
      const unsigned long long c = warp_tot[w];
      if (w < warp) before += c;
      total += c;
    }
    unsigned long long run = before + incl - local;
    const long long i0 = e - lead;
    int hit = INT_MAX;
#pragma unroll
    for (int j = 0; j < kSprtRows; ++j) {
      run += step[j];
      const long long i = i0 + j;
      const double L = (double)(unsigned)(run >> 32) * log_in + (double)(unsigned)run * log_out;
      if (hit == INT_MAX && i >= 0 && i < N && L > log_A) hit = (int)i;
    }
    hit = (int)__reduce_min_sync(0xffffffffu, (unsigned)hit);
    if (lane == 0 && hit != INT_MAX) atomicMin(&first, hit);
    carry += total;
    __syncthreads();
    if (first != INT_MAX) break;
  }
  if (tid == 0) {
    accepted[h] = first == INT_MAX ? 1 : 0;
    num_eval[h] = first == INT_MAX ? N : first + 1;  // 1-based
  }
}

}  // namespace ctt

// K47's design: info[0] threads a block, [1] rows a tile, [2] registers a
// thread, [3] local (spilled) bytes a thread, [4] static shared bytes a
// block. Returns a CUDA error code.
extern "C" int sprt_plan(int* info) {
  using namespace ctt;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, sprt_block_kernel);
  if (err != cudaSuccess) return (int)err;
  info[0] = kSprtThreads;
  info[1] = kSprtTile;
  info[2] = attr.numRegs;
  info[3] = (int)attr.localSizeBytes;
  info[4] = (int)attr.sharedSizeBytes;
  return 0;
}

extern "C" int sprt_f32(int M, int N, double max_sq, double log_A, double log_in, double log_out,
                        const float* res, const unsigned char* mask, unsigned char* accepted,
                        int* num_eval, void* stream) {
  using namespace ctt;
  if (M > 0)
    sprt_block_kernel<<<M, kSprtThreads, 0, (cudaStream_t)stream>>>(
        N, max_sq, log_A, log_in, log_out, res, mask, accepted, num_eval);
  return (int)cudaGetLastError();
}
