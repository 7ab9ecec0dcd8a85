// K10 match_top2: brute-force descriptor matching of a block of image pairs.
//
// Replaces colmap_tpu/feature/matcher.py match_similarity (l.53, with
// _best_two l.42, vmapped over the pairs of a block at l.193) and
// match_guided_similarity (l.109): per pair, the rows of two (N, 128) and
// (M, 128) uint8 descriptor sets are scaled to unit float32 vectors, their
// N x M similarity is formed, each row's best and second-best similarity and
// argmax feed the arccos distance and ratio tests, and the cross check keeps
// a row only if it is the argmax of its best column. Guided matching first
// masks the pairs of keypoints that lie further than a threshold from each
// other's epipolar lines under the pair's F.
//
// Two launches. match_top2_kernel, grid (ceil(cap / 64), B): a block owns 64
// rows of image 1 of one pair. It loads and normalizes them once into shared
// memory (all 128 dimensions, k-major), then walks over image 2 in tiles of
// 64 columns: each tile is loaded and normalized the same way, the 64 x 64
// similarities are formed from shared memory in registers (4 x 4 per thread),
// and the epilogue folds them into
//   - each row's running (best, second best, argmax): the 16 threads of a row
//     merge by shuffles on a packed key (ordered similarity, 0xFFFFFFFF -
//     column), so the first of equal maxima wins as jnp.argmax does, and a
//     duplicate of the best counts as the second best;
//   - each column's best row over this block's rows, by a shared-memory
//     atomicMax on (ordered similarity, 0xFFFFFFFF - row), then one global
//     atomicMax per column into the (B, cap) scratch the wrapper zeroed.
// The similarity matrix never reaches device memory. match_finish_kernel,
// one thread per (pair, row), runs after all row blocks have folded their
// columns: arccos tests and the cross check against the scratch.
//
// Bound on the card: operations, 2 N M 128 float32 per pair (17.2 Gflop at
// 8192 x 8192, 0.256 ms at 67 Tflop/s); the 2 MB of descriptors per pair do
// not bind. The product runs on the float32 pipes from shared memory, which
// reaches a fraction of that peak. The dot products of uint8 descriptors are
// exact integers below 2^23, so a later version can form them on the tensor
// cores (int8 mma needs the operands offset by 128, or two 4-bit halves) and
// scale by the two norms in the epilogue, at many times this rate; the
// epilogue and the two-launch structure stay as they are.
#include <cfloat>
#include <cuda_runtime.h>

#include "sfm_common.cuh"

namespace ctt {

constexpr int kTile = 64;   // rows and columns of a similarity tile
constexpr int kDesc = 128;  // descriptor bytes
constexpr int kMatchThreads = 256;
constexpr int kMatchSmemBytes = 2 * kDesc * kTile * (int)sizeof(float);

// Monotone map of a float onto unsigned integers.
__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long pack_sim(float sim, int index) {
  return ((unsigned long long)ordered_bits(sim) << 32) |
         (unsigned long long)(0xFFFFFFFFu - (unsigned)index);
}

__device__ __forceinline__ int unpack_index(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
}

// Rows [row0, row0 + 64) of one image's descriptors, scaled to unit length,
// into tile[k * 64 + r]; rows at or beyond ``count`` become zeros. Thread t
// loads 32 bytes of row t % 64; ``partial`` (4 x 64) sums the squares.
__device__ void load_tile(const unsigned char* __restrict__ desc, int count, int row0,
                          float* __restrict__ tile, int* __restrict__ partial) {
  const int r = threadIdx.x & 63, q = threadIdx.x >> 6;
  const int row = row0 + r;
  uint4 w0 = make_uint4(0u, 0u, 0u, 0u), w1 = w0;
  if (row < count) {
    const uint4* src = reinterpret_cast<const uint4*>(desc + (size_t)row * kDesc + 32 * q);
    w0 = src[0];
    w1 = src[1];
  }
  const unsigned words[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  int ss = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int v = (int)((words[j >> 2] >> (8 * (j & 3))) & 0xffu);
    ss += v * v;
  }
  partial[q * kTile + r] = ss;
  __syncthreads();
  const int total = partial[r] + partial[kTile + r] + partial[2 * kTile + r] + partial[3 * kTile + r];
  const float inv = 1.f / fmaxf(sqrtf((float)total), 1e-12f);
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float v = (float)((words[j >> 2] >> (8 * (j & 3))) & 0xffu);
    tile[(32 * q + j) * kTile + r] = v * inv;
  }
  __syncthreads();
}

// Fold (key_b, best_b, second_b) into (key, best, second): the larger packed
// key wins, the second best is the larger of the winner's second and the
// loser's best.
__device__ __forceinline__ void merge_top2(unsigned long long& key, float& best, float& second,
                                           unsigned long long key_b, float best_b, float second_b) {
  if (key_b > key) {
    second = fmaxf(second_b, best);
    key = key_b;
    best = best_b;
  } else {
    second = fmaxf(second, best_b);
  }
}

template <bool GUIDED>
__global__ void __launch_bounds__(kMatchThreads)
match_top2_kernel(int cap, float guided_max_error, const unsigned char* __restrict__ desc,
                  const int* __restrict__ counts, const int* __restrict__ pairs,
                  const float* __restrict__ keypoints, const float* __restrict__ Fs,
                  float* __restrict__ best_out, float* __restrict__ second_out,
                  int* __restrict__ idx_out, unsigned long long* __restrict__ col_best) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                  // [128][64] rows of image 1
  float* Bs = smem + kDesc * kTile;  // [128][64] columns of image 2
  __shared__ int partial[4 * kTile];
  __shared__ unsigned long long col_key[kTile];
  __shared__ float row_line[kTile][4];  // guided: the line F p1 and its norm
  __shared__ float col_pt[kTile][3];    // guided: p2 and the norm of (F^T p2)[:2]

  const int pair = blockIdx.y, row0 = blockIdx.x * kTile;
  const int i1 = pairs[2 * pair], i2 = pairs[2 * pair + 1];
  const int n1 = counts[i1], n2 = counts[i2];
  if (row0 >= n1) return;
  const unsigned char* d1 = desc + (size_t)i1 * cap * kDesc;
  const unsigned char* d2 = desc + (size_t)i2 * cap * kDesc;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float F[9];
  if (GUIDED) {
    for (int e = 0; e < 9; ++e) F[e] = Fs[pair * 9 + e];
    if (threadIdx.x < kTile) {
      const int row = row0 + threadIdx.x;
      float x = 0.f, y = 0.f;
      if (row < n1) {
        x = keypoints[((size_t)i1 * cap + row) * 2];
        y = keypoints[((size_t)i1 * cap + row) * 2 + 1];
      }
      const float l0 = F[0] * x + F[1] * y + F[2], l1 = F[3] * x + F[4] * y + F[5];
      row_line[threadIdx.x][0] = l0;
      row_line[threadIdx.x][1] = l1;
      row_line[threadIdx.x][2] = F[6] * x + F[7] * y + F[8];
      row_line[threadIdx.x][3] = fmaxf(sqrtf(l0 * l0 + l1 * l1), 1e-12f);
    }
  }
  load_tile(d1, n1, row0, As, partial);

  // Running state of rows row0 + 4 ty + i, the same in the 16 threads of a row.
  unsigned long long run_key[4];
  float run_best[4], run_second[4];
  for (int i = 0; i < 4; ++i) {
    run_best[i] = -INFINITY;
    run_second[i] = -INFINITY;
    run_key[i] = pack_sim(-INFINITY, 0);
  }

  for (int c0 = 0; c0 < n2; c0 += kTile) {
    if (threadIdx.x < kTile) {
      col_key[threadIdx.x] = 0ull;
      if (GUIDED) {
        const int col = c0 + threadIdx.x;
        float x = 0.f, y = 0.f;
        if (col < n2) {
          x = keypoints[((size_t)i2 * cap + col) * 2];
          y = keypoints[((size_t)i2 * cap + col) * 2 + 1];
        }
        const float m0 = F[0] * x + F[3] * y + F[6], m1 = F[1] * x + F[4] * y + F[7];
        col_pt[threadIdx.x][0] = x;
        col_pt[threadIdx.x][1] = y;
        col_pt[threadIdx.x][2] = fmaxf(sqrtf(m0 * m0 + m1 * m1), 1e-12f);
      }
    }
    load_tile(d2, n2, c0, Bs, partial);

    float acc[4][4];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int k = 0; k < kDesc; ++k) {
      const float4 a4 = *reinterpret_cast<const float4*>(As + k * kTile + 4 * ty);
      const float4 b4 = *reinterpret_cast<const float4*>(Bs + k * kTile + 4 * tx);
      const float a[4] = {a4.x, a4.y, a4.z, a4.w}, b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }

    unsigned long long ckey[4] = {0ull, 0ull, 0ull, 0ull};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 4 * ty + i;
      float lbest = -INFINITY, lsecond = -INFINITY;
      int lidx = c0 + 4 * tx;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + 4 * tx + j;
        bool ok = row < n1 && col < n2;
        if (GUIDED) {
          const float* l = row_line[4 * ty + i];
          const float* p = col_pt[4 * tx + j];
          const float num = fabsf(l[0] * p[0] + l[1] * p[1] + l[2]);
          ok = ok && num / p[2] <= guided_max_error && num / l[3] <= guided_max_error;
        }
        const float v = ok ? acc[i][j] : -INFINITY;
        if (v > lbest) {
          lsecond = lbest;
          lbest = v;
          lidx = col;
        } else if (v > lsecond) {
          lsecond = v;
        }
        if (ok) {
          const unsigned long long ck = pack_sim(v, row);
          ckey[j] = ck > ckey[j] ? ck : ckey[j];
        }
      }
      // The row's top two over the tile: butterfly over its 16 threads.
      unsigned long long key = pack_sim(lbest, lidx);
      for (int off = 8; off > 0; off >>= 1) {
        const unsigned long long key_b = __shfl_xor_sync(kFull, key, off);
        const float best_b = __shfl_xor_sync(kFull, lbest, off);
        const float second_b = __shfl_xor_sync(kFull, lsecond, off);
        merge_top2(key, lbest, lsecond, key_b, best_b, second_b);
      }
      merge_top2(run_key[i], run_best[i], run_second[i], key, lbest, lsecond);
    }
    // The columns' best rows over this block's 64 rows, then over all blocks.
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ckey[j] != 0ull) atomicMax(&col_key[4 * tx + j], ckey[j]);
    __syncthreads();
    if (threadIdx.x < kTile) {
      const int col = c0 + threadIdx.x;
      const unsigned long long ck = col_key[threadIdx.x];
      if (col < n2 && ck != 0ull) {
        unsigned long long* g = col_best + (size_t)pair * cap + col;
        if (ck > *reinterpret_cast<volatile unsigned long long*>(g)) atomicMax(g, ck);
      }
    }
    __syncthreads();
  }

  if (tx == 0) {
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + 4 * ty + i;
      if (row >= n1) continue;
      const size_t o = (size_t)pair * cap + row;
      best_out[o] = run_best[i];
      second_out[o] = run_second[i];
      idx_out[o] = unpack_index(run_key[i]);
    }
  }
}

__global__ void match_finish_kernel(int cap, int cross_check, float max_distance, float max_ratio,
                                    const int* __restrict__ counts, const int* __restrict__ pairs,
                                    const float* __restrict__ best, const float* __restrict__ second,
                                    int* __restrict__ idx2,
                                    const unsigned long long* __restrict__ col_best,
                                    unsigned char* __restrict__ ok) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x, pair = blockIdx.y;
  if (r >= cap) return;
  const size_t o = (size_t)pair * cap + r;
  if (r >= counts[pairs[2 * pair]]) {
    idx2[o] = 0;
    ok[o] = 0;
    return;
  }
  const float b = best[o], s = second[o];
  const float dist_best = acosf(fminf(fmaxf(b, -1.f), 1.f));
  const float dist_second = acosf(fminf(fmaxf(s, -1.f), 1.f));
  bool good = b > -INFINITY && dist_best <= max_distance && dist_best <= max_ratio * dist_second;
  if (good && cross_check)
    good = unpack_index(col_best[(size_t)pair * cap + idx2[o]]) == r;
  ok[o] = good;
}

}  // namespace ctt

extern "C" int match_top2_f32(int b, int cap, int guided, float guided_max_error,
                              const unsigned char* desc, const int* counts, const int* pairs,
                              const float* keypoints, const float* Fs, float* best, float* second,
                              int* idx2, unsigned long long* col_best, void* stream) {
  using namespace ctt;
  if (b == 0 || cap == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((cap + kTile - 1) / kTile), (unsigned)b);
  cudaError_t err;
  if (guided) {
    err = cudaFuncSetAttribute(match_top2_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMatchSmemBytes);
    if (err != cudaSuccess) return (int)err;
    match_top2_kernel<true><<<grid, kMatchThreads, kMatchSmemBytes, (cudaStream_t)stream>>>(
        cap, guided_max_error, desc, counts, pairs, keypoints, Fs, best, second, idx2, col_best);
  } else {
    err = cudaFuncSetAttribute(match_top2_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kMatchSmemBytes);
    if (err != cudaSuccess) return (int)err;
    match_top2_kernel<false><<<grid, kMatchThreads, kMatchSmemBytes, (cudaStream_t)stream>>>(
        cap, guided_max_error, desc, counts, pairs, keypoints, Fs, best, second, idx2, col_best);
  }
  return (int)cudaGetLastError();
}

extern "C" int match_finish_f32(int b, int cap, int cross_check, float max_distance,
                                float max_ratio, const int* counts, const int* pairs,
                                const float* best, const float* second, int* idx2,
                                const unsigned long long* col_best, unsigned char* ok,
                                void* stream) {
  using namespace ctt;
  if (b == 0 || cap == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((cap + 255) / 256), (unsigned)b);
  match_finish_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
      cap, cross_check, max_distance, max_ratio, counts, pairs, best, second, idx2, col_best, ok);
  return (int)cudaGetLastError();
}
