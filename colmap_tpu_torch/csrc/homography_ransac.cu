// K12 homography_ransac: the batches and the refit of the homography
// LO-RANSAC, over a block of pairs.
//
// Replaces colmap_tpu/estimators/two_view_geometry.py _ransac_h (l.153) with
// the body of optim/ransac.py ransac (l.78) and what it runs:
// estimators/solvers/epipolar.py homography_dlt (l.515, the 4-point solve
// and the weighted N-point refit) and homography_transfer_error (l.541),
// optim/small_linalg.py nullspace_small (l.208); the pair axis is that of
// estimators/two_view_batch.py _verify_block (l.62).
//
// The model:
//   solve: the 4 sample points are Hartley-normalized in float32, the null
//     vector of the 8 x 9 DLT matrix comes from Householder QR, and
//     H = T2^-1 Hn T1 is scaled to unit Frobenius norm (one slot a sample).
//   residual: the squared forward transfer error |H x1 - x2|^2, infinite
//     where the transferred point lies at infinity (|w| < 1e-12).
//   refit: the weighted N-point DLT; each row to fit adds its two DLT rows
//     to the 9 x 9 normal matrix.
//
// propose_score (homography_propose_kernel): grid (ceil(K / kHSamples), B),
// blocks of kHWarps = 8 warps and kHSamples = 32 samples (measured against
// 4 and 16 warps of 32 samples and 4 warps of 128; PERF.md §6). The
// block stages the pair's first rows, then warp 0 solves one sample a
// thread with the whole solve in registers (homography_solve: every loop
// unrolled, so every index is a constant; the Householder vectors
// overwrite B's columns). The block's models go to shared memory; the
// pair's rows are staged kHTile at a time as float4 (u1, v1, u2, v2),
// masked rows NaN (a NaN residual is never an inlier and adds nothing to a
// score). kHParts threads score each model, each over every kHParts-th row
// of a tile (a warp reads one row at a time: a broadcast); the parts'
// counts and MSAC scores are summed in part order. Outputs: models,
// counts, scores, and the packed best by atomicMax (the first model of
// largest support, or of largest MSAC score).
//
// refit: two_view_ransac.cuh's refit kernel (one block of 256 threads a
// pair: the Hartley centroids, the mean distances, the 45 sums of the
// normal matrix, then the support of the refit), with kWarpEigen set: warp
// 0 takes the smallest eigenvector of the 9 x 9 normal matrix
// (small_linalg.cuh warp_smallest_eigvec9: 10 sweeps of 9 rounds of 4
// disjoint rotations in colmap_tpu eigh_small's tournament order, a lane a
// row of A and of V in registers) where the other models' refits run the
// serial Jacobi on thread 0 with its arrays in local memory.
//
// Registers (ptxas -v, sm_90a): the propose 106; no stack frame, no
// spills; shared memory 18-19 KB.
//
// Bits: the solve writes nullspace9<8, 1>'s arithmetic for every value the
// null vector reads (the updates of columns already reduced, which it never
// reads again, are left out), yet the unrolled code compiles to other
// roundings than nullspace9's lane-0 solve (K11's): at 64 pairs x 1024 rows
// x 128 samples 1925 of 8192 models differ in their last bits, 5 counts and
// no best (PERF.md §6). The residual divides by w once (a reciprocal and
// two products, not two divisions: at that block the same counts, and
// the kernel 0.0267 ms against 0.0370 on an NVIDIA H100 80GB HBM3 at 700
// W). MSAC scores are summed in part order
// and the refit's rotations come in a tournament order with fast
// reciprocals, so the kernels are held by their gates against the float64
// plain versions, not by bits.
//
// Bound on the card: operations. A sample costs ~1.5e3 flops on one
// thread; a model and a valid row ~20. On a scene that no plane explains,
// H never reaches the early-exit support and runs all 10000 trials (79
// batches of 128), so it is the RANSAC with the most launches and host
// reads of a verification block.
#include <cfloat>
#include <cuda_runtime.h>

#include "two_view_ransac.cuh"

namespace ctt {

// Hartley normalization of a 4-point sample in place (hartley_sample<4>'s
// arithmetic, unrolled).
__device__ __forceinline__ Hartley hartley4(float (&x)[8]) {
  float cx = 0.f, cy = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    cx += x[2 * i];
    cy += x[2 * i + 1];
  }
  cx /= 4.f;
  cy /= 4.f;
  float d = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    x[2 * i] -= cx;
    x[2 * i + 1] -= cy;
    d += sqrtf(x[2 * i] * x[2 * i] + x[2 * i + 1] * x[2 * i + 1]);
  }
  const float s = kSqrt2F / fmaxf(d / 4.f, 1e-30f);
#pragma unroll
  for (int i = 0; i < 8; ++i) x[i] *= s;
  return Hartley{s, cx, cy};
}

// The model's residual, DLT rows, normal-matrix sums and finish (the
// refit and inlier kernels of two_view_ransac.cuh read them).
struct Homography {
  static constexpr int kDim = 2;
  static constexpr bool kHartley = true;
  static constexpr bool kWarpEigen = true;  // the refit's Jacobi on warp 0

  // The two DLT rows of a normalized correspondence.
  __device__ __forceinline__ static void dlt_rows(float u1, float v1, float u2, float v2,
                                                  float* r1, float* r2) {
    const float a[9] = {-u1, -v1, -1.f, 0.f, 0.f, 0.f, u2 * u1, u2 * v1, u2};
    const float b[9] = {0.f, 0.f, 0.f, -u1, -v1, -1.f, v2 * u1, v2 * v1, v2};
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      r1[c] = a[c];
      r2[c] = b[c];
    }
  }

  __device__ __forceinline__ static float residual(const float* H, float u1, float v1, float u2,
                                                   float v2) {
    const float hx = H[0] * u1 + H[1] * v1 + H[2];
    const float hy = H[3] * u1 + H[4] * v1 + H[5];
    const float w = H[6] * u1 + H[7] * v1 + H[8];
    if (fabsf(w) < 1e-12f) return INFINITY;
    const float iw = 1.f / w;  // one division a row: the score pass's largest cost
    const float dx = hx * iw - u2, dy = hy * iw - v2;
    return dx * dx + dy * dy;
  }

  __device__ __forceinline__ static void accumulate(float u1, float v1, float u2, float v2,
                                                    float* ata) {
    float a[9], b[9];
    dlt_rows(u1, v1, u2, v2, a, b);
    int q = 0;
#pragma unroll
    for (int r = 0; r < 9; ++r)
#pragma unroll
      for (int s = r; s < 9; ++s) ata[q++] += a[r] * a[s] + b[r] * b[s];
  }

  __device__ static void finish(const float* h, const Hartley& T1, const Hartley& T2,
                                float* model) {
    float H[9];
#pragma unroll
    for (int e = 0; e < 9; ++e) H[e] = h[e];
    apply_t2inv_m_t1(T1, T2, H);
    unit_frobenius(H);
#pragma unroll
    for (int e = 0; e < 9; ++e) model[e] = H[e];
  }
};

// The 4-point solve of one sample in registers: s1, s2 the sample's points
// (normalized in place), H the model.
__device__ __forceinline__ void homography_solve(float (&s1)[8], float (&s2)[8], float (&H)[9]) {
  const Hartley T1 = hartley4(s1), T2 = hartley4(s2);
  float B[9][8];  // A^T: column r a DLT row
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float r1[9], r2[9];
    Homography::dlt_rows(s1[2 * r], s1[2 * r + 1], s2[2 * r], s2[2 * r + 1], r1, r2);
#pragma unroll
    for (int c = 0; c < 9; ++c) {
      B[c][r] = r1[c];
      B[c][4 + r] = r2[c];
    }
  }
  // Householder QR of B; reflection j's unit vector replaces column j below
  // the diagonal (nullspace9's V[j]), columns right of j are reflected.
  float scale[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float norm = 0.f;
#pragma unroll
    for (int i = j; i < 9; ++i) norm += B[i][j] * B[i][j];
    norm = sqrtf(norm);
    const float alpha = -(B[j][j] >= 0.f ? 1.f : -1.f) * norm;
    float vn = 0.f;
#pragma unroll
    for (int i = j; i < 9; ++i) {
      B[i][j] = B[i][j] - (i == j ? alpha : 0.f);
      vn += B[i][j] * B[i][j];
    }
    vn = sqrtf(vn);
#pragma unroll
    for (int i = j; i < 9; ++i) B[i][j] /= fmaxf(vn, 1e-30f);
    scale[j] = vn > 1e-30f ? 2.f : 0.f;
#pragma unroll
    for (int c = j + 1; c < 8; ++c) {
      float w = 0.f;
#pragma unroll
      for (int i = j; i < 9; ++i) w += B[i][j] * B[i][c];
#pragma unroll
      for (int i = j; i < 9; ++i) B[i][c] -= scale[j] * B[i][j] * w;
    }
  }
  // Q e_8: the null vector.
  float x[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) x[i] = i == 8 ? 1.f : 0.f;
#pragma unroll
  for (int j = 7; j >= 0; --j) {
    float w = 0.f;
#pragma unroll
    for (int i = j; i < 9; ++i) w += B[i][j] * x[i];
#pragma unroll
    for (int i = j; i < 9; ++i) x[i] -= scale[j] * B[i][j] * w;
  }
  Homography::finish(x, T1, T2, H);
}

constexpr int kHWarps = 8;      // warps a block
constexpr int kHSamples = 32;   // samples a block, one a thread
constexpr int kHTile = 1024;    // rows staged at a time (16 KB)
constexpr int kHParts = 32 * kHWarps / kHSamples;  // threads scoring one model

__device__ __forceinline__ unsigned long long warp_max_u64(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(kFull, v, off);
    v = o > v ? o : v;
  }
  return v;
}

template <bool MSAC>
__global__ void __launch_bounds__(32 * kHWarps)
    homography_propose_kernel(int n, int k, float max_sq, const float* __restrict__ max_sq_arr,
                              const float* __restrict__ x1, const float* __restrict__ x2,
                              const unsigned char* __restrict__ mask,
                              const int* __restrict__ samples,
                              const unsigned char* __restrict__ active,
                              float* __restrict__ models_out, int* __restrict__ counts_out,
                              unsigned long long* __restrict__ best,
                              float* __restrict__ scores_out) {
  static_assert(kHSamples % 32 == 0 && (32 * kHWarps) % kHSamples == 0, "block shape");
  __shared__ float4 rows[kHTile];
  __shared__ float hm[9][kHSamples];
  __shared__ int part_count[kHParts][kHSamples];
  __shared__ float part_score[MSAC ? kHParts : 1][kHSamples];
  const int pair = blockIdx.y;
  if (active != nullptr && !active[pair]) return;
  const int t = threadIdx.x;
  const int s0 = blockIdx.x * kHSamples;
  x1 += (size_t)pair * n * 2;
  x2 += (size_t)pair * n * 2;
  mask += (size_t)pair * n;
  if (max_sq_arr != nullptr) max_sq = max_sq_arr[pair];
  // Rows [base, base + len) of the pair into the staging tile.
  auto stage = [&](int base, int len) {
    for (int i = t; i < len; i += 32 * kHWarps) {
      const int r = base + i;
      const float2 a = reinterpret_cast<const float2*>(x1)[r];
      const float2 b = reinterpret_cast<const float2*>(x2)[r];
      rows[i] = mask[r] ? make_float4(a.x, a.y, b.x, b.y) : make_float4(NAN, NAN, NAN, NAN);
    }
  };
  stage(0, min(kHTile, n));  // the first tile's loads overlap the solves
  if (t < kHSamples) {
    float H[9];
    if (s0 + t < k) {
      const int* idx = samples + ((size_t)pair * k + s0 + t) * 4;
      float s1[8], s2[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = idx[r];
        s1[2 * r] = x1[2 * i];
        s1[2 * r + 1] = x1[2 * i + 1];
        s2[2 * r] = x2[2 * i];
        s2[2 * r + 1] = x2[2 * i + 1];
      }
      homography_solve(s1, s2, H);
    } else {
#pragma unroll
      for (int e = 0; e < 9; ++e) H[e] = NAN;
    }
#pragma unroll
    for (int e = 0; e < 9; ++e) hm[e][t] = H[e];
  }
  const int m = t % kHSamples, q = t / kHSamples;
  __syncthreads();
  float H[9];
#pragma unroll
  for (int e = 0; e < 9; ++e) H[e] = hm[e][m];
  const bool finite = all_finite(H, 9);
  int cnt = 0;
  float sc = 0.f;
  for (int base = 0; base < n; base += kHTile) {
    const int len = min(kHTile, n - base);
    if (base > 0) {
      __syncthreads();  // the last tile's reads are done
      stage(base, len);
      __syncthreads();
    }
    if (finite) {
      for (int i = q; i < len; i += kHParts) {
        const float4 v = rows[i];
        const float res = Homography::residual(H, v.x, v.y, v.z, v.w);
        const bool in = res <= max_sq;
        cnt += in;
        if constexpr (MSAC) sc += in ? max_sq - res : 0.f;
      }
    }
  }
  if constexpr (kHParts > 1) {
    part_count[q][m] = cnt;
    if constexpr (MSAC) part_score[q][m] = sc;
    __syncthreads();
    if (t < kHSamples) {
      cnt = 0;
      sc = 0.f;
#pragma unroll
      for (int p = 0; p < kHParts; ++p) {
        cnt += part_count[p][t];
        if constexpr (MSAC) sc += part_score[p][t];
      }
    }
  }
  if (t < kHSamples) {
    const int s = s0 + t;
    unsigned long long packed = 0ull;
    if (s < k) {
      const size_t o = (size_t)pair * k + s;
#pragma unroll
      for (int e = 0; e < 9; ++e) models_out[o * 9 + e] = H[e];
      counts_out[o] = cnt;
      if constexpr (MSAC) {
        scores_out[o] = sc;
        packed = pack_best_score(sc, s);
      } else {
        packed = pack_best(cnt, s);
      }
    }
    packed = warp_max_u64(packed);
    if ((t & 31) == 0 && packed != 0ull) atomicMax(best + pair, packed);
  }
}

}  // namespace ctt

extern "C" int homography_propose_score_f32(int b, int n, int k, float max_sq,
                                            const float* max_sq_arr, const float* x1,
                                            const float* x2, const unsigned char* mask,
                                            const int* samples, const unsigned char* active,
                                            float* models, int* counts, unsigned long long* best,
                                            int msac, float* scores, void* stream) {
  if (b == 0 || k == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((k + ctt::kHSamples - 1) / ctt::kHSamples), (unsigned)b);
  const cudaStream_t s = (cudaStream_t)stream;
  if (msac)
    ctt::homography_propose_kernel<true><<<grid, 32 * ctt::kHWarps, 0, s>>>(
        n, k, max_sq, max_sq_arr, x1, x2, mask, samples, active, models, counts, best, scores);
  else
    ctt::homography_propose_kernel<false><<<grid, 32 * ctt::kHWarps, 0, s>>>(
        n, k, max_sq, max_sq_arr, x1, x2, mask, samples, active, models, counts, best, scores);
  return (int)cudaGetLastError();
}

CTT_TWO_VIEW_REFIT_INLIERS_ENTRIES(homography, ctt::Homography)
