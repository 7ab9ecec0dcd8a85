// The three entries of a two-view LO-RANSAC over a block of pairs, written
// once for a model family (K11 fundamental matrix, K12 homography):
//
//   propose_score: grid (ceil(K / warps), B); one warp per (pair, sample).
//     Lane 0 gathers the minimal sample and solves it (Model::solve: up to
//     kSolutions 3x3 models, NaN where a slot has none); the warp scores
//     them on the pair's N rows in one strided pass, writes models and
//     counts, and keeps the pair's best with one 64-bit atomicMax on
//     (count, index), the first model of largest support.
//   refit: one block per pair (colmap_tpu optim/ransac.py _try_refine). The
//     rows within the threshold of the given model are Hartley-normalized
//     (weighted centroid, then mean distance), the 9 x 9 normal matrix of
//     the family's linear system is summed over them by the block (45
//     entries), its smallest eigenvector comes from Jacobi
//     (small_linalg.cuh), and Model::finish turns it into a model; it is
//     kept if it is finite and its support is larger. The smallest
//     eigenvector of A^T A is the smallest right singular vector of A (the
//     plain version's route for refits too); its condition number is that
//     of A squared, which in float32 costs the refit about half its digits
//     on near-degenerate inlier sets.
//   inliers: grid (ceil(N / 256), B), the inlier mask of one model per pair.
//
// A pair is a row of x1, x2 (B, N, 2) and mask (B, N); rows beyond a pair's
// match count carry mask 0. max_sq is one float for all pairs or, when
// max_sq_arr is not null, one per pair. Pairs whose ``active`` byte is 0
// are skipped by propose_score (their outputs are not written). The
// one-pair entries of the wrappers are B = 1.
#pragma once

#include <cuda_runtime.h>

#include "sfm_common.cuh"
#include "small_linalg.cuh"

namespace ctt {

constexpr float kSqrt2F = 1.41421356237f;

// Hartley similarity x -> s (x - c): T = [[s, 0, -s cx], [0, s, -s cy], [0, 0, 1]].
struct Hartley {
  float s, cx, cy;
};

// M = T2^T M T1.
__device__ inline void apply_t2t_m_t1(const Hartley& T1, const Hartley& T2, float* M) {
  const float A[9] = {T1.s, 0.f, -T1.s * T1.cx, 0.f, T1.s, -T1.s * T1.cy, 0.f, 0.f, 1.f};
  const float B[9] = {T2.s, 0.f, -T2.s * T2.cx, 0.f, T2.s, -T2.s * T2.cy, 0.f, 0.f, 1.f};
  float MA[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      MA[i * 3 + j] = M[i * 3] * A[j] + M[i * 3 + 1] * A[3 + j] + M[i * 3 + 2] * A[6 + j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      M[i * 3 + j] = B[i] * MA[j] + B[3 + i] * MA[3 + j] + B[6 + i] * MA[6 + j];
}

// M = T2^-1 M T1.
__device__ inline void apply_t2inv_m_t1(const Hartley& T1, const Hartley& T2, float* M) {
  const float A[9] = {T1.s, 0.f, -T1.s * T1.cx, 0.f, T1.s, -T1.s * T1.cy, 0.f, 0.f, 1.f};
  const float inv = 1.f / T2.s;
  const float B[9] = {inv, 0.f, T2.cx, 0.f, inv, T2.cy, 0.f, 0.f, 1.f};
  float MA[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      MA[i * 3 + j] = M[i * 3] * A[j] + M[i * 3 + 1] * A[3 + j] + M[i * 3 + 2] * A[6 + j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      M[i * 3 + j] = B[i * 3] * MA[j] + B[i * 3 + 1] * MA[3 + j] + B[i * 3 + 2] * MA[6 + j];
}

__device__ inline void unit_frobenius(float* M) {
  float n = 0.f;
  for (int e = 0; e < 9; ++e) n += M[e] * M[e];
  const float inv = 1.f / fmaxf(sqrtf(n), 1e-30f);
  for (int e = 0; e < 9; ++e) M[e] *= inv;
}

// Hartley normalization of the M points of a minimal sample, in place.
template <int M>
__device__ inline Hartley hartley_sample(float* x) {
  float cx = 0.f, cy = 0.f;
  for (int i = 0; i < M; ++i) {
    cx += x[2 * i];
    cy += x[2 * i + 1];
  }
  cx /= (float)M;
  cy /= (float)M;
  float d = 0.f;
  for (int i = 0; i < M; ++i) {
    x[2 * i] -= cx;
    x[2 * i + 1] -= cy;
    d += sqrtf(x[2 * i] * x[2 * i] + x[2 * i + 1] * x[2 * i + 1]);
  }
  const float s = kSqrt2F / fmaxf(d / (float)M, 1e-30f);
  for (int i = 0; i < 2 * M; ++i) x[i] *= s;
  return Hartley{s, cx, cy};
}

// Orthonormal basis of the null space of an R x 9 matrix A (R < 9), given
// as B = A^T (9 x R): Householder QR of B, the columns R..R+NS-1 of Q
// (optim/small_linalg.py nullspace_small). ns is 9 x NS, row-major.
template <int R, int NS>
__device__ inline void nullspace9(float (*B)[R], float* ns) {
  float V[R][9], scale[R];
  for (int j = 0; j < R; ++j) {
    float norm = 0.f;
    for (int i = j; i < 9; ++i) norm += B[i][j] * B[i][j];
    norm = sqrtf(norm);
    const float alpha = -(B[j][j] >= 0.f ? 1.f : -1.f) * norm;
    float vn = 0.f;
    for (int i = j; i < 9; ++i) {
      V[j][i] = B[i][j] - (i == j ? alpha : 0.f);
      vn += V[j][i] * V[j][i];
    }
    vn = sqrtf(vn);
    for (int i = j; i < 9; ++i) V[j][i] /= fmaxf(vn, 1e-30f);
    scale[j] = vn > 1e-30f ? 2.f : 0.f;
    for (int c = 0; c < R; ++c) {
      float w = 0.f;
      for (int i = j; i < 9; ++i) w += V[j][i] * B[i][c];
      for (int i = j; i < 9; ++i) B[i][c] -= scale[j] * V[j][i] * w;
    }
  }
  for (int k = 0; k < NS; ++k) {
    float x[9];
    for (int i = 0; i < 9; ++i) x[i] = i == R + k ? 1.f : 0.f;
    for (int j = R - 1; j >= 0; --j) {
      float w = 0.f;
      for (int i = j; i < 9; ++i) w += V[j][i] * x[i];
      for (int i = j; i < 9; ++i) x[i] -= scale[j] * V[j][i] * w;
    }
    for (int i = 0; i < 9; ++i) ns[i * NS + k] = x[i];
  }
}

template <class Model, int WARPS>
__global__ void two_view_propose_score_kernel(int n, int k, float max_sq,
                                              const float* __restrict__ max_sq_arr,
                                              const float* __restrict__ x1,
                                              const float* __restrict__ x2,
                                              const unsigned char* __restrict__ mask,
                                              const int* __restrict__ samples,
                                              const unsigned char* __restrict__ active,
                                              float* __restrict__ models_out,
                                              int* __restrict__ counts_out,
                                              unsigned long long* __restrict__ best) {
  constexpr int S = Model::kSolutions, M = Model::kSample;
  __shared__ float models[WARPS][S * 9];
  const int pair = blockIdx.y;
  if (active != nullptr && !active[pair]) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sample = blockIdx.x * WARPS + warp;
  if (sample >= k) return;  // whole warps leave together
  x1 += (size_t)pair * n * 2;
  x2 += (size_t)pair * n * 2;
  mask += (size_t)pair * n;
  if (max_sq_arr != nullptr) max_sq = max_sq_arr[pair];
  if (lane == 0) {
    float s1[2 * M], s2[2 * M];
    const int* rows = samples + ((size_t)pair * k + sample) * M;
    for (int r = 0; r < M; ++r) {
      const int row = rows[r];
      s1[2 * r] = x1[2 * row];
      s1[2 * r + 1] = x1[2 * row + 1];
      s2[2 * r] = x2[2 * row];
      s2[2 * r + 1] = x2[2 * row + 1];
    }
    Model::solve(s1, s2, models[warp]);
  }
  __syncwarp();
  bool finite[S];
  int cnt[S];
  for (int r = 0; r < S; ++r) {
    finite[r] = all_finite(models[warp] + 9 * r, 9);
    cnt[r] = 0;
  }
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool ok = i < n && mask[i];
    float u1 = 0.f, v1 = 0.f, u2 = 0.f, v2 = 0.f;
    if (ok) {
      u1 = x1[2 * i];
      v1 = x1[2 * i + 1];
      u2 = x2[2 * i];
      v2 = x2[2 * i + 1];
    }
    for (int r = 0; r < S; ++r) {
      const bool in =
          ok && finite[r] && Model::residual(models[warp] + 9 * r, u1, v1, u2, v2) <= max_sq;
      cnt[r] += __popc(__ballot_sync(kFull, in));
    }
  }
  if (lane < S) {
    int c = 0;
    for (int r = 0; r < S; ++r) c = r == lane ? cnt[r] : c;
    const int idx = sample * S + lane;
    float* out = models_out + ((size_t)pair * k * S + idx) * 9;
    for (int e = 0; e < 9; ++e) out[e] = models[warp][9 * lane + e];
    counts_out[(size_t)pair * k * S + idx] = c;
    atomicMax(best + pair, pack_best(c, idx));
  }
}

constexpr int kTwoViewRefitThreads = 256;

// FIT_ONLY: fit on the rows of ``mask`` and write the fit as it is (no model
// in, no comparison of supports).
template <class Model, bool FIT_ONLY>
__global__ void two_view_refit_kernel(int n, float max_sq, const float* __restrict__ max_sq_arr,
                                      int count_in, const int* __restrict__ count_arr,
                                      const float* __restrict__ x1, const float* __restrict__ x2,
                                      const unsigned char* __restrict__ mask,
                                      const float* __restrict__ model_in,
                                      float* __restrict__ model_out, int* __restrict__ count_out) {
  __shared__ float scratch[32 * 45];
  __shared__ float refined[9];
  __shared__ bool refined_ok;
  const int pair = blockIdx.x;
  x1 += (size_t)pair * n * 2;
  x2 += (size_t)pair * n * 2;
  mask += (size_t)pair * n;
  if (max_sq_arr != nullptr) max_sq = max_sq_arr[pair];
  if (count_arr != nullptr) count_in = count_arr[pair];
  float m[9];
  for (int e = 0; e < 9; ++e) m[e] = FIT_ONLY ? 0.f : model_in[pair * 9 + e];
  auto fit_row = [&](int i) {
    if (!mask[i]) return false;
    if (FIT_ONLY) return true;
    return Model::residual(m, x1[2 * i], x1[2 * i + 1], x2[2 * i], x2[2 * i + 1]) <= max_sq;
  };
  // Hartley normalization of both point sets over the rows to fit.
  float c[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // W, sum x1, sum x2
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!fit_row(i)) continue;
    c[0] += 1.f;
    c[1] += x1[2 * i];
    c[2] += x1[2 * i + 1];
    c[3] += x2[2 * i];
    c[4] += x2[2 * i + 1];
  }
  block_sum<5>(c, scratch);
  const float W = fmaxf(c[0], 1e-30f);
  Hartley T1{1.f, c[1] / W, c[2] / W}, T2{1.f, c[3] / W, c[4] / W};
  float d[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!fit_row(i)) continue;
    const float a = x1[2 * i] - T1.cx, b = x1[2 * i + 1] - T1.cy;
    const float e = x2[2 * i] - T2.cx, f = x2[2 * i + 1] - T2.cy;
    d[0] += sqrtf(a * a + b * b);
    d[1] += sqrtf(e * e + f * f);
  }
  block_sum<2>(d, scratch);
  T1.s = kSqrt2F / fmaxf(d[0] / W, 1e-30f);
  T2.s = kSqrt2F / fmaxf(d[1] / W, 1e-30f);
  // The normal matrix over the rows to fit (upper triangle, 45 entries).
  float ata[45];
  for (int q = 0; q < 45; ++q) ata[q] = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!fit_row(i)) continue;
    Model::accumulate((x1[2 * i] - T1.cx) * T1.s, (x1[2 * i + 1] - T1.cy) * T1.s,
                      (x2[2 * i] - T2.cx) * T2.s, (x2[2 * i + 1] - T2.cy) * T2.s, ata);
  }
  block_sum<45>(ata, scratch);
  if (threadIdx.x == 0) {
    float A[81], f[9];
    int q = 0;
    for (int r = 0; r < 9; ++r)
      for (int s = r; s < 9; ++s) {
        A[r * 9 + s] = ata[q];
        A[s * 9 + r] = ata[q++];
      }
    smallest_eigvec<9>(A, f, 10);
    Model::finish(f, T1, T2, refined);
    refined_ok = all_finite(refined, 9);
  }
  __syncthreads();
  float r[9];
  for (int e = 0; e < 9; ++e) r[e] = refined[e];
  if (FIT_ONLY) {
    if (threadIdx.x < 9) model_out[pair * 9 + threadIdx.x] = r[threadIdx.x];
    return;
  }
  float cnt[1] = {0.f};
  if (refined_ok)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      if (mask[i] &&
          Model::residual(r, x1[2 * i], x1[2 * i + 1], x2[2 * i], x2[2 * i + 1]) <= max_sq)
        cnt[0] += 1.f;
  block_sum<1>(cnt, scratch);
  if (threadIdx.x == 0) {
    const int count_r = (int)cnt[0];
    const bool take = refined_ok && count_r > count_in;
    for (int e = 0; e < 9; ++e) model_out[pair * 9 + e] = take ? r[e] : m[e];
    count_out[pair] = take ? count_r : count_in;
  }
}

template <class Model>
__global__ void two_view_inliers_kernel(int n, float max_sq, const float* __restrict__ max_sq_arr,
                                        const float* __restrict__ x1, const float* __restrict__ x2,
                                        const unsigned char* __restrict__ mask,
                                        const float* __restrict__ model,
                                        unsigned char* __restrict__ inl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int pair = blockIdx.y;
  if (i >= n) return;
  if (max_sq_arr != nullptr) max_sq = max_sq_arr[pair];
  float m[9];
  for (int e = 0; e < 9; ++e) m[e] = model[pair * 9 + e];
  const size_t row = (size_t)pair * n + i;
  inl[row] = mask[row] && Model::residual(m, x1[2 * row], x1[2 * row + 1], x2[2 * row],
                                          x2[2 * row + 1]) <= max_sq;
}

}  // namespace ctt

// The C entries of a model family NAME over Model (see the header note).
#define CTT_TWO_VIEW_ENTRIES(NAME, Model, WARPS)                                                  \
  extern "C" int NAME##_propose_score_f32(                                                        \
      int b, int n, int k, float max_sq, const float* max_sq_arr, const float* x1,               \
      const float* x2, const unsigned char* mask, const int* samples,                            \
      const unsigned char* active, float* models, int* counts, unsigned long long* best,         \
      void* stream) {                                                                             \
    if (b == 0 || k == 0) return (int)cudaGetLastError();                                         \
    const dim3 grid((unsigned)((k + WARPS - 1) / WARPS), (unsigned)b);                            \
    ctt::two_view_propose_score_kernel<Model, WARPS>                                              \
        <<<grid, 32 * WARPS, 0, (cudaStream_t)stream>>>(n, k, max_sq, max_sq_arr, x1, x2, mask,   \
                                                        samples, active, models, counts, best);  \
    return (int)cudaGetLastError();                                                               \
  }                                                                                               \
  extern "C" int NAME##_refit_f32(int b, int n, float max_sq, const float* max_sq_arr,           \
                                  int count_in, const int* count_arr, const float* x1,           \
                                  const float* x2, const unsigned char* mask,                    \
                                  const float* model_in, float* model_out, int* count_out,       \
                                  void* stream) {                                                 \
    if (b == 0) return (int)cudaGetLastError();                                                   \
    ctt::two_view_refit_kernel<Model, false>                                                      \
        <<<b, ctt::kTwoViewRefitThreads, 0, (cudaStream_t)stream>>>(                              \
            n, max_sq, max_sq_arr, count_in, count_arr, x1, x2, mask, model_in, model_out,        \
            count_out);                                                                           \
    return (int)cudaGetLastError();                                                               \
  }                                                                                               \
  extern "C" int NAME##_inliers_f32(int b, int n, float max_sq, const float* max_sq_arr,         \
                                    const float* x1, const float* x2, const unsigned char* mask, \
                                    const float* model, unsigned char* inl, void* stream) {      \
    if (b == 0 || n == 0) return (int)cudaGetLastError();                                         \
    const dim3 grid((unsigned)((n + 255) / 256), (unsigned)b);                                    \
    ctt::two_view_inliers_kernel<Model><<<grid, 256, 0, (cudaStream_t)stream>>>(                  \
        n, max_sq, max_sq_arr, x1, x2, mask, model, inl);                                         \
    return (int)cudaGetLastError();                                                               \
  }
