// The three entries of a two-view LO-RANSAC over a block of pairs, written
// once for a model family (K11 fundamental matrix, K12 homography on image
// points; K33 homography on unit bearing rays). A Model gives kDim, the
// floats of a row (2 for image points, 3 for rays), and kHartley, whether
// its refit conditions the rows (image points) or takes them as they are
// (unit rays need no conditioning):
//
//   propose_score: grid (ceil(K / warps), B); one warp per (pair, sample).
//     Lane 0 gathers the minimal sample and solves it (Model::solve: up to
//     kSolutions 3x3 models, NaN where a slot has none); the warp scores
//     them on the pair's N rows in one strided pass, writes models and
//     counts, and keeps the pair's best with one 64-bit atomicMax on
//     (count, index), the first model of largest support. A Model that
//     sets kLaneSolve (K33) has its block's samples solved by lanes 0..
//     warps-1 of warp 0, one a lane, before a block barrier: the solves run
//     side by side and their local arrays share cache lines. Models without
//     it (K11, K12) compile to the code they had.
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
// MSAC (colmap_tpu optim/ransac.py _score with support="m_estimator"): with
// the MSAC template flag, propose_score also sums max(max_sq - r, 0) over a
// model's valid rows (each lane its rows in order, then a butterfly of warp
// shuffles: a fixed order, no float atomics; a NaN residual adds nothing),
// writes the score beside the count and packs (score bits, index)
// (pack_best_score); refit sums the refit's score in the same block pass as
// its count and keeps the refit where the score is larger. Without the flag
// the entries are the code they were.
//
// A pair is a row of x1, x2 (B, N, kDim) and mask (B, N); rows beyond a pair's
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

// The residual of one row: (u1, v1, u2, v2) for image points, the two rays
// for bearing rows.
template <class Model>
__device__ __forceinline__ float row_residual(const float* m, const float* a, const float* b) {
  if constexpr (Model::kDim == 2)
    return Model::residual(m, a[0], a[1], b[0], b[1]);
  else
    return Model::residual(m, a, b);
}

template <class Model>
__device__ __forceinline__ void load_row(const float* x, long long i, float* out) {
#pragma unroll
  for (int d = 0; d < Model::kDim; ++d) out[d] = x[Model::kDim * i + d];
}

// Model::kLaneSolve, false where the model does not set it.
template <class Model, class = void>
struct LaneSolve {
  static constexpr bool value = false;
};
template <class Model>
struct LaneSolve<Model, decltype(void(Model::kLaneSolve))> {
  static constexpr bool value = Model::kLaneSolve;
};

template <class Model, int WARPS, bool MSAC>
__global__ void two_view_propose_score_kernel(int n, int k, float max_sq,
                                              const float* __restrict__ max_sq_arr,
                                              const float* __restrict__ x1,
                                              const float* __restrict__ x2,
                                              const unsigned char* __restrict__ mask,
                                              const int* __restrict__ samples,
                                              const unsigned char* __restrict__ active,
                                              float* __restrict__ models_out,
                                              int* __restrict__ counts_out,
                                              unsigned long long* __restrict__ best,
                                              float* __restrict__ scores_out) {
  constexpr int S = Model::kSolutions, M = Model::kSample, D = Model::kDim;
  __shared__ float models[WARPS][S * 9];
  const int pair = blockIdx.y;
  if (active != nullptr && !active[pair]) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sample = blockIdx.x * WARPS + warp;
  if constexpr (LaneSolve<Model>::value) {
    // Lanes 0..WARPS-1 of warp 0 solve the block's samples, one each.
    const int mine = blockIdx.x * WARPS + lane;
    if (warp == 0 && lane < WARPS && mine < k) {
      float s1[D * M], s2[D * M];
      const int* rows = samples + ((size_t)pair * k + mine) * M;
      for (int r = 0; r < M; ++r) {
        load_row<Model>(x1 + (size_t)pair * n * D, rows[r], s1 + D * r);
        load_row<Model>(x2 + (size_t)pair * n * D, rows[r], s2 + D * r);
      }
      Model::solve(s1, s2, models[lane]);
    }
    __syncthreads();
  }
  if (sample >= k) return;  // whole warps leave together
  x1 += (size_t)pair * n * D;
  x2 += (size_t)pair * n * D;
  mask += (size_t)pair * n;
  if (max_sq_arr != nullptr) max_sq = max_sq_arr[pair];
  if constexpr (!LaneSolve<Model>::value) {
    if (lane == 0) {
      float s1[D * M], s2[D * M];
      const int* rows = samples + ((size_t)pair * k + sample) * M;
      for (int r = 0; r < M; ++r) {
        load_row<Model>(x1, rows[r], s1 + D * r);
        load_row<Model>(x2, rows[r], s2 + D * r);
      }
      Model::solve(s1, s2, models[warp]);
    }
  }
  __syncwarp();
  bool finite[S];
  int cnt[S];
  float sc[S];
  for (int r = 0; r < S; ++r) {
    finite[r] = all_finite(models[warp] + 9 * r, 9);
    cnt[r] = 0;
    sc[r] = 0.f;
  }
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool ok = i < n && mask[i];
    float a[D], b[D];
#pragma unroll
    for (int d = 0; d < D; ++d) a[d] = b[d] = 0.f;
    if (ok) {
      load_row<Model>(x1, i, a);
      load_row<Model>(x2, i, b);
    }
    for (int r = 0; r < S; ++r) {
      if constexpr (MSAC) {
        const float res = ok && finite[r] ? row_residual<Model>(models[warp] + 9 * r, a, b) : 0.f;
        const bool in = ok && finite[r] && res <= max_sq;
        cnt[r] += __popc(__ballot_sync(kFull, in));
        sc[r] += in ? max_sq - res : 0.f;
      } else {
        const bool in =
            ok && finite[r] && row_residual<Model>(models[warp] + 9 * r, a, b) <= max_sq;
        cnt[r] += __popc(__ballot_sync(kFull, in));
      }
    }
  }
  if constexpr (MSAC)
    for (int r = 0; r < S; ++r) sc[r] = warp_sum(sc[r]);
  if (lane < S) {
    int c = 0;
    float score = 0.f;
    for (int r = 0; r < S; ++r) {
      c = r == lane ? cnt[r] : c;
      score = r == lane ? sc[r] : score;
    }
    const int idx = sample * S + lane;
    float* out = models_out + ((size_t)pair * k * S + idx) * 9;
    for (int e = 0; e < 9; ++e) out[e] = models[warp][9 * lane + e];
    counts_out[(size_t)pair * k * S + idx] = c;
    if constexpr (MSAC) {
      scores_out[(size_t)pair * k * S + idx] = score;
      atomicMax(best + pair, pack_best_score(score, idx));
    } else {
      atomicMax(best + pair, pack_best(c, idx));
    }
  }
}

constexpr int kTwoViewRefitThreads = 256;

// FIT_ONLY: fit on the rows of ``mask`` and write the fit as it is (no model
// in, no comparison of supports). MSAC: keep the refit where its score beats
// score_in (or score_arr[pair]) and write the kept score to score_out.
template <class Model, bool FIT_ONLY, bool MSAC>
__global__ void two_view_refit_kernel(int n, float max_sq, const float* __restrict__ max_sq_arr,
                                      int count_in, const int* __restrict__ count_arr,
                                      const float* __restrict__ x1, const float* __restrict__ x2,
                                      const unsigned char* __restrict__ mask,
                                      const float* __restrict__ model_in,
                                      float* __restrict__ model_out, int* __restrict__ count_out,
                                      float score_in, const float* __restrict__ score_arr,
                                      float* __restrict__ score_out) {
  constexpr int D = Model::kDim;
  __shared__ float scratch[32 * 45];
  __shared__ float refined[9];
  __shared__ bool refined_ok;
  const int pair = blockIdx.x;
  x1 += (size_t)pair * n * D;
  x2 += (size_t)pair * n * D;
  mask += (size_t)pair * n;
  if (max_sq_arr != nullptr) max_sq = max_sq_arr[pair];
  if (count_arr != nullptr) count_in = count_arr[pair];
  float m[9];
  for (int e = 0; e < 9; ++e) m[e] = FIT_ONLY ? 0.f : model_in[pair * 9 + e];
  auto fit_row = [&](int i) {
    if (!mask[i]) return false;
    if (FIT_ONLY) return true;
    return row_residual<Model>(m, x1 + D * i, x2 + D * i) <= max_sq;
  };
  Hartley T1{1.f, 0.f, 0.f}, T2{1.f, 0.f, 0.f};
  // The normal matrix over the rows to fit (upper triangle, 45 entries).
  float ata[45];
  for (int q = 0; q < 45; ++q) ata[q] = 0.f;
  if constexpr (Model::kHartley) {
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
    T1 = Hartley{1.f, c[1] / W, c[2] / W};
    T2 = Hartley{1.f, c[3] / W, c[4] / W};
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
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if (!fit_row(i)) continue;
      Model::accumulate((x1[2 * i] - T1.cx) * T1.s, (x1[2 * i + 1] - T1.cy) * T1.s,
                        (x2[2 * i] - T2.cx) * T2.s, (x2[2 * i + 1] - T2.cy) * T2.s, ata);
    }
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if (!fit_row(i)) continue;
      Model::accumulate(x1 + D * i, x2 + D * i, ata);
    }
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
  if constexpr (MSAC) {
    if (score_arr != nullptr) score_in = score_arr[pair];
    float sums[2] = {0.f, 0.f};  // count, score
    if (refined_ok)
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        if (!mask[i]) continue;
        const float res = row_residual<Model>(r, x1 + D * i, x2 + D * i);
        if (res <= max_sq) {
          sums[0] += 1.f;
          sums[1] += max_sq - res;
        }
      }
    block_sum<2>(sums, scratch);
    if (threadIdx.x == 0) {
      const bool take = refined_ok && sums[1] > score_in;
      for (int e = 0; e < 9; ++e) model_out[pair * 9 + e] = take ? r[e] : m[e];
      count_out[pair] = take ? (int)sums[0] : count_in;
      score_out[pair] = take ? sums[1] : score_in;
    }
    return;
  }
  float cnt[1] = {0.f};
  if (refined_ok)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      if (mask[i] && row_residual<Model>(r, x1 + D * i, x2 + D * i) <= max_sq) cnt[0] += 1.f;
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
  inl[row] = mask[row] &&
             row_residual<Model>(m, x1 + Model::kDim * row, x2 + Model::kDim * row) <= max_sq;
}

// Launch the propose-and-score kernel of Model in its default or MSAC mode.
template <class Model, int WARPS>
inline int launch_two_view_propose(int b, int n, int k, float max_sq, const float* max_sq_arr,
                                   const float* x1, const float* x2, const unsigned char* mask,
                                   const int* samples, const unsigned char* active, float* models,
                                   int* counts, unsigned long long* best, int msac, float* scores,
                                   void* stream) {
  if (b == 0 || k == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((k + WARPS - 1) / WARPS), (unsigned)b);
  if (msac)
    two_view_propose_score_kernel<Model, WARPS, true><<<grid, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        n, k, max_sq, max_sq_arr, x1, x2, mask, samples, active, models, counts, best, scores);
  else
    two_view_propose_score_kernel<Model, WARPS, false><<<grid, 32 * WARPS, 0, (cudaStream_t)stream>>>(
        n, k, max_sq, max_sq_arr, x1, x2, mask, samples, active, models, counts, best, scores);
  return (int)cudaGetLastError();
}

// Launch the refit kernel of Model in its default or MSAC mode.
template <class Model>
inline int launch_two_view_refit(int b, int n, float max_sq, const float* max_sq_arr,
                                 int count_in, const int* count_arr, const float* x1,
                                 const float* x2, const unsigned char* mask, const float* model_in,
                                 float* model_out, int* count_out, int msac, float score_in,
                                 const float* score_arr, float* score_out, void* stream) {
  if (b == 0) return (int)cudaGetLastError();
  if (msac)
    two_view_refit_kernel<Model, false, true><<<b, kTwoViewRefitThreads, 0, (cudaStream_t)stream>>>(
        n, max_sq, max_sq_arr, count_in, count_arr, x1, x2, mask, model_in, model_out, count_out,
        score_in, score_arr, score_out);
  else
    two_view_refit_kernel<Model, false, false><<<b, kTwoViewRefitThreads, 0, (cudaStream_t)stream>>>(
        n, max_sq, max_sq_arr, count_in, count_arr, x1, x2, mask, model_in, model_out, count_out,
        0.f, nullptr, nullptr);
  return (int)cudaGetLastError();
}

}  // namespace ctt

// The C entries of a model family NAME over Model (see the header note).
#define CTT_TWO_VIEW_ENTRIES(NAME, Model, WARPS)                                                  \
  extern "C" int NAME##_propose_score_f32(                                                        \
      int b, int n, int k, float max_sq, const float* max_sq_arr, const float* x1,               \
      const float* x2, const unsigned char* mask, const int* samples,                            \
      const unsigned char* active, float* models, int* counts, unsigned long long* best,         \
      int msac, float* scores, void* stream) {                                                   \
    return ctt::launch_two_view_propose<Model, WARPS>(b, n, k, max_sq, max_sq_arr, x1, x2, mask, \
                                                      samples, active, models, counts, best,     \
                                                      msac, scores, stream);                     \
  }                                                                                               \
  extern "C" int NAME##_refit_f32(int b, int n, float max_sq, const float* max_sq_arr,           \
                                  int count_in, const int* count_arr, const float* x1,           \
                                  const float* x2, const unsigned char* mask,                    \
                                  const float* model_in, float* model_out, int* count_out,       \
                                  int msac, float score_in, const float* score_arr,              \
                                  float* score_out, void* stream) {                              \
    return ctt::launch_two_view_refit<Model>(b, n, max_sq, max_sq_arr, count_in, count_arr, x1,  \
                                             x2, mask, model_in, model_out, count_out, msac,     \
                                             score_in, score_arr, score_out, stream);            \
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
