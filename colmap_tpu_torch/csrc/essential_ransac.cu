// K7 essential_ransac: the batches and the refit of the 5-point LO-RANSAC.
//
// Replaces colmap_tpu/estimators/two_view_geometry.py _ransac_e (l.127) with
// the body of optim/ransac.py ransac (l.78) and what it runs:
// estimators/solvers/epipolar.py essential_five_point (l.259) and
// _essential_five_point_from_constraints (l.282), optim/small_linalg.py
// nullspace_small (l.208), epipolar.py essential_eight_point (l.117) for
// the LO refit, and geometry/essential.py sampson_error (l.141).
//
// Three entries:
//   essential_propose_score: one warp per minimal sample.
//     - Nister's solve of five_point.cuh (shared with K32): lane 0 builds
//       the 5x9 constraint matrix and eliminates, the warp brackets and
//       bisects the roots of the degree-10 polynomial and forms <= 10 E.
//     - The warp scores the 10 models on all N rows by Sampson error in one
//       strided pass (__popc(__ballot_sync)), writes models and counts, and
//       keeps the batch's best with one 64-bit atomicMax on (count, index).
//   essential_refit: one block, the weighted 8-point on the inliers of the
//     given model: Hartley normalization (weighted centroid, then mean
//     distance), A^T A (9x9, 45 block sums), its smallest eigenvector by
//     Jacobi (small_linalg.cuh), denormalization, projection to singular
//     values (1, 1, 0); kept if its support is larger.
//   essential_inliers: one thread per row, the inlier mask of one model.
//
// The pair axis (estimators/two_view_batch.py _verify_block, l.62): every
// entry takes B problems, x1, x2 (B, N, 2), mask (B, N), one max_sq for all
// or one per problem (max_sq_arr), and propose_score an optional ``active``
// byte per problem whose zeros it skips; grids span (sample, problem),
// (problem) and (row, problem). The mapper's one-pair calls are B = 1.
//
// Degenerate samples give NaN models, which score 0.
//
// MSAC (support="m_estimator"): propose_score and refit take an MSAC flag;
// a model's score is then the sum of max(max_sq - r, 0) over its valid
// rows, each lane summing its rows in order and the warp (refit: the block)
// reducing in a fixed tree, packed as (score bits, index) and compared by
// the refit, as in two_view_ransac.cuh. Without it the entries are the code
// they were.
//
// Bound on the card: operations. Per sample the grid costs 1025 x 2
// polynomial evaluations of degree 10 (~40 flops each) and the bisections
// 9 x 24 + 28 x 28 evaluations with a sine and a cosine, about 10^5 flops;
// the scoring 10 x N Sampson errors (~25 flops each). Lane 0's serial
// elimination (a few thousand flops) leaves 31 lanes idle; spreading it
// over the warp is later work, as is fusing the host's batch loop.
#include <cfloat>
#include <cuda_runtime.h>

#include "five_point.cuh"
#include "sfm_common.cuh"
#include "small_linalg.cuh"

namespace ctt {

constexpr int kEWarps = 2;

__device__ __forceinline__ float sampson(const float* E, float u1, float v1, float u2, float v2) {
  const float a = E[0] * u1 + E[1] * v1 + E[2];
  const float b = E[3] * u1 + E[4] * v1 + E[5];
  const float c = E[6] * u1 + E[7] * v1 + E[8];
  const float at = E[0] * u2 + E[3] * v2 + E[6];
  const float bt = E[1] * u2 + E[4] * v2 + E[7];
  const float r = u2 * a + v2 * b + c;
  return r * r / fmaxf(a * a + b * b + at * at + bt * bt, 1e-30f);
}

template <bool MSAC>
__global__ void essential_propose_score_kernel(int n, int k, float max_sq,
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
  __shared__ FivePoint shared[kEWarps];
  const int pair = blockIdx.y;
  if (active != nullptr && !active[pair]) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sample = blockIdx.x * kEWarps + warp;
  if (sample >= k) return;  // whole warps leave together
  x1 += (size_t)pair * n * 2;
  x2 += (size_t)pair * n * 2;
  mask += (size_t)pair * n;
  samples += (size_t)pair * k * 5;
  models_out += (size_t)pair * k * 90;
  counts_out += (size_t)pair * k * 10;
  if (MSAC) scores_out += (size_t)pair * k * 10;
  best += pair;
  if (max_sq_arr != nullptr) max_sq = max_sq_arr[pair];
  FivePoint& S = shared[warp];
  if (lane == 0) {
    float s1[10], s2[10];
    for (int r = 0; r < 5; ++r) {
      const int row = samples[sample * 5 + r];
      s1[2 * r] = x1[2 * row];
      s1[2 * r + 1] = x1[2 * row + 1];
      s2[2 * r] = x2[2 * row];
      s2[2 * r + 1] = x2[2 * row + 1];
    }
    // B = A^T (9 x 5): column r is the constraint row of sample point r.
    float B[9][5];
    for (int r = 0; r < 5; ++r) {
      const float u1 = s1[2 * r], v1 = s1[2 * r + 1], u2 = s2[2 * r], v2 = s2[2 * r + 1];
      const float row[9] = {u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, 1.f};
      for (int c = 0; c < 9; ++c) B[c][r] = row[c];
    }
    five_point_setup(B, S);
  }
  five_point_models(S, lane);
  // Score the 10 models on all rows.
  bool finite[10];
  for (int r = 0; r < 10; ++r) finite[r] = all_finite(S.models[r], 9);
  int cnt[10];
  float sc[10];
  for (int r = 0; r < 10; ++r) {
    cnt[r] = 0;
    sc[r] = 0.f;
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
    for (int r = 0; r < 10; ++r) {
      if constexpr (MSAC) {
        const float res = ok && finite[r] ? sampson(S.models[r], u1, v1, u2, v2) : 0.f;
        const bool in = ok && finite[r] && res <= max_sq;
        cnt[r] += __popc(__ballot_sync(kFull, in));
        sc[r] += in ? max_sq - res : 0.f;
      } else {
        const bool in = ok && finite[r] && sampson(S.models[r], u1, v1, u2, v2) <= max_sq;
        cnt[r] += __popc(__ballot_sync(kFull, in));
      }
    }
  }
  if constexpr (MSAC)
    for (int r = 0; r < 10; ++r) sc[r] = warp_sum(sc[r]);
  if (lane < 10) {
    int c = 0;
    float score = 0.f;
    for (int r = 0; r < 10; ++r) {
      c = r == lane ? cnt[r] : c;
      score = r == lane ? sc[r] : score;
    }
    const int idx = sample * 10 + lane;
    for (int e = 0; e < 9; ++e) models_out[idx * 9 + e] = S.models[lane][e];
    counts_out[idx] = c;
    if constexpr (MSAC) {
      scores_out[idx] = score;
      atomicMax(best, pack_best_score(score, idx));
    } else {
      atomicMax(best, pack_best(c, idx));
    }
  }
}

constexpr int kRefitThreads = 256;

__device__ __forceinline__ bool e_inlier(const float* E, const float* x1, const float* x2,
                                         const unsigned char* mask, int i, float max_sq) {
  return mask[i] && sampson(E, x1[2 * i], x1[2 * i + 1], x2[2 * i], x2[2 * i + 1]) <= max_sq;
}

template <bool MSAC>
__global__ void essential_refit_kernel(int n, float max_sq, const float* __restrict__ max_sq_arr,
                                       int count_in, const int* __restrict__ count_arr,
                                       const float* __restrict__ x1, const float* __restrict__ x2,
                                       const unsigned char* __restrict__ mask,
                                       const float* __restrict__ model_in,
                                       float* __restrict__ model_out, int* __restrict__ count_out,
                                       float score_in, const float* __restrict__ score_arr,
                                       float* __restrict__ score_out) {
  __shared__ float scratch[32 * 45];
  __shared__ float refined[9];
  __shared__ bool refined_ok;
  const int pair = blockIdx.x;
  x1 += (size_t)pair * n * 2;
  x2 += (size_t)pair * n * 2;
  mask += (size_t)pair * n;
  model_in += pair * 9;
  model_out += pair * 9;
  count_out += pair;
  if (max_sq_arr != nullptr) max_sq = max_sq_arr[pair];
  if (count_arr != nullptr) count_in = count_arr[pair];
  float m[9];
  for (int e = 0; e < 9; ++e) m[e] = model_in[e];
  // Hartley normalization of both point sets over the inliers.
  float c[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // W, sum x1, sum x2
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!e_inlier(m, x1, x2, mask, i, max_sq)) continue;
    c[0] += 1.f;
    c[1] += x1[2 * i];
    c[2] += x1[2 * i + 1];
    c[3] += x2[2 * i];
    c[4] += x2[2 * i + 1];
  }
  block_sum<5>(c, scratch);
  const float W = fmaxf(c[0], 1e-30f);
  const float c1x = c[1] / W, c1y = c[2] / W, c2x = c[3] / W, c2y = c[4] / W;
  float d[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!e_inlier(m, x1, x2, mask, i, max_sq)) continue;
    const float a = x1[2 * i] - c1x, b = x1[2 * i + 1] - c1y;
    const float e = x2[2 * i] - c2x, f = x2[2 * i + 1] - c2y;
    d[0] += sqrtf(a * a + b * b);
    d[1] += sqrtf(e * e + f * f);
  }
  block_sum<2>(d, scratch);
  const float s1 = 1.41421356237f / fmaxf(d[0] / W, 1e-30f);
  const float s2 = 1.41421356237f / fmaxf(d[1] / W, 1e-30f);
  // A^T A over the inliers (upper triangle, 45 entries).
  float ata[45];
  for (int q = 0; q < 45; ++q) ata[q] = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!e_inlier(m, x1, x2, mask, i, max_sq)) continue;
    const float u1 = (x1[2 * i] - c1x) * s1, v1 = (x1[2 * i + 1] - c1y) * s1;
    const float u2 = (x2[2 * i] - c2x) * s2, v2 = (x2[2 * i + 1] - c2y) * s2;
    const float a[9] = {u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, 1.f};
    int q = 0;
    for (int r = 0; r < 9; ++r)
      for (int s = r; s < 9; ++s) ata[q++] += a[r] * a[s];
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
    // E = T2^T F T1 with T = [[s, 0, -s cx], [0, s, -s cy], [0, 0, 1]].
    const float T1[9] = {s1, 0.f, -s1 * c1x, 0.f, s1, -s1 * c1y, 0.f, 0.f, 1.f};
    const float T2[9] = {s2, 0.f, -s2 * c2x, 0.f, s2, -s2 * c2y, 0.f, 0.f, 1.f};
    float FT1[9], E[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        FT1[i * 3 + j] = f[i * 3] * T1[j] + f[i * 3 + 1] * T1[3 + j] + f[i * 3 + 2] * T1[6 + j];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        E[i * 3 + j] = T2[i] * FT1[j] + T2[3 + i] * FT1[3 + j] + T2[6 + i] * FT1[6 + j];
    // Singular values (1, 1, 0): E = u0 v0^T + u1 v1^T.
    float u0[3], u1[3], v0[3], v1[3];
    svd3x3_top2(E, u0, u1, v0, v1);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) refined[i * 3 + j] = u0[i] * v0[j] + u1[i] * v1[j];
    refined_ok = all_finite(refined, 9);
  }
  __syncthreads();
  float r[9];
  for (int e = 0; e < 9; ++e) r[e] = refined[e];
  if constexpr (MSAC) {
    if (score_arr != nullptr) score_in = score_arr[pair];
    float sums[2] = {0.f, 0.f};  // count, score
    if (refined_ok)
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        if (!mask[i]) continue;
        const float res = sampson(r, x1[2 * i], x1[2 * i + 1], x2[2 * i], x2[2 * i + 1]);
        if (res <= max_sq) {
          sums[0] += 1.f;
          sums[1] += max_sq - res;
        }
      }
    block_sum<2>(sums, scratch);
    if (threadIdx.x == 0) {
      const bool take = refined_ok && sums[1] > score_in;
      for (int e = 0; e < 9; ++e) model_out[e] = take ? r[e] : m[e];
      count_out[0] = take ? (int)sums[0] : count_in;
      score_out[pair] = take ? sums[1] : score_in;
    }
    return;
  }
  float cnt[1] = {0.f};
  if (refined_ok)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      if (e_inlier(r, x1, x2, mask, i, max_sq)) cnt[0] += 1.f;
  block_sum<1>(cnt, scratch);
  if (threadIdx.x == 0) {
    const int count_r = (int)cnt[0];
    const bool take = refined_ok && count_r > count_in;
    for (int e = 0; e < 9; ++e) model_out[e] = take ? r[e] : m[e];
    count_out[0] = take ? count_r : count_in;
  }
}

__global__ void essential_inliers_kernel(int n, float max_sq, const float* __restrict__ max_sq_arr,
                                         const float* __restrict__ x1,
                                         const float* __restrict__ x2,
                                         const unsigned char* __restrict__ mask,
                                         const float* __restrict__ model,
                                         unsigned char* __restrict__ inl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int pair = blockIdx.y;
  if (i >= n) return;
  if (max_sq_arr != nullptr) max_sq = max_sq_arr[pair];
  float m[9];
  for (int e = 0; e < 9; ++e) m[e] = model[pair * 9 + e];
  const size_t off = (size_t)pair * n;
  inl[off + i] = e_inlier(m, x1 + 2 * off, x2 + 2 * off, mask + off, i, max_sq);
}

}  // namespace ctt

extern "C" int essential_propose_score_f32(int b, int n, int k, float max_sq,
                                           const float* max_sq_arr, const float* x1,
                                           const float* x2, const unsigned char* mask,
                                           const int* samples, const unsigned char* active,
                                           float* models, int* counts, unsigned long long* best,
                                           int msac, float* scores, void* stream) {
  using namespace ctt;
  if (b == 0 || k == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((k + kEWarps - 1) / kEWarps), (unsigned)b);
  if (msac)
    essential_propose_score_kernel<true><<<grid, 32 * kEWarps, 0, (cudaStream_t)stream>>>(
        n, k, max_sq, max_sq_arr, x1, x2, mask, samples, active, models, counts, best, scores);
  else
    essential_propose_score_kernel<false><<<grid, 32 * kEWarps, 0, (cudaStream_t)stream>>>(
        n, k, max_sq, max_sq_arr, x1, x2, mask, samples, active, models, counts, best, scores);
  return (int)cudaGetLastError();
}

extern "C" int essential_refit_f32(int b, int n, float max_sq, const float* max_sq_arr,
                                   int count_in, const int* count_arr, const float* x1,
                                   const float* x2, const unsigned char* mask,
                                   const float* model_in, float* model_out, int* count_out,
                                   int msac, float score_in, const float* score_arr,
                                   float* score_out, void* stream) {
  using namespace ctt;
  if (b == 0) return (int)cudaGetLastError();
  if (msac)
    essential_refit_kernel<true><<<b, kRefitThreads, 0, (cudaStream_t)stream>>>(
        n, max_sq, max_sq_arr, count_in, count_arr, x1, x2, mask, model_in, model_out, count_out,
        score_in, score_arr, score_out);
  else
    essential_refit_kernel<false><<<b, kRefitThreads, 0, (cudaStream_t)stream>>>(
        n, max_sq, max_sq_arr, count_in, count_arr, x1, x2, mask, model_in, model_out, count_out,
        0.f, nullptr, nullptr);
  return (int)cudaGetLastError();
}

extern "C" int essential_inliers_f32(int b, int n, float max_sq, const float* max_sq_arr,
                                     const float* x1, const float* x2, const unsigned char* mask,
                                     const float* model, unsigned char* inl, void* stream) {
  using namespace ctt;
  if (b == 0 || n == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((n + 255) / 256), (unsigned)b);
  essential_inliers_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(n, max_sq, max_sq_arr, x1, x2,
                                                                   mask, model, inl);
  return (int)cudaGetLastError();
}
