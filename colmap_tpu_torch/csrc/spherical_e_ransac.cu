// K32 spherical_e_ransac: the batches and the refit of the essential-matrix
// LO-RANSAC on unit bearing rays (spherical, 360-degree cameras).
//
// Replaces colmap_tpu/estimators/spherical.py _ransac_e_rays (l.84) with the
// body of optim/ransac.py ransac (l.78) and what it runs:
// estimators/solvers/epipolar.py essential_five_point_rays (l.270) over
// _ray_constraint_matrix (l.253), essential_eight_point_rays (l.137, the LO
// refit, no Hartley conditioning) and spherical.py angular_sampson_error
// (l.51).
//
// K7's three entries, on rays (x1, x2 (B, N, 3)) instead of z = 1 points:
//   spherical_e_propose_score: one warp per minimal sample. Lane 0 builds
//     the 5 x 9 constraint rows r2 (x) r1 and the warp runs Nister's solve of
//     five_point.cuh (shared with K7); the warp scores the <= 10 models on
//     all N rows by the angular Sampson error c^2 / (|P1 E^T r2|^2 +
//     |P2 E r1|^2), c = r2^T E r1, P the tangent-plane projectors (one
//     strided pass, __popc(__ballot_sync)), and keeps the pair's best with
//     one 64-bit atomicMax on (count, index).
//   spherical_e_refit: one block per pair, the unconditioned weighted
//     8-point on the inliers of the given model (the 9 x 9 normal matrix of
//     the rows r2 (x) r1, its smallest eigenvector by Jacobi, projection to
//     singular values (1, 1, 0)); kept if its support is larger. It is the
//     refit kernel of two_view_ransac.cuh over the model below.
//   spherical_e_inliers: one thread per row, the inlier mask of one model.
// The pair axis is K7's: B problems, one max_sq per problem or for all, and
// propose_score's ``active`` byte per problem. The MSAC mode of the
// propose-and-score and refit entries is two_view_ransac.cuh's.
//
// Float32 at the thresholds of 360-degree cameras: a 4 px error at 5760 px
// width is 4.4e-3 rad, a squared threshold of 1.9e-5 rad^2. The residual's
// numerator c is a dot product of unit-scale terms whose rounding (~1e-7)
// is 4e-5 of c at that threshold, so c^2 keeps ~1e-4 relative accuracy; no
// term cancels catastrophically.
//
// Bound on the card: operations, as K7: ~10^5 flops a sample in the solve
// (the grid and the bisections) and 10 x N residuals of ~40 flops.
#include <cfloat>
#include <cuda_runtime.h>

#include "five_point.cuh"
#include "sfm_common.cuh"
#include "small_linalg.cuh"
#include "two_view_ransac.cuh"

namespace ctt {

constexpr int kSphereEWarps = 2;

struct EssentialRays {
  static constexpr int kSample = 5, kSolutions = 10;
  static constexpr int kDim = 3;
  static constexpr bool kHartley = false;

  // angular_sampson_error of spherical.py: squared angular distance (rad^2).
  __device__ __forceinline__ static float residual(const float* E, const float* a,
                                                   const float* b) {
    float Ea[3], Etb[3];
    for (int i = 0; i < 3; ++i) {
      Ea[i] = E[3 * i] * a[0] + E[3 * i + 1] * a[1] + E[3 * i + 2] * a[2];
      Etb[i] = E[i] * b[0] + E[3 + i] * b[1] + E[6 + i] * b[2];
    }
    const float c = b[0] * Ea[0] + b[1] * Ea[1] + b[2] * Ea[2];
    const float pb = Ea[0] * b[0] + Ea[1] * b[1] + Ea[2] * b[2];
    const float pa = Etb[0] * a[0] + Etb[1] * a[1] + Etb[2] * a[2];
    float denom = 0.f;
    for (int i = 0; i < 3; ++i) {
      const float t2 = Ea[i] - pb * b[i], t1 = Etb[i] - pa * a[i];
      denom += t1 * t1 + t2 * t2;
    }
    return c * c / fmaxf(denom, 1e-20f);
  }

  __device__ __forceinline__ static void accumulate(const float* a, const float* b, float* ata) {
    float row[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) row[3 * i + j] = b[i] * a[j];
    int q = 0;
    for (int r = 0; r < 9; ++r)
      for (int s = r; s < 9; ++s) ata[q++] += row[r] * row[s];
  }

  // Singular values (1, 1, 0): E = u0 v0^T + u1 v1^T.
  __device__ static void finish(const float* f, const Hartley&, const Hartley&, float* model) {
    float u0[3], u1[3], v0[3], v1[3];
    svd3x3_top2(f, u0, u1, v0, v1);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) model[i * 3 + j] = u0[i] * v0[j] + u1[i] * v1[j];
  }
};

template <bool MSAC>
__global__ void spherical_e_propose_score_kernel(int n, int k, float max_sq,
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
  __shared__ FivePoint shared[kSphereEWarps];
  const int pair = blockIdx.y;
  if (active != nullptr && !active[pair]) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sample = blockIdx.x * kSphereEWarps + warp;
  if (sample >= k) return;  // whole warps leave together
  x1 += (size_t)pair * n * 3;
  x2 += (size_t)pair * n * 3;
  mask += (size_t)pair * n;
  samples += (size_t)pair * k * 5;
  models_out += (size_t)pair * k * 90;
  counts_out += (size_t)pair * k * 10;
  if (MSAC) scores_out += (size_t)pair * k * 10;
  best += pair;
  if (max_sq_arr != nullptr) max_sq = max_sq_arr[pair];
  FivePoint& S = shared[warp];
  if (lane == 0) {
    // B = A^T (9 x 5): column r is r2 (x) r1 of sample ray pair r.
    float B[9][5];
    for (int r = 0; r < 5; ++r) {
      const int row = samples[sample * 5 + r];
      const float* a = x1 + 3 * row;
      const float* b = x2 + 3 * row;
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) B[3 * i + j][r] = b[i] * a[j];
    }
    five_point_setup(B, S);
  }
  five_point_models(S, lane);
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
    float a[3] = {0.f, 0.f, 0.f}, b[3] = {0.f, 0.f, 0.f};
    if (ok)
      for (int d = 0; d < 3; ++d) {
        a[d] = x1[3 * i + d];
        b[d] = x2[3 * i + d];
      }
    for (int r = 0; r < 10; ++r) {
      if constexpr (MSAC) {  // the MSAC mode of two_view_ransac.cuh
        const float res = ok && finite[r] ? EssentialRays::residual(S.models[r], a, b) : 0.f;
        const bool in = ok && finite[r] && res <= max_sq;
        cnt[r] += __popc(__ballot_sync(kFull, in));
        sc[r] += in ? max_sq - res : 0.f;
      } else {
        const bool in = ok && finite[r] && EssentialRays::residual(S.models[r], a, b) <= max_sq;
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

}  // namespace ctt

extern "C" int spherical_e_propose_score_f32(int b, int n, int k, float max_sq,
                                             const float* max_sq_arr, const float* x1,
                                             const float* x2, const unsigned char* mask,
                                             const int* samples, const unsigned char* active,
                                             float* models, int* counts, unsigned long long* best,
                                             int msac, float* scores, void* stream) {
  using namespace ctt;
  if (b == 0 || k == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((k + kSphereEWarps - 1) / kSphereEWarps), (unsigned)b);
  if (msac)
    spherical_e_propose_score_kernel<true><<<grid, 32 * kSphereEWarps, 0, (cudaStream_t)stream>>>(
        n, k, max_sq, max_sq_arr, x1, x2, mask, samples, active, models, counts, best, scores);
  else
    spherical_e_propose_score_kernel<false><<<grid, 32 * kSphereEWarps, 0, (cudaStream_t)stream>>>(
        n, k, max_sq, max_sq_arr, x1, x2, mask, samples, active, models, counts, best, scores);
  return (int)cudaGetLastError();
}

extern "C" int spherical_e_refit_f32(int b, int n, float max_sq, const float* max_sq_arr,
                                     int count_in, const int* count_arr, const float* x1,
                                     const float* x2, const unsigned char* mask,
                                     const float* model_in, float* model_out, int* count_out,
                                     int msac, float score_in, const float* score_arr,
                                     float* score_out, void* stream) {
  return ctt::launch_two_view_refit<ctt::EssentialRays>(b, n, max_sq, max_sq_arr, count_in,
                                                         count_arr, x1, x2, mask, model_in,
                                                         model_out, count_out, msac, score_in,
                                                         score_arr, score_out, stream);
}

extern "C" int spherical_e_inliers_f32(int b, int n, float max_sq, const float* max_sq_arr,
                                       const float* x1, const float* x2,
                                       const unsigned char* mask, const float* model,
                                       unsigned char* inl, void* stream) {
  using namespace ctt;
  if (b == 0 || n == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((n + 255) / 256), (unsigned)b);
  two_view_inliers_kernel<EssentialRays><<<grid, 256, 0, (cudaStream_t)stream>>>(
      n, max_sq, max_sq_arr, x1, x2, mask, model, inl);
  return (int)cudaGetLastError();
}
