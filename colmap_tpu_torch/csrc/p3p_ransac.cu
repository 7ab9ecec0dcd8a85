// K6 p3p_ransac: the batches and the refit of the P3P LO-RANSAC.
//
// Replaces colmap_tpu/estimators/pose.py _p3p_ransac (l.31) with the body
// of optim/ransac.py ransac (l.78: propose_and_score, _try_refine) and the
// solvers it runs: estimators/solvers/p3p.py p3p (l.42) and kabsch (l.18),
// optim/polynomial.py solve_quartic (l.72).
//
// Three entries:
//   p3p_propose_score: one warp per minimal sample. Lane 0 forms Grunert's
//     quartic and solves it by Ferrari; lanes 0-3 each turn one root into a
//     pose with a 3-point Kabsch (Jacobi on H^T H, small_linalg.cuh). The
//     warp then scores the four poses on all N rows in one strided pass,
//     counts inliers with __popc(__ballot_sync), writes every model and its
//     count, and keeps the batch's best with one 64-bit atomicMax on
//     (count, index). A non-finite pose counts 0.
//   p3p_refit: one block. The LO step of colmap_tpu: the inliers of the
//     given pose, the observed rays scaled to the pose's depths, a weighted
//     Kabsch of the world points onto them (moments reduced over the block,
//     two passes), the refit's inliers; the refit is kept if it has more.
//   p3p_inliers: one thread per row, the inlier mask of one pose.
//
// Residual (pose.py residual): Xc = R X + t; inf if z < 1e-8, else
// |Xc.xy / z - uv|^2; an inlier is a valid row with residual <= max_sq.
//
// Bound on the card: the scoring pass, K * 4 residuals over N rows (about
// 20 flops each) against reading X, uv and the mask (21 B a row) once per
// sample from L2. At the mapper's sizes (N of a few hundred, K = 64) a batch
// is a few microseconds of work and the launch and the host's read of the
// packed best dominate: the host loop over batches (optim/ransac.py) is
// where the host holds the card back. The design keeps all of a batch in
// one launch and one 8-byte read.
#include <cfloat>
#include <cuda_runtime.h>

#include "sfm_common.cuh"
#include "small_linalg.cuh"

namespace ctt {

constexpr int kP3PWarps = 4;

// Real roots of a x^2 + b x + c (polynomial.py solve_quadratic).
__device__ void solve_quadratic(float a, float b, float c, float* r, bool* m) {
  const float disc = b * b - 4.f * a * c;
  const bool ok = disc >= 0.f;
  const float sq = sqrtf(fmaxf(disc, 0.f));
  const float q = -0.5f * (b + sgnf(b) * sq);
  const bool lin = fabsf(a) < 1e-30f;
  const float r1 = q / (lin ? 1.f : a);
  const float r2 = c / (fabsf(q) < 1e-30f ? 1.f : q);
  const float r_lin = -c / (fabsf(b) < 1e-30f ? 1.f : b);
  r[0] = lin ? r_lin : r1;
  r[1] = lin ? r_lin : r2;
  m[0] = ok || lin;
  m[1] = ok && !lin;
}

// Real roots of a x^4 + b x^3 + c x^2 + d x + e by Ferrari (solve_quartic).
__device__ void solve_quartic(float a, float b, float c, float d, float e, float* roots,
                              bool* mask) {
  const float sa = fabsf(a) < 1e-30f ? 1.f : a;
  const float b_ = b / sa, c_ = c / sa, d_ = d / sa, e_ = e / sa;
  const float p = c_ - 3.f * b_ * b_ / 8.f;
  const float q = d_ - b_ * c_ / 2.f + b_ * b_ * b_ / 8.f;
  const float r = e_ - b_ * d_ / 4.f + b_ * b_ * c_ / 16.f - 3.f * b_ * b_ * b_ * b_ / 256.f;
  const float shift = -b_ / 4.f;
  float mr[3];
  bool mm[3];
  solve_cubic_monic(2.f * p, p * p - 4.f * r, -q * q, mr, mm);
  float m = -INFINITY;
  for (int k = 0; k < 3; ++k)
    if (mm[k]) m = fmaxf(m, mr[k]);
  const bool m_pos = m > 1e-12f;
  const float sqm = sqrtf(fmaxf(m, 0.f));
  const float half = (p + m) / 2.f;
  const float qterm = q / (2.f * (sqm < 1e-30f ? 1.f : sqm));
  float r1[2], r2[2], z[2];
  bool m1[2], m2[2], zm[2];
  solve_quadratic(1.f, sqm, half - qterm, r1, m1);
  solve_quadratic(1.f, -sqm, half + qterm, r2, m2);
  solve_quadratic(1.f, p, r, z, zm);
  const bool use_biq = fabsf(q) < 1e-12f || !m_pos;
  for (int k = 0; k < 2; ++k) {
    const bool z_ok = zm[k] && z[k] >= 0.f;
    const float sz = sqrtf(fmaxf(z[k], 0.f));
    roots[k] = (use_biq ? sz : r1[k]) + shift;
    roots[k + 2] = (use_biq ? -sz : r2[k]) + shift;
    mask[k] = use_biq ? z_ok : m1[k];
    mask[k + 2] = use_biq ? z_ok : m2[k];
  }
}

// Weighted Kabsch: (R, t) with dst ~ R src + t from the weighted centroids
// and the cross-covariance H = sum w src0 dst0^T.
__device__ void kabsch_from_moments(const float* H, const float* src_c, const float* dst_c,
                                    float* model) {
  float R[9];
  kabsch_rotation(H, R);
  for (int i = 0; i < 3; ++i) {
    model[i * 4 + 0] = R[i * 3 + 0];
    model[i * 4 + 1] = R[i * 3 + 1];
    model[i * 4 + 2] = R[i * 3 + 2];
    model[i * 4 + 3] =
        dst_c[i] - (R[i * 3] * src_c[0] + R[i * 3 + 1] * src_c[1] + R[i * 3 + 2] * src_c[2]);
  }
}

// Pose for one quartic root v (p3p.py pose_for_root); NaN when invalid.
__device__ void pose_for_root(const float* X, const float* f, float v, bool ok, float ac_b,
                              float cos_a, float cos_b, float cos_g, float b2, float* model) {
  const float denom_u = 2.f * (cos_g - v * cos_a);
  const float u = ((-1.f + ac_b) * v * v - 2.f * ac_b * cos_b * v + 1.f + ac_b) /
                  (fabsf(denom_u) < 1e-12f ? 1.f : denom_u);
  const float s1_den = 1.f + v * v - 2.f * v * cos_b;
  const float s1 = sqrtf(b2 / fmaxf(s1_den, 1e-30f));
  ok = ok && v > 0.f && u > 0.f && s1_den > 1e-30f && fabsf(denom_u) >= 1e-12f;
  const float s[3] = {s1, u * s1, v * s1};
  float Y[9], src_c[3] = {0.f, 0.f, 0.f}, dst_c[3] = {0.f, 0.f, 0.f};
  for (int k = 0; k < 3; ++k)
    for (int i = 0; i < 3; ++i) {
      Y[k * 3 + i] = s[k] * f[k * 3 + i];
      src_c[i] += X[k * 3 + i] / 3.f;
      dst_c[i] += Y[k * 3 + i] / 3.f;
    }
  float H[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float h = 0.f;
      for (int k = 0; k < 3; ++k) h += (X[k * 3 + i] - src_c[i]) * (Y[k * 3 + j] - dst_c[j]);
      H[i * 3 + j] = h;
    }
  kabsch_from_moments(H, src_c, dst_c, model);
  if (!ok)
    for (int i = 0; i < 12; ++i) model[i] = NAN;
}

__device__ __forceinline__ bool p3p_inlier(const float* m, const float* X, const float* uv,
                                           float max_sq) {
  const float x = m[0] * X[0] + m[1] * X[1] + m[2] * X[2] + m[3];
  const float y = m[4] * X[0] + m[5] * X[1] + m[6] * X[2] + m[7];
  const float z = m[8] * X[0] + m[9] * X[1] + m[10] * X[2] + m[11];
  if (z < 1e-8f) return false;
  const float ex = x / z - uv[0], ey = y / z - uv[1];
  return ex * ex + ey * ey <= max_sq;
}

__global__ void p3p_propose_score_kernel(int n, int k, float max_sq, const float* __restrict__ X,
                                         const float* __restrict__ rays,
                                         const float* __restrict__ uv,
                                         const unsigned char* __restrict__ mask,
                                         const int* __restrict__ samples,
                                         float* __restrict__ models_out,
                                         int* __restrict__ counts_out,
                                         unsigned long long* __restrict__ best) {
  __shared__ float models[kP3PWarps][4][12];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sample = blockIdx.x * kP3PWarps + warp;
  if (sample >= k) return;  // whole warps leave together
  float Xs[9], f[9];
  for (int j = 0; j < 3; ++j) {
    const int row = samples[sample * 3 + j];
    for (int i = 0; i < 3; ++i) {
      Xs[j * 3 + i] = X[row * 3 + i];
      f[j * 3 + i] = rays[row * 3 + i];
    }
  }
  const float* X1 = Xs;
  const float* X2 = Xs + 3;
  const float* X3 = Xs + 6;
  auto d2 = [](const float* a, const float* b) {
    return (a[0] - b[0]) * (a[0] - b[0]) + (a[1] - b[1]) * (a[1] - b[1]) +
           (a[2] - b[2]) * (a[2] - b[2]);
  };
  auto dot = [](const float* a, const float* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; };
  const float a2 = d2(X2, X3), b2 = d2(X1, X3), c2 = d2(X1, X2);
  const float cos_a = dot(f + 3, f + 6), cos_b = dot(f, f + 6), cos_g = dot(f, f + 3);
  const float b2s = fmaxf(b2, 1e-30f);
  const float ac_b = (a2 - c2) / b2s, apc_b = (a2 + c2) / b2s;
  float root = 0.f;
  bool root_ok = false;
  if (lane == 0) {
    const float A4 = (ac_b - 1.f) * (ac_b - 1.f) - 4.f * (c2 / b2s) * cos_a * cos_a;
    const float A3 = 4.f * (ac_b * (1.f - ac_b) * cos_b - (1.f - apc_b) * cos_a * cos_g +
                            2.f * (c2 / b2s) * cos_a * cos_a * cos_b);
    const float A2 = 2.f * (ac_b * ac_b - 1.f + 2.f * ac_b * ac_b * cos_b * cos_b +
                            2.f * ((b2 - c2) / b2s) * cos_a * cos_a -
                            4.f * apc_b * cos_a * cos_b * cos_g +
                            2.f * ((b2 - a2) / b2s) * cos_g * cos_g);
    const float A1 = 4.f * (-ac_b * (1.f + ac_b) * cos_b + 2.f * (a2 / b2s) * cos_g * cos_g * cos_b -
                            (1.f - apc_b) * cos_a * cos_g);
    const float A0 = (1.f + ac_b) * (1.f + ac_b) - 4.f * (a2 / b2s) * cos_g * cos_g;
    float roots[4];
    bool mask4[4];
    solve_quartic(A4, A3, A2, A1, A0, roots, mask4);
    // Hand root r to lane r.
    for (int r = 1; r < 4; ++r) {
      models[warp][r][0] = roots[r];
      models[warp][r][1] = mask4[r] ? 1.f : 0.f;
    }
    root = roots[0];
    root_ok = mask4[0];
  }
  __syncwarp();
  if (lane > 0 && lane < 4) {
    root = models[warp][lane][0];
    root_ok = models[warp][lane][1] != 0.f;
  }
  __syncwarp();
  if (lane < 4) {
    float m[12];
    pose_for_root(Xs, f, root, root_ok, ac_b, cos_a, cos_b, cos_g, b2, m);
    for (int i = 0; i < 12; ++i) models[warp][lane][i] = m[i];
  }
  __syncwarp();
  bool finite[4];
  for (int r = 0; r < 4; ++r) finite[r] = all_finite(models[warp][r], 12);
  int cnt[4] = {0, 0, 0, 0};
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    bool in[4] = {false, false, false, false};
    if (i < n && mask[i]) {
      const float Xi[3] = {X[3 * i], X[3 * i + 1], X[3 * i + 2]};
      const float uvi[2] = {uv[2 * i], uv[2 * i + 1]};
      for (int r = 0; r < 4; ++r) in[r] = p3p_inlier(models[warp][r], Xi, uvi, max_sq);
    }
    for (int r = 0; r < 4; ++r) cnt[r] += __popc(__ballot_sync(kFull, in[r]));
  }
  if (lane < 4) {
    const int idx = sample * 4 + lane;
    const int c = finite[lane] ? cnt[lane] : 0;
    for (int i = 0; i < 12; ++i) models_out[idx * 12 + i] = models[warp][lane][i];
    counts_out[idx] = c;
    atomicMax(best, pack_best(c, idx));
  }
}

constexpr int kRefitThreads = 256;

__global__ void p3p_refit_kernel(int n, float max_sq, int count_in, const float* __restrict__ X,
                                 const float* __restrict__ uv,
                                 const unsigned char* __restrict__ mask,
                                 const float* __restrict__ model_in, float* __restrict__ model_out,
                                 int* __restrict__ count_out) {
  __shared__ float scratch[32 * 9];
  __shared__ float refined[12];
  __shared__ bool refined_ok;
  float m[12];
  for (int i = 0; i < 12; ++i) m[i] = model_in[i];
  // Pass 1: weights (inliers of the given pose), targets and centroids.
  float mom[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // W, sum w X, sum w T
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float Xi[3] = {X[3 * i], X[3 * i + 1], X[3 * i + 2]};
    const float uvi[2] = {uv[2 * i], uv[2 * i + 1]};
    if (!(mask[i] && p3p_inlier(m, Xi, uvi, max_sq))) continue;
    const float depth =
        fmaxf(m[8] * Xi[0] + m[9] * Xi[1] + m[10] * Xi[2] + m[11], 1e-6f);
    const float T[3] = {uvi[0] * depth, uvi[1] * depth, depth};
    mom[0] += 1.f;
    for (int j = 0; j < 3; ++j) {
      mom[1 + j] += Xi[j];
      mom[4 + j] += T[j];
    }
  }
  block_sum<7>(mom, scratch);
  const float wsum = fmaxf(mom[0], 1e-30f);
  const float src_c[3] = {mom[1] / wsum, mom[2] / wsum, mom[3] / wsum};
  const float dst_c[3] = {mom[4] / wsum, mom[5] / wsum, mom[6] / wsum};
  // Pass 2: the cross-covariance about the centroids.
  float H[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float Xi[3] = {X[3 * i], X[3 * i + 1], X[3 * i + 2]};
    const float uvi[2] = {uv[2 * i], uv[2 * i + 1]};
    if (!(mask[i] && p3p_inlier(m, Xi, uvi, max_sq))) continue;
    const float depth =
        fmaxf(m[8] * Xi[0] + m[9] * Xi[1] + m[10] * Xi[2] + m[11], 1e-6f);
    const float T[3] = {uvi[0] * depth, uvi[1] * depth, depth};
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) H[a * 3 + b] += (Xi[a] - src_c[a]) * (T[b] - dst_c[b]);
  }
  block_sum<9>(H, scratch);
  if (threadIdx.x == 0) {
    kabsch_from_moments(H, src_c, dst_c, refined);
    refined_ok = all_finite(refined, 12);
  }
  __syncthreads();
  float r[12];
  for (int i = 0; i < 12; ++i) r[i] = refined[i];
  // Pass 3: the refit's support.
  float cnt[1] = {0.f};
  if (refined_ok)
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const float Xi[3] = {X[3 * i], X[3 * i + 1], X[3 * i + 2]};
      const float uvi[2] = {uv[2 * i], uv[2 * i + 1]};
      if (mask[i] && p3p_inlier(r, Xi, uvi, max_sq)) cnt[0] += 1.f;
    }
  block_sum<1>(cnt, scratch);
  if (threadIdx.x == 0) {
    const int count_r = (int)cnt[0];
    const bool take = refined_ok && count_r > count_in;
    for (int i = 0; i < 12; ++i) model_out[i] = take ? r[i] : m[i];
    count_out[0] = take ? count_r : count_in;
  }
}

__global__ void p3p_inliers_kernel(int n, float max_sq, const float* __restrict__ X,
                                   const float* __restrict__ uv,
                                   const unsigned char* __restrict__ mask,
                                   const float* __restrict__ model, unsigned char* __restrict__ inl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float m[12];
  for (int j = 0; j < 12; ++j) m[j] = model[j];
  const float Xi[3] = {X[3 * i], X[3 * i + 1], X[3 * i + 2]};
  const float uvi[2] = {uv[2 * i], uv[2 * i + 1]};
  inl[i] = mask[i] && p3p_inlier(m, Xi, uvi, max_sq);
}

}  // namespace ctt

extern "C" int p3p_propose_score_f32(int n, int k, float max_sq, const float* X, const float* rays,
                                     const float* uv, const unsigned char* mask,
                                     const int* samples, float* models, int* counts,
                                     unsigned long long* best, void* stream) {
  using namespace ctt;
  const unsigned blocks = (unsigned)((k + kP3PWarps - 1) / kP3PWarps);
  p3p_propose_score_kernel<<<blocks, 32 * kP3PWarps, 0, (cudaStream_t)stream>>>(
      n, k, max_sq, X, rays, uv, mask, samples, models, counts, best);
  return (int)cudaGetLastError();
}

extern "C" int p3p_refit_f32(int n, float max_sq, int count_in, const float* X, const float* uv,
                             const unsigned char* mask, const float* model_in, float* model_out,
                             int* count_out, void* stream) {
  using namespace ctt;
  p3p_refit_kernel<<<1, kRefitThreads, 0, (cudaStream_t)stream>>>(n, max_sq, count_in, X, uv, mask,
                                                                  model_in, model_out, count_out);
  return (int)cudaGetLastError();
}

extern "C" int p3p_inliers_f32(int n, float max_sq, const float* X, const float* uv,
                               const unsigned char* mask, const float* model, unsigned char* inl,
                               void* stream) {
  using namespace ctt;
  if (n == 0) return (int)cudaGetLastError();
  p3p_inliers_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(n, max_sq, X, uv, mask,
                                                                       model, inl);
  return (int)cudaGetLastError();
}
