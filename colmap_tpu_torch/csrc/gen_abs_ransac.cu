// K27 gen_abs_ransac: the batches of the generalized-absolute-pose
// LO-RANSAC, and the inlier mask of one model.
//
// Replaces colmap_tpu/estimators/generalized_pose.py _gen_abs_ransac
// (l.112-164) with the body of optim/ransac.py ransac (propose_and_score)
// and the solver it runs, gdlt_pose (l.54-109). The local refit (weighted
// gDLT over the inliers) runs as float64 torch ops on the plain version's
// math and counts its support with this kernel's inlier entry.
//
// Two entries:
//   gen_abs_propose_score: one warp per 6-point sample. Lane 0 runs gDLT in
//     double: the 12 x 12 normal equations of d x (R X + t - c) = 0 (plus
//     1e-10 I) solved by Cholesky, the raw rotation block's SVD through the
//     Jacobi eigenvectors of M^T M, the proper rotation
//     u0 v0^T + u1 v1^T + (u0 x u1)(v0 x v1)^T, the scale as the mean
//     singular value when asked, and t re-solved from
//     sum D^T D t = sum D^T D (c - s R X) (small_linalg.cuh). Double,
//     because with rig baselines short next to the scene the raw block is
//     poorly conditioned in float32, and the first rig registration reads
//     the world scale from its singular values. The warp then scores the
//     model on all N rows in float32 in one strided pass, counts inliers
//     with __popc(__ballot_sync), writes the model and its count, and keeps
//     the batch's best with one 64-bit atomicMax on (count, index). A model
//     that is not finite, or whose solve meets a pivot that is not
//     positive, counts 0.
//   gen_abs_inliers: one thread per row, the inlier mask of one model.
//
// Residual (_gen_abs_ransac's residual): Xc = cam_from_rig (s R X + t);
// inf if z < 1e-8, else |Xc.xy / z - uv|^2 f^2 in pixels; an inlier is a
// valid row with residual <= max_sq.
//
// Bound on the card: the scoring pass, K residuals over N rows (about 40
// flops each) against reading X, uv, cam_from_rig, focal and the mask
// (53 B a row) once per sample from L2; at the mapper's sizes (N of a few
// hundred, K = 64) a batch is a few microseconds of work and lane 0's
// serial double solve, the launch and the host's read of the packed best
// dominate. The design keeps a batch in one launch and one 8-byte read.
#include <cfloat>
#include <cuda_runtime.h>

#include "sfm_common.cuh"
#include "small_linalg.cuh"

namespace ctt {
namespace gabs {

constexpr int kWarps = 4;
constexpr int kSample = 6;
constexpr int kModel = 15;  // (3, 5) row-major [R | t | s e1]

struct Rows {
  const float *X, *centers, *dirs, *uv, *cam_q, *cam_t, *focal;
  const unsigned char* mask;
};

// gdlt_pose on the rows idx[0..5]; false where a solve fails.
__device__ bool gdlt(const Rows& in, const int* idx, bool estimate_scale, float* model) {
  double AtA[144], Atb[12];
  for (int i = 0; i < 144; ++i) AtA[i] = 0.0;
  for (int i = 0; i < 12; ++i) Atb[i] = 0.0;
  double MtM[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
  double D[kSample][3][3], X[kSample][3], c[kSample][3];
  for (int n = 0; n < kSample; ++n) {
    const int r = idx[n];
    const double d[3] = {in.dirs[3 * r], in.dirs[3 * r + 1], in.dirs[3 * r + 2]};
    for (int k = 0; k < 3; ++k) {
      X[n][k] = in.X[3 * r + k];
      c[n][k] = in.centers[3 * r + k];
    }
    // D = [d]x.
    D[n][0][0] = 0.0;   D[n][0][1] = -d[2]; D[n][0][2] = d[1];
    D[n][1][0] = d[2];  D[n][1][1] = 0.0;   D[n][1][2] = -d[0];
    D[n][2][0] = -d[1]; D[n][2][1] = d[0];  D[n][2][2] = 0.0;
    for (int j = 0; j < 3; ++j) {
      double a[12];
      for (int p = 0; p < 3; ++p)
        for (int q = 0; q < 3; ++q) a[3 * p + q] = D[n][j][p] * X[n][q];
      double bj = 0.0;
      for (int k = 0; k < 3; ++k) {
        a[9 + k] = D[n][j][k];
        bj += D[n][j][k] * c[n][k];
      }
      for (int p = 0; p < 12; ++p) {
        Atb[p] += a[p] * bj;
        for (int q = 0; q <= p; ++q) AtA[12 * p + q] += a[p] * a[q];
      }
      for (int p = 0; p < 3; ++p)
        for (int q = 0; q < 3; ++q) MtM[3 * p + q] += D[n][j][p] * D[n][j][q];
    }
  }
  for (int p = 0; p < 12; ++p) AtA[13 * p] += 1e-10;
  if (!cholesky_solve<12>(AtA, Atb)) return false;
  // The raw rotation block M = Atb[0..8] (row-major); M^T M = V diag(s^2) V^T.
  const double* M = Atb;
  double S[9], V[9];
  for (int p = 0; p < 3; ++p)
    for (int q = 0; q < 3; ++q)
      S[3 * p + q] = M[p] * M[q] + M[3 + p] * M[3 + q] + M[6 + p] * M[6 + q];
  jacobi_eigh<3>(S, V, 12);
  const int lo = argmin_diag<3>(S);
  int i0 = lo == 0 ? 1 : 0;
  int i1 = 3 - lo - i0;
  if (S[4 * i1] > S[4 * i0]) {
    const int tmp = i0;
    i0 = i1;
    i1 = tmp;
  }
  const double s0 = sqrt(fmax(S[4 * i0], 0.0)), s1 = sqrt(fmax(S[4 * i1], 0.0)),
               s2 = sqrt(fmax(S[4 * lo], 0.0));
  double v0[3], v1[3], u0[3], u1[3];
  for (int r = 0; r < 3; ++r) {
    v0[r] = V[3 * r + i0];
    v1[r] = V[3 * r + i1];
  }
  for (int r = 0; r < 3; ++r) {
    u0[r] = (M[3 * r] * v0[0] + M[3 * r + 1] * v0[1] + M[3 * r + 2] * v0[2]) / fmax(s0, 1e-300);
    u1[r] = (M[3 * r] * v1[0] + M[3 * r + 1] * v1[1] + M[3 * r + 2] * v1[2]) / fmax(s1, 1e-300);
  }
  const double dd = u0[0] * u1[0] + u0[1] * u1[1] + u0[2] * u1[2];
  for (int r = 0; r < 3; ++r) u1[r] -= dd * u0[r];
  const double nu = fmax(sqrt(u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2]), 1e-300);
  for (int r = 0; r < 3; ++r) u1[r] /= nu;
  const double u2[3] = {u0[1] * u1[2] - u0[2] * u1[1], u0[2] * u1[0] - u0[0] * u1[2],
                        u0[0] * u1[1] - u0[1] * u1[0]};
  const double v2[3] = {v0[1] * v1[2] - v0[2] * v1[1], v0[2] * v1[0] - v0[0] * v1[2],
                        v0[0] * v1[1] - v0[1] * v1[0]};
  double R[9];
  for (int p = 0; p < 3; ++p)
    for (int q = 0; q < 3; ++q) R[3 * p + q] = u0[p] * v0[q] + u1[p] * v1[q] + u2[p] * v2[q];
  const double s = estimate_scale ? (s0 + s1 + s2) / 3.0 : 1.0;
  // t from sum D^T D t = sum D^T D (c - s R X); D^T D = M_n^T M_n summed above.
  double Mtb[3] = {0.0, 0.0, 0.0};
  for (int n = 0; n < kSample; ++n) {
    double e[3];
    for (int p = 0; p < 3; ++p)
      e[p] = c[n][p] - s * (R[3 * p] * X[n][0] + R[3 * p + 1] * X[n][1] + R[3 * p + 2] * X[n][2]);
    double De[3];
    for (int p = 0; p < 3; ++p) De[p] = D[n][p][0] * e[0] + D[n][p][1] * e[1] + D[n][p][2] * e[2];
    for (int q = 0; q < 3; ++q) Mtb[q] += D[n][0][q] * De[0] + D[n][1][q] * De[1] + D[n][2][q] * De[2];
  }
  for (int p = 0; p < 3; ++p) MtM[4 * p] += 1e-10;
  if (!cholesky_solve<3>(MtM, Mtb)) return false;
  for (int p = 0; p < 3; ++p) {
    for (int q = 0; q < 3; ++q) model[5 * p + q] = (float)R[3 * p + q];
    model[5 * p + 3] = (float)Mtb[p];
    model[5 * p + 4] = p == 0 ? (float)s : 0.f;
  }
  return true;
}

// Squared reprojection error in pixels of row i; inf behind the camera.
__device__ __forceinline__ float residual(const Rows& in, const float* m, int i) {
  const float X0 = in.X[3 * i], X1 = in.X[3 * i + 1], X2 = in.X[3 * i + 2];
  const float s = m[4];
  float xr[3];
  for (int p = 0; p < 3; ++p)
    xr[p] = (m[5 * p] * X0 + m[5 * p + 1] * X1 + m[5 * p + 2] * X2) * s + m[5 * p + 3];
  const float* q = in.cam_q + 4 * i;
  // Xc = q xr q* + t, as quat_rotate.
  const float c0 = q[2] * xr[2] - q[3] * xr[1], c1 = q[3] * xr[0] - q[1] * xr[2],
              c2 = q[1] * xr[1] - q[2] * xr[0];
  const float x = xr[0] + 2.f * (q[0] * c0 + (q[2] * c2 - q[3] * c1)) + in.cam_t[3 * i];
  const float y = xr[1] + 2.f * (q[0] * c1 + (q[3] * c0 - q[1] * c2)) + in.cam_t[3 * i + 1];
  const float z = xr[2] + 2.f * (q[0] * c2 + (q[1] * c1 - q[2] * c0)) + in.cam_t[3 * i + 2];
  if (z < 1e-8f) return INFINITY;
  const float ex = x / z - in.uv[2 * i], ey = y / z - in.uv[2 * i + 1];
  const float f = in.focal[i];
  return (ex * ex + ey * ey) * (f * f);
}

__device__ __forceinline__ bool inlier(const Rows& in, const float* m, int i, float max_sq) {
  return in.mask[i] && residual(in, m, i) <= max_sq;
}

__global__ void __launch_bounds__(32 * kWarps)
propose_score_kernel(int n, int k, int estimate_scale, float max_sq, Rows in,
                     const int* __restrict__ samples, float* __restrict__ models_out,
                     int* __restrict__ counts_out, unsigned long long* __restrict__ best) {
  __shared__ float models[kWarps][kModel];
  __shared__ int ok[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sample = blockIdx.x * kWarps + warp;
  if (sample >= k) return;  // whole warps leave together
  if (lane == 0) {
    float m[kModel];
    const bool solved = gdlt(in, samples + kSample * sample, estimate_scale != 0, m);
    for (int i = 0; i < kModel; ++i) models[warp][i] = solved ? m[i] : NAN;
    ok[warp] = solved && all_finite(m, kModel);
  }
  __syncwarp();
  float m[kModel];
  for (int i = 0; i < kModel; ++i) m[i] = models[warp][i];
  int cnt = 0;
  if (ok[warp])
    for (int base = 0; base < n; base += 32) {
      const int i = base + lane;
      cnt += __popc(__ballot_sync(kFull, i < n && inlier(in, m, i, max_sq)));
    }
  if (lane == 0) {
    for (int i = 0; i < kModel; ++i) models_out[kModel * sample + i] = m[i];
    counts_out[sample] = cnt;
    atomicMax(best, pack_best(cnt, sample));
  }
}

__global__ void inliers_kernel(int n, float max_sq, Rows in, const float* __restrict__ model,
                               unsigned char* __restrict__ inl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float m[kModel];
  for (int j = 0; j < kModel; ++j) m[j] = model[j];
  inl[i] = inlier(in, m, i, max_sq);
}

}  // namespace gabs
}  // namespace ctt

extern "C" int gen_abs_propose_score_f32(int n, int k, int estimate_scale, float max_sq,
                                         const float* X, const float* centers, const float* dirs,
                                         const float* uv, const float* cam_q, const float* cam_t,
                                         const float* focal, const unsigned char* mask,
                                         const int* samples, float* models, int* counts,
                                         unsigned long long* best, cudaStream_t stream) {
  using namespace ctt::gabs;
  const Rows in{X, centers, dirs, uv, cam_q, cam_t, focal, mask};
  if (k > 0)
    propose_score_kernel<<<(k + kWarps - 1) / kWarps, 32 * kWarps, 0, stream>>>(
        n, k, estimate_scale, max_sq, in, samples, models, counts, best);
  return (int)cudaGetLastError();
}

extern "C" int gen_abs_inliers_f32(int n, float max_sq, const float* X, const float* uv,
                                   const float* cam_q, const float* cam_t, const float* focal,
                                   const unsigned char* mask, const float* model,
                                   unsigned char* inl, cudaStream_t stream) {
  using namespace ctt::gabs;
  const Rows in{X, nullptr, nullptr, uv, cam_q, cam_t, focal, mask};
  if (n > 0) inliers_kernel<<<(n + 255) / 256, 256, 0, stream>>>(n, max_sq, in, model, inl);
  return (int)cudaGetLastError();
}
