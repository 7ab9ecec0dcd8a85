// K37 structure_less_ransac: the batches of the 5+1 structure-less
// resectioning RANSAC, and its final inlier mask.
//
// Replaces colmap_tpu/estimators/generalized_pose.py _structure_less_ransac
// (l.552): per sample, five correspondences of one registered camera give
// the essential matrices new camera <- that camera (Nister, five_point.cuh,
// shared with K7 and K32), each one's cheirality on its five points (the
// first of the four decompositions with the most points in front, valid
// with >= 4), and one correspondence of another camera the scale s of the
// translation, linearly from its epipolar constraint (l.615-633); then
// every model cam_from_world = [R_rel Rc | R_rel tc + s t_dir] is scored by
// its generalized Sampson error in pixels, each correspondence against its
// own registered camera (l.640-660).
//
// Two entries:
//   structure_less_score  one warp per sample (the host draws the samples:
//     camera, five indices, scale index). The five-point solve runs in
//     double (FivePointT<double>): lane 0 builds the 5 x 9 constraint rows
//     and eliminates, the warp finds the <= 10 roots and models. In float32
//     the elimination of an ill-conditioned sample missed roots (7 of 42
//     near-best models on the card's check) and moved the others by
//     percents, which the scale from one row amplifies. Lanes 0-9 take one
//     model each through the cheirality of its five points, a float64
//     polish of the pose (4 Newton steps on the five epipolar constraints)
//     and the scale (float64); the warp scores the 10 models on
//     all N rows in one strided pass (__popc(__ballot_sync)), writes models
//     (NaN where a slot holds none) and supports, and keeps the batch's best
//     with one 64-bit atomicMax on (support, 0xFFFFFFFF - index): one
//     8-byte read per batch for the host, as K7.
//   structure_less_inliers  one thread per row: the inlier mask of one model.
//
// Bound on the card: operations. Per sample the five-point solve (~10^5
// float64 operations, K7's count) and 10 x N Sampson errors against per-row cameras (~110
// flops each: the relative pose of the row's camera, E and the residual).
#include <cfloat>
#include <cuda_runtime.h>

#include "essential_pose.cuh"
#include "five_point.cuh"
#include "sfm_common.cuh"
#include "small_linalg.cuh"

namespace ctt {

constexpr int kSlWarps = 2;
// Newton steps that polish each float32 root's pose in float64.
constexpr int kPolishSteps = 4;

// Squared generalized Sampson error in pixels of model M = [R | t] (3 x 4,
// row-major) on row i against its camera (Rw, tw); inf for a NaN model.
__device__ __forceinline__ float sl_residual(const float* M, const float* __restrict__ Rw,
                                             const float* __restrict__ tw, int c, float u1,
                                             float w1, float u2, float w2, float focal) {
  const float* Rc = Rw + 9 * c;
  const float* tc = tw + 3 * c;
  float Rr[9], tr[3];  // R_rel = R Rc^T, t_rel = t - R_rel tc
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b)
      Rr[3 * a + b] = M[4 * a] * Rc[3 * b] + M[4 * a + 1] * Rc[3 * b + 1] + M[4 * a + 2] * Rc[3 * b + 2];
  for (int a = 0; a < 3; ++a)
    tr[a] = M[4 * a + 3] - (Rr[3 * a] * tc[0] + Rr[3 * a + 1] * tc[1] + Rr[3 * a + 2] * tc[2]);
  float E[9];  // [t_rel]x R_rel
  for (int b = 0; b < 3; ++b) {
    E[b] = -tr[2] * Rr[3 + b] + tr[1] * Rr[6 + b];
    E[3 + b] = tr[2] * Rr[b] - tr[0] * Rr[6 + b];
    E[6 + b] = -tr[1] * Rr[b] + tr[0] * Rr[3 + b];
  }
  const float a0 = E[0] * u1 + E[1] * w1 + E[2], a1 = E[3] * u1 + E[4] * w1 + E[5],
              a2 = E[6] * u1 + E[7] * w1 + E[8];
  const float c0 = E[0] * u2 + E[3] * w2 + E[6], c1 = E[1] * u2 + E[4] * w2 + E[7];
  const float n = u2 * a0 + w2 * a1 + a2;
  const float den = a0 * a0 + a1 * a1 + c0 * c0 + c1 * c1;
  return n * n / fmaxf(den, 1e-12f) * focal * focal;
}

// The (R, t) of E's four decompositions with the most of the five points
// in front of both cameras (|t| = 1: depths in (1e-12, 1000)); returns that
// count (generalized_pose.py _poses_from_essentials, float64).
__device__ int five_cheirality(const double* Ef, const double (*xw)[2], const double (*xn)[2],
                               double* R_best, double* t_best) {
  double E[9], R1[9], R2[9], t[3];
  bool finite = true;
  for (int i = 0; i < 9; ++i) finite = finite && isfinite(Ef[i]);
  for (int i = 0; i < 9; ++i) E[i] = finite ? Ef[i] : (i % 4 == 0 ? 1.0 : 0.0);
  decompose_essential(E, R1, R2, t);
  int best_n = -1;
  for (int c = 0; c < 4; ++c) {
    const double* R = (c % 2 == 0) ? R1 : R2;
    const double sg = c < 2 ? 1.0 : -1.0;
    const double tc[3] = {sg * t[0], sg * t[1], sg * t[2]};
    int n = 0;
    for (int p = 0; p < 5; ++p) {
      double X[3];
      if (triangulate_row(R, tc, 1000.0, xw[p][0], xw[p][1], xn[p][0], xn[p][1], X)) ++n;
    }
    if (n > best_n) {
      best_n = n;
      for (int i = 0; i < 9; ++i) R_best[i] = R[i];
      for (int i = 0; i < 3; ++i) t_best[i] = tc[i];
    }
  }
  return finite ? best_n : -1;
}

struct SlShared {
  FivePointT<double> S;
  float models[10][12];
};

__global__ void structure_less_score_kernel(int n, int k, float max_sq,
                                            const float* __restrict__ uv,
                                            const float* __restrict__ uv_w,
                                            const int* __restrict__ cam_idx,
                                            const float* __restrict__ Rw,
                                            const float* __restrict__ tw,
                                            const float* __restrict__ focal,
                                            const int* __restrict__ cams,
                                            const int* __restrict__ idx5,
                                            const int* __restrict__ r1,
                                            float* __restrict__ models_out,
                                            int* __restrict__ counts_out,
                                            unsigned long long* __restrict__ best) {
  __shared__ SlShared shared[kSlWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sample = blockIdx.x * kSlWarps + warp;
  if (sample >= k) return;  // whole warps leave together
  SlShared& W = shared[warp];
  if (lane == 0) {
    // x1 = the registered camera's points, x2 = the new camera's.
    double B[9][5];
    for (int r = 0; r < 5; ++r) {
      const int row = idx5[sample * 5 + r];
      const double u1 = uv_w[2 * row], v1 = uv_w[2 * row + 1], u2 = uv[2 * row],
                   v2 = uv[2 * row + 1];
      const double rw[9] = {u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, 1.0};
      for (int c = 0; c < 9; ++c) B[c][r] = rw[c];
    }
    five_point_setup(B, W.S);
  }
  five_point_models(W.S, lane);
  if (lane < 10) {
    double xw[5][2], xn[5][2], R[9], t[3];
    for (int r = 0; r < 5; ++r) {
      const int row = idx5[sample * 5 + r];
      xw[r][0] = uv_w[2 * row];
      xw[r][1] = uv_w[2 * row + 1];
      xn[r][0] = uv[2 * row];
      xn[r][1] = uv[2 * row + 1];
    }
    const int n_front = five_cheirality(W.S.models[lane], xw, xn, R, t);
    bool ok = n_front >= 4;
    if (ok) polish_pose(xw, xn, R, t, kPolishSteps);
    // cam_from_world(s) = (R, s t) o (Rc, tc): R_new = R Rc, t_base = R tc;
    // against the scale row's camera: R_ns = R_new Rs^T, t_ns = a + s t with
    // a = t_base - R_ns ts, and x2^T [t_ns]x R_ns x1 = 0 is linear in s.
    const int c = cams[sample], rs = r1[sample], cs = cam_idx[rs];
    double Rc[9], tc[3], Rs[9], ts[3];
    for (int i = 0; i < 9; ++i) {
      Rc[i] = Rw[9 * c + i];
      Rs[i] = Rw[9 * cs + i];
    }
    for (int i = 0; i < 3; ++i) {
      tc[i] = tw[3 * c + i];
      ts[i] = tw[3 * cs + i];
    }
    double Rn[9], tb[3], Rns[9], a[3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Rn[3 * i + j] = R[3 * i] * Rc[j] + R[3 * i + 1] * Rc[3 + j] + R[3 * i + 2] * Rc[6 + j];
    for (int i = 0; i < 3; ++i) tb[i] = R[3 * i] * tc[0] + R[3 * i + 1] * tc[1] + R[3 * i + 2] * tc[2];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Rns[3 * i + j] = Rn[3 * i] * Rs[3 * j] + Rn[3 * i + 1] * Rs[3 * j + 1] + Rn[3 * i + 2] * Rs[3 * j + 2];
    for (int i = 0; i < 3; ++i)
      a[i] = tb[i] - (Rns[3 * i] * ts[0] + Rns[3 * i + 1] * ts[1] + Rns[3 * i + 2] * ts[2]);
    const double x1s[3] = {(double)uv_w[2 * rs], (double)uv_w[2 * rs + 1], 1.0};
    const double x2s[3] = {(double)uv[2 * rs], (double)uv[2 * rs + 1], 1.0};
    double Rx1[3];
    for (int i = 0; i < 3; ++i) Rx1[i] = Rns[3 * i] * x1s[0] + Rns[3 * i + 1] * x1s[1] + Rns[3 * i + 2] * x1s[2];
    const double ca[3] = {a[1] * Rx1[2] - a[2] * Rx1[1], a[2] * Rx1[0] - a[0] * Rx1[2],
                          a[0] * Rx1[1] - a[1] * Rx1[0]};
    const double cb[3] = {t[1] * Rx1[2] - t[2] * Rx1[1], t[2] * Rx1[0] - t[0] * Rx1[2],
                          t[0] * Rx1[1] - t[1] * Rx1[0]};
    const double c0 = x2s[0] * ca[0] + x2s[1] * ca[1] + x2s[2] * ca[2];
    const double c1 = x2s[0] * cb[0] + x2s[1] * cb[1] + x2s[2] * cb[2];
    const double s = -c0 / (fabs(c1) < 1e-12 ? 1e-12 : c1);
    ok = ok && fabs(c1) > 1e-10 && s > 1e-8 && cs != c;
    float* m = W.models[lane];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) m[4 * i + j] = ok ? (float)Rn[3 * i + j] : NAN;
      m[4 * i + 3] = ok ? (float)(tb[i] + s * t[i]) : NAN;
    }
  }
  __syncwarp();
  bool finite[10];
  for (int r = 0; r < 10; ++r) finite[r] = all_finite(W.models[r], 12);
  int cnt[10];
  for (int r = 0; r < 10; ++r) cnt[r] = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool valid = i < n;
    float u1 = 0.f, w1 = 0.f, u2 = 0.f, w2 = 0.f, f = 0.f;
    int c = 0;
    if (valid) {
      u1 = uv_w[2 * i];
      w1 = uv_w[2 * i + 1];
      u2 = uv[2 * i];
      w2 = uv[2 * i + 1];
      f = focal[i];
      c = cam_idx[i];
    }
    for (int r = 0; r < 10; ++r) {
      const bool in = valid && finite[r] &&
                      sl_residual(W.models[r], Rw, tw, c, u1, w1, u2, w2, f) <= max_sq;
      cnt[r] += __popc(__ballot_sync(kFull, in));
    }
  }
  if (lane < 10) {
    int cc = 0;
    for (int r = 0; r < 10; ++r) cc = r == lane ? cnt[r] : cc;
    const int idx = sample * 10 + lane;
    for (int e = 0; e < 12; ++e) models_out[idx * 12 + e] = W.models[lane][e];
    counts_out[idx] = cc;
    atomicMax(best, pack_best(cc, idx));
  }
}

__global__ void structure_less_inliers_kernel(int n, float max_sq, const float* __restrict__ uv,
                                              const float* __restrict__ uv_w,
                                              const int* __restrict__ cam_idx,
                                              const float* __restrict__ Rw,
                                              const float* __restrict__ tw,
                                              const float* __restrict__ focal,
                                              const float* __restrict__ model,
                                              unsigned char* __restrict__ inl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float M[12];
  for (int e = 0; e < 12; ++e) M[e] = model[e];
  inl[i] = all_finite(M, 12) && sl_residual(M, Rw, tw, cam_idx[i], uv_w[2 * i], uv_w[2 * i + 1],
                                            uv[2 * i], uv[2 * i + 1], focal[i]) <= max_sq;
}

}  // namespace ctt

// n rows: uv, uv_w (n, 2), cam_idx (n), focal (n); c cameras: Rw (c, 3, 3),
// tw (c, 3); k samples: cams (k), idx5 (k, 5), r1 (k) int32. Writes models
// (k * 10, 3, 4), counts (k * 10) and best (one uint64, zeroed by the caller).
extern "C" int structure_less_score_f32(int n, int k, float max_sq, const float* uv,
                                        const float* uv_w, const int* cam_idx, const float* Rw,
                                        const float* tw, const float* focal, const int* cams,
                                        const int* idx5, const int* r1, float* models,
                                        int* counts, unsigned long long* best,
                                        cudaStream_t stream) {
  using namespace ctt;
  if (k == 0) return (int)cudaGetLastError();
  structure_less_score_kernel<<<(k + kSlWarps - 1) / kSlWarps, 32 * kSlWarps, 0, stream>>>(
      n, k, max_sq, uv, uv_w, cam_idx, Rw, tw, focal, cams, idx5, r1, models, counts, best);
  return (int)cudaGetLastError();
}

// The inlier mask (n bytes) of one model (3, 4).
extern "C" int structure_less_inliers_f32(int n, float max_sq, const float* uv, const float* uv_w,
                                          const int* cam_idx, const float* Rw, const float* tw,
                                          const float* focal, const float* model,
                                          unsigned char* inl, cudaStream_t stream) {
  if (n == 0) return (int)cudaGetLastError();
  ctt::structure_less_inliers_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      n, max_sq, uv, uv_w, cam_idx, Rw, tw, focal, model, inl);
  return (int)cudaGetLastError();
}
