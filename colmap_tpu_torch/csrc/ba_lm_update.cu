// K35 ba_lm_update: the LM step's candidate state, its predicted decrease,
// and the accept test with the damping update, on the card.
//
// Replaces colmap_tpu/estimators/bundle_adjustment.py _apply_update (l.435),
// the tail of _lm_step_packed_impl (l.1122-1153: the gain-ratio terms, rho,
// the accept test, Nielsen's damping rule and the selection of the state)
// and the while_loop's test of _lm_solve_fused_packed (l.1195-1199). Two
// entries, two launches each:
//   ba_lm_candidate  one grid over frames, camera parameters and points:
//                    quat' = normalize(exp(dp[:3]) (x) quat), t' = t + dp[3:],
//                    cam' = cam + dc, points' = points + dx into the candidate
//                    buffers, and each block's float64 sum of the predicted
//                    decrease terms g.d + lam diag d^2; then one block sums
//                    the block sums in order: pred = 0.5 * total.
//   ba_lm_accept     one thread: from cost, new_cost (K1's cost mode, a
//                    double), pred, lam, nu, last_cost, the iteration count
//                    and done, the new lam, nu, cost, last_cost, count, done,
//                    accepted and the 1-byte done flag the host reads; then
//                    one grid copies the candidate over the state where the
//                    step was taken.
// Once done is set, ba_lm_accept changes nothing: further iterations leave
// the state, the scalars and the count as they were, bit for bit, so the host
// can run several iterations between two reads of the flag.
//
// Scalar state `S` (double): 0 nu, 1 cost at the current state, 2 last
// accepted cost, 3 iterations taken, 4 done, 5 accepted, 6 take (the copy's
// flag), 7 new_cost, 8 pred. lam is one value of the problem's type (float),
// which K2 and K34 read.
//
// Bound on the card: memory. The candidate pass reads the state, the step
// and the gradient terms (F (4 + 3 + 6 + 6 + 6) + CP 4 + N 12 floats) and
// writes the candidate; the copy moves the state once more. Both are one
// pass; the reduction is two-stage with a fixed order (no float atomics).
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace ctt {

// Items of the candidate and copy passes: F frames, then C*P camera
// parameters, then N points.
__global__ void lm_candidate_kernel(int F, int CP, long long N, const float* __restrict__ lam_p,
                                    const float* __restrict__ quat, const float* __restrict__ t,
                                    const float* __restrict__ cam, const float* __restrict__ pts,
                                    const float* __restrict__ dp, const float* __restrict__ dc,
                                    const float* __restrict__ dx, const float* __restrict__ gp,
                                    const float* __restrict__ gc, const float* __restrict__ gx,
                                    const float* __restrict__ diag_pose,
                                    const float* __restrict__ diag_cam,
                                    const float* __restrict__ diag_pt, float* __restrict__ quat_o,
                                    float* __restrict__ t_o, float* __restrict__ cam_o,
                                    float* __restrict__ pts_o, double* __restrict__ partial) {
  __shared__ double scratch[32];
  const double lam = (double)*lam_p;
  const long long total = (long long)F + CP + N;
  double acc = 0.0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < F) {
      const int f = (int)i;
      const float* d = dp + 6 * f;
      for (int a = 0; a < 6; ++a)
        acc += (double)d[a] * gp[6 * f + a] + lam * diag_pose[6 * f + a] * d[a] * d[a];
      quat_exp_update(d, quat + 4 * f, quat_o + 4 * f);
      for (int k = 0; k < 3; ++k) t_o[3 * f + k] = t[3 * f + k] + d[3 + k];
    } else if (i < (long long)F + CP) {
      const int c = (int)(i - F);
      const float d = dc[c];
      acc += (double)d * gc[c] + lam * diag_cam[c] * d * d;
      cam_o[c] = cam[c] + d;
    } else {
      const long long n = i - F - CP;
      for (int k = 0; k < 3; ++k) {
        const float d = dx[3 * n + k];
        acc += (double)d * gx[3 * n + k] + lam * diag_pt[3 * n + k] * d * d;
        pts_o[3 * n + k] = pts[3 * n + k] + d;
      }
    }
  }
  const double s = block_sum_lm(acc, scratch);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__global__ void lm_pred_kernel(int blocks, const double* __restrict__ partial,
                               double* __restrict__ pred) {
  __shared__ double scratch[32];
  double acc = 0.0;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) acc += partial[b];
  const double s = block_sum_lm(acc, scratch);
  if (threadIdx.x == 0) *pred = 0.5 * s;
}

__global__ void lm_accept_kernel(float* __restrict__ lam_p, double* __restrict__ S,
                                 const double* __restrict__ new_cost_p,
                                 const double* __restrict__ pred_p, double min_lambda,
                                 double max_lambda, double function_tolerance,
                                 unsigned char* __restrict__ done_flag) {
  lm_accept_scalars(lam_p, S, *new_cost_p, *pred_p, min_lambda, max_lambda, function_tolerance,
                    done_flag);
}

__global__ void lm_copy_kernel(int F, int CP, long long N, const double* __restrict__ S,
                               float* __restrict__ quat, float* __restrict__ t,
                               float* __restrict__ cam, float* __restrict__ pts,
                               const float* __restrict__ quat_c, const float* __restrict__ t_c,
                               const float* __restrict__ cam_c, const float* __restrict__ pts_c) {
  if (S[6] == 0.0) return;
  const long long total = (long long)F + CP + N;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < F) {
      for (int k = 0; k < 4; ++k) quat[4 * i + k] = quat_c[4 * i + k];
      for (int k = 0; k < 3; ++k) t[3 * i + k] = t_c[3 * i + k];
    } else if (i < (long long)F + CP) {
      cam[i - F] = cam_c[i - F];
    } else {
      const long long n = i - F - CP;
      for (int k = 0; k < 3; ++k) pts[3 * n + k] = pts_c[3 * n + k];
    }
  }
}

}  // namespace ctt

// State quat (F, 4), t (F, 3), cam (C*P), points (N, 3); the step dp (F, 6),
// dc (C*P), dx (N, 3); K2's gp, gc, gx, diag_pose, diag_cam, diag_pt; lam one
// float. Writes the candidate quat_o, t_o, cam_o, pts_o, the block sums into
// partial (at most 2 num_sms doubles) and pred (one double).
extern "C" int ba_lm_candidate_f32(int F, int CP, long long N, const float* lam,
                                   const float* quat, const float* t, const float* cam,
                                   const float* pts, const float* dp, const float* dc,
                                   const float* dx, const float* gp, const float* gc,
                                   const float* gx, const float* diag_pose,
                                   const float* diag_cam, const float* diag_pt, float* quat_o,
                                   float* t_o, float* cam_o, float* pts_o, double* partial,
                                   double* pred, int num_sms, cudaStream_t stream) {
  const int blocks = ctt::lm_blocks((long long)F + CP + N, num_sms);
  ctt::lm_candidate_kernel<<<blocks, ctt::kLmThreads, 0, stream>>>(
      F, CP, N, lam, quat, t, cam, pts, dp, dc, dx, gp, gc, gx, diag_pose, diag_cam, diag_pt,
      quat_o, t_o, cam_o, pts_o, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ctt::lm_pred_kernel<<<1, ctt::kLmThreads, 0, stream>>>(blocks, partial, pred);
  return (int)cudaGetLastError();
}

// lam (one float) and S (9 doubles) updated in place; new_cost and pred one
// double each; done_flag one byte. The state takes the candidate where the
// step was accepted.
extern "C" int ba_lm_accept_f32(int F, int CP, long long N, float* lam, double* S,
                                const double* new_cost, const double* pred, double min_lambda,
                                double max_lambda, double function_tolerance,
                                unsigned char* done_flag, float* quat, float* t, float* cam,
                                float* pts, const float* quat_c, const float* t_c,
                                const float* cam_c, const float* pts_c, int num_sms,
                                cudaStream_t stream) {
  ctt::lm_accept_kernel<<<1, 1, 0, stream>>>(lam, S, new_cost, pred, min_lambda, max_lambda,
                                             function_tolerance, done_flag);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = ctt::lm_blocks((long long)F + CP + N, num_sms);
  ctt::lm_copy_kernel<<<blocks, ctt::kLmThreads, 0, stream>>>(F, CP, N, S, quat, t, cam, pts,
                                                               quat_c, t_c, cam_c, pts_c);
  return (int)cudaGetLastError();
}
