// K38 rig_lm_update: the rig LM step's candidate state, its predicted
// decrease, and the accept test with the damping update, on the card; the
// rig counterpart of K35 (ba_lm_update.cu).
//
// Replaces colmap_tpu/estimators/bundle_adjustment_rig.py _apply_update
// (l.319), lm_step's predicted decrease and accept (l.378-399) and the body
// of lm_solve_fused's while_loop (l.409-424). Two entries, two launches each:
//   rig_lm_candidate  one grid over the camera-side rows (F frames, G
//                     sensors, C cameras of the (R, W) step x) and the N
//                     points: frame and sensor rotations
//                     normalize(quat_exp(x[:3]) (x) q), translations plus
//                     x[3:6], camera parameters plus x[:P], points plus dx,
//                     into the candidate buffers; each block's float64 sum of
//                     x g + lam diag x^2 over its rows' W columns and of
//                     dx gx + lam diag_x dx^2 over its points; then one block
//                     sums the block sums in order: pred = 0.5 * total (the
//                     four families of l.378-387 in a fixed two-stage order).
//   rig_lm_accept     one thread: K35's accept rule on the same 9-double
//                     state (lm_common.cuh), then one grid copies the
//                     candidate over the six state tensors where the step was
//                     taken. Once done is set it changes nothing: a rejected
//                     step and every iteration past done leave the state and
//                     the scalars bit for bit as they were.
// The padding columns of x, g and diag (frames and sensors past 6, cameras
// past P) are 0, so summing all W columns gives the reference's sums.
//
// Bound on the card: memory. The candidate pass reads the state, the step
// and the gradient terms ((F + G) 7 + CP + R W 3 + N 12 floats) and writes
// the candidate; the copy moves the state once more.
#include <cuda_runtime.h>

#include "lm_common.cuh"

namespace ctt {
namespace riglm {

struct State {
  float *quat, *t, *squat, *st, *cam, *pts;
};

struct ConstState {
  const float *quat, *t, *squat, *st, *cam, *pts;
};

// Items: R = F + G + C camera-side rows, then N points.
__global__ void candidate_kernel(int F, int G, int C, int P, int W, long long N,
                                 const float* __restrict__ lam_p, ConstState in,
                                 const float* __restrict__ x, const float* __restrict__ dx,
                                 const float* __restrict__ g, const float* __restrict__ gx,
                                 const float* __restrict__ diag,
                                 const float* __restrict__ diag_x, State out,
                                 double* __restrict__ partial) {
  __shared__ double scratch[32];
  const double lam = (double)*lam_p;
  const long long R = (long long)F + G + C, total = R + N;
  double acc = 0.0;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < R) {
      const int r = (int)i;
      const float* d = x + (long long)W * r;
      for (int a = 0; a < W; ++a)
        acc += (double)d[a] * g[(long long)W * r + a] + lam * diag[(long long)W * r + a] * d[a] * d[a];
      if (r < F) {
        quat_exp_update(d, in.quat + 4 * r, out.quat + 4 * r);
        for (int k = 0; k < 3; ++k) out.t[3 * r + k] = in.t[3 * r + k] + d[3 + k];
      } else if (r < F + G) {
        const int s = r - F;
        quat_exp_update(d, in.squat + 4 * s, out.squat + 4 * s);
        for (int k = 0; k < 3; ++k) out.st[3 * s + k] = in.st[3 * s + k] + d[3 + k];
      } else {
        const int c = r - F - G;
        for (int k = 0; k < P; ++k) out.cam[P * c + k] = in.cam[P * c + k] + d[k];
      }
    } else {
      const long long n = i - R;
      for (int k = 0; k < 3; ++k) {
        const float d = dx[3 * n + k];
        acc += (double)d * gx[3 * n + k] + lam * diag_x[3 * n + k] * d * d;
        out.pts[3 * n + k] = in.pts[3 * n + k] + d;
      }
    }
  }
  const double s = block_sum_lm(acc, scratch);
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__global__ void pred_kernel(int blocks, const double* __restrict__ partial,
                            double* __restrict__ pred) {
  __shared__ double scratch[32];
  double acc = 0.0;
  for (int b = threadIdx.x; b < blocks; b += blockDim.x) acc += partial[b];
  const double s = block_sum_lm(acc, scratch);
  if (threadIdx.x == 0) *pred = 0.5 * s;
}

__global__ void accept_kernel(float* __restrict__ lam_p, double* __restrict__ S,
                              const double* __restrict__ new_cost_p,
                              const double* __restrict__ pred_p, double min_lambda,
                              double max_lambda, double function_tolerance,
                              unsigned char* __restrict__ done_flag) {
  lm_accept_scalars(lam_p, S, *new_cost_p, *pred_p, min_lambda, max_lambda, function_tolerance,
                    done_flag);
}

// Items: F frames, G sensors, C*P camera parameters, N points.
__global__ void copy_kernel(int F, int G, int CP, long long N, const double* __restrict__ S,
                            State st, ConstState c) {
  if (S[6] == 0.0) return;
  const long long total = (long long)F + G + CP + N;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < F) {
      for (int k = 0; k < 4; ++k) st.quat[4 * i + k] = c.quat[4 * i + k];
      for (int k = 0; k < 3; ++k) st.t[3 * i + k] = c.t[3 * i + k];
    } else if (i < (long long)F + G) {
      const long long s = i - F;
      for (int k = 0; k < 4; ++k) st.squat[4 * s + k] = c.squat[4 * s + k];
      for (int k = 0; k < 3; ++k) st.st[3 * s + k] = c.st[3 * s + k];
    } else if (i < (long long)F + G + CP) {
      const long long k = i - F - G;
      st.cam[k] = c.cam[k];
    } else {
      const long long n = i - F - G - CP;
      for (int k = 0; k < 3; ++k) st.pts[3 * n + k] = c.pts[3 * n + k];
    }
  }
}

}  // namespace riglm
}  // namespace ctt

// State quat (F, 4), t (F, 3), sensor quat (G, 4), sensor t (G, 3), cam
// (C, P), points (N, 3); the step x (R, W) and dx (N, 3); K25's g, diag (R,
// W), gx, diag_x (N, 3); lam one float. Writes the candidate (same shapes),
// the block sums into partial (at most 2 num_sms doubles) and pred (one
// double).
extern "C" int rig_lm_candidate_f32(int F, int G, int C, int P, int W, long long N,
                                    const float* lam, const float* quat, const float* t,
                                    const float* squat, const float* st, const float* cam,
                                    const float* pts, const float* x, const float* dx,
                                    const float* g, const float* gx, const float* diag,
                                    const float* diag_x, float* quat_o, float* t_o,
                                    float* squat_o, float* st_o, float* cam_o, float* pts_o,
                                    double* partial, double* pred, int num_sms,
                                    cudaStream_t stream) {
  using namespace ctt;
  const int blocks = lm_blocks((long long)F + G + C + N, num_sms);
  riglm::candidate_kernel<<<blocks, kLmThreads, 0, stream>>>(
      F, G, C, P, W, N, lam, riglm::ConstState{quat, t, squat, st, cam, pts}, x, dx, g, gx, diag,
      diag_x, riglm::State{quat_o, t_o, squat_o, st_o, cam_o, pts_o}, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  riglm::pred_kernel<<<1, kLmThreads, 0, stream>>>(blocks, partial, pred);
  return (int)cudaGetLastError();
}

// lam (one float) and S (9 doubles) updated in place; new_cost and pred one
// double each; done_flag one byte. The six state tensors take the candidate
// where the step was accepted.
extern "C" int rig_lm_accept_f32(int F, int G, int CP, long long N, float* lam, double* S,
                                 const double* new_cost, const double* pred, double min_lambda,
                                 double max_lambda, double function_tolerance,
                                 unsigned char* done_flag, float* quat, float* t, float* squat,
                                 float* st, float* cam, float* pts, const float* quat_c,
                                 const float* t_c, const float* squat_c, const float* st_c,
                                 const float* cam_c, const float* pts_c, int num_sms,
                                 cudaStream_t stream) {
  using namespace ctt;
  riglm::accept_kernel<<<1, 1, 0, stream>>>(lam, S, new_cost, pred, min_lambda, max_lambda,
                                            function_tolerance, done_flag);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks = lm_blocks((long long)F + G + CP + N, num_sms);
  riglm::copy_kernel<<<blocks, kLmThreads, 0, stream>>>(
      F, G, CP, N, S, riglm::State{quat, t, squat, st, cam, pts},
      riglm::ConstState{quat_c, t_c, squat_c, st_c, cam_c, pts_c});
  return (int)cudaGetLastError();
}
