// The LM loop's device-side pieces shared by the packed BA (K35,
// ba_lm_update.cu) and the rig BA (K38, rig_lm_update.cu): a fixed-order
// block sum in double, the rotation update normalize(quat_exp(w) (x) q), and
// the accept rule on the 9-double scalar state (colmap_tpu_torch.kernels.
// solver.LM_FIELDS: 0 nu, 1 cost at the current state, 2 last accepted cost,
// 3 iterations taken, 4 done, 5 accepted, 6 take, 7 new_cost, 8 pred).
#pragma once

#include <cuda_runtime.h>

namespace ctt {

constexpr int kLmThreads = 256;

// Sum of one double per thread over the block; every thread gets the sum.
// Fixed order: shuffle tree, then warp 0..W-1.
__device__ __forceinline__ double block_sum_lm(double v, double* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < nwarps; ++w) s += scratch[w];
  __syncthreads();
  return s;
}

// out = normalize(quat_exp(w) (x) q) (ba_residual.py quat_exp: so(3)
// tangent -> unit quaternion), wxyz.
__device__ __forceinline__ void quat_exp_update(const float* w, const float* q, float* out) {
  const float w0 = w[0], w1 = w[1], w2 = w[2];
  const float th2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float th = sqrtf(th2 + 1e-30f);
  const float half = 0.5f * th;
  const float sinc = th2 > 1e-12f ? sinf(half) / th : 0.5f - th2 / 48.f;
  const float aw = cosf(half), ax = sinc * w0, ay = sinc * w1, az = sinc * w2;
  const float bw = q[0], bx = q[1], by = q[2], bz = q[3];
  const float r[4] = {aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                      aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw};
  const float nrm =
      fmaxf(sqrtf(r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + r[3] * r[3]), 1.17549435e-38f);
  for (int k = 0; k < 4; ++k) out[k] = r[k] / nrm;
}

// One thread: the gain ratio from cost, new_cost and pred, the accept test
// (new_cost < cost and pred > 0), Nielsen's damping rule (shrink
// max(1/3, 1 - (2 rho - 1)^3), lam clipped to [min, max]; a rejected step
// lam * nu, nu doubled), the last accepted cost, the count and the done test
// (accepted with |last - new| / new < function_tolerance, or rejected with
// lam at max_lambda). Once done is set it only clears `take`: a frozen no-op.
__device__ __forceinline__ void lm_accept_scalars(float* lam_p, double* S, double nc, double pred,
                                                  double min_lambda, double max_lambda,
                                                  double function_tolerance,
                                                  unsigned char* done_flag) {
  if (S[4] != 0.0) {  // done: a frozen no-op
    S[6] = 0.0;
    return;
  }
  const double cost = S[1], last = S[2], nu = S[0];
  const double lam = (double)*lam_p;
  const double rho = (cost - nc) / fmax(pred, 1e-30);
  const bool acc = nc < cost && pred > 0.0;
  double new_lam, new_nu;
  if (acc) {
    const double u = 2.0 * rho - 1.0;
    const double shrink = fmax(1.0 / 3.0, 1.0 - u * u * u);
    new_lam = fmin(fmax(lam * shrink, min_lambda), max_lambda);
    new_nu = 2.0;
  } else {
    new_lam = fmin(lam * nu, max_lambda);
    new_nu = nu * 2.0;
  }
  const float lam_f = (float)new_lam;
  const double rel = fabs(last - nc) / fmax(nc, 1e-30);
  const bool done = (acc && rel < function_tolerance) || (!acc && (double)lam_f >= max_lambda);
  *lam_p = lam_f;
  S[0] = new_nu;
  S[1] = acc ? nc : cost;
  S[2] = acc ? nc : last;
  S[3] += 1.0;
  S[4] = done ? 1.0 : 0.0;
  S[5] = acc ? 1.0 : 0.0;
  S[6] = acc ? 1.0 : 0.0;
  S[7] = nc;
  S[8] = pred;
  *done_flag = done ? 1 : 0;
}

inline int lm_blocks(long long total, int num_sms) {
  long long b = (total + kLmThreads - 1) / kLmThreads;
  if (b > 2LL * num_sms) b = 2LL * num_sms;
  return b < 1 ? 1 : (int)b;
}

}  // namespace ctt
