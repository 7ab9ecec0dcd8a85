// K36 relative_pose: the relative pose of an essential matrix by cheirality,
// and its Sampson refinement, on a pair axis.
//
// Replaces colmap_tpu/geometry/essential.py pose_from_essential_matrix
// (l.94) with decompose_essential_matrix (l.47), triangulate_point_dlt (l.65)
// and calc_depth, and colmap_tpu/estimators/relative_pose.py
// refine_relative_pose (l.55-109, a jitted lax.scan of 15 LM steps). Two
// entries, one block per problem, points in CSR order (problem k owns rows
// offsets[k] .. offsets[k + 1]):
//   relative_pose_cheirality  thread 0 decomposes E: the eigenvectors of
//     E^T E by Jacobi (small_linalg.cuh), u_i = E v_i / s_i, u2 = u0 x u1,
//     v2 = v0 x v1 (det +1 both), R1 = U W V^T, R2 = U W^T V^T, t = u2; the
//     four candidates (R1, t), (R2, t), (R1, -t), (R2, -t). The threads
//     stride over the rows, triangulate each under every candidate (the 4x4
//     DLT's smallest eigenvector of A^T A by Jacobi, as K8) and count the
//     rows with both depths in (1e-12, 1000 |t|) and the mask set; the block
//     sums the four counts in a fixed order and keeps the first largest
//     (argmax). A second pass writes that candidate's points and mask.
//   relative_pose_refine  15 LM steps on the Sampson error over (R, unit
//     t): per step the residuals sqrt(w) r and their 5-column Jacobian
//     (analytic: dE = [t]x [e_k]x R for the rotation, [b_k]x R for the two
//     tangent directions of t), the 5x5 normal equations and the cost as
//     float64 block sums, then thread 0 solves the damped system (Gaussian
//     elimination, partial pivoting), the block scores the step, and lam
//     goes to lam / 3 or lam * 5 as l.86-102. Returns q, unit t and the
//     weighted RMS of the unweighted residuals.
// The decomposition, the triangulation and the refinement run in float64
// from float32 inputs.
//
// Bound on the card: operations. The cheirality entry runs five 4x4 Jacobi
// solves (~6000 flops each in float64) per row; the refinement ~60 flops a
// row per residual pass, 30 passes. One block per problem keeps every sum
// in one block (no atomics); a pair of a few thousand rows is one SM's
// work, so a launch fills the card only with many problems (the pose
// graph's edges).
#include <cuda_runtime.h>

#include "essential_pose.cuh"
#include "small_linalg.cuh"

namespace ctt {

constexpr int kRelThreads = 256;

__device__ __forceinline__ double dsum_block(double v, double* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < nwarps; ++w) s += scratch[w];
  return s;
}

__global__ void cheirality_kernel(const int* __restrict__ offsets, const float* __restrict__ E_in,
                                  const float* __restrict__ x1, const float* __restrict__ x2,
                                  const unsigned char* __restrict__ mask,
                                  float* __restrict__ R_out, float* __restrict__ t_out,
                                  float* __restrict__ X_out, int* __restrict__ count_out,
                                  unsigned char* __restrict__ ok_out) {
  __shared__ double cand_R[4][9], cand_t[4][3], max_depth;
  __shared__ double scratch[32];
  const int k = blockIdx.x;
  const int lo = offsets[k], hi = offsets[k + 1];
  if (threadIdx.x == 0) {
    double E[9], R1[9], R2[9], t[3];
    for (int i = 0; i < 9; ++i) E[i] = (double)E_in[9 * k + i];
    decompose_essential(E, R1, R2, t);
    for (int c = 0; c < 4; ++c) {
      const double* R = (c % 2 == 0) ? R1 : R2;
      const double sg = c < 2 ? 1.0 : -1.0;
      for (int i = 0; i < 9; ++i) cand_R[c][i] = R[i];
      for (int i = 0; i < 3; ++i) cand_t[c][i] = sg * t[i];
    }
    max_depth = 1000.0 * sqrt(t[0] * t[0] + t[1] * t[1] + t[2] * t[2]);
  }
  __syncthreads();
  double cnt[4] = {0.0, 0.0, 0.0, 0.0};
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    if (!mask[i]) continue;
    const double u1 = x1[2 * i], w1 = x1[2 * i + 1], u2 = x2[2 * i], w2 = x2[2 * i + 1];
    double X[3];
    for (int c = 0; c < 4; ++c)
      if (triangulate_row(cand_R[c], cand_t[c], max_depth, u1, w1, u2, w2, X)) cnt[c] += 1.0;
  }
  int best = 0;
  double best_cnt = -1.0;
  for (int c = 0; c < 4; ++c) {
    const double s = dsum_block(cnt[c], scratch);
    if (s > best_cnt) {
      best_cnt = s;
      best = c;
    }
  }
  if (threadIdx.x == 0) {
    for (int i = 0; i < 9; ++i) R_out[9 * k + i] = (float)cand_R[best][i];
    for (int i = 0; i < 3; ++i) t_out[3 * k + i] = (float)cand_t[best][i];
    count_out[k] = (int)best_cnt;
  }
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    double X[3];
    const bool ok = triangulate_row(cand_R[best], cand_t[best], max_depth, x1[2 * i],
                                    x1[2 * i + 1], x2[2 * i], x2[2 * i + 1], X);
    for (int j = 0; j < 3; ++j) X_out[3 * i + j] = (float)X[j];
    ok_out[i] = ok && mask[i];
  }
}

// Sampson residual of E on one row (relative_pose.py _sampson_residuals) and,
// with dE (5 matrices), its derivatives.
__device__ double sampson_row(const double* E, const double* dE, int nd, double u1, double w1,
                              double u2, double w2, double* J) {
  const double a0 = E[0] * u1 + E[1] * w1 + E[2], a1 = E[3] * u1 + E[4] * w1 + E[5],
               a2 = E[6] * u1 + E[7] * w1 + E[8];
  const double c0 = E[0] * u2 + E[3] * w2 + E[6], c1 = E[1] * u2 + E[4] * w2 + E[7];
  const double n = u2 * a0 + w2 * a1 + a2;
  const double d = a0 * a0 + a1 * a1 + c0 * c0 + c1 * c1;
  const double s = sqrt(fmax(d, 1e-30));
  for (int k = 0; k < nd; ++k) {
    const double* F = dE + 9 * k;
    const double b0 = F[0] * u1 + F[1] * w1 + F[2], b1 = F[3] * u1 + F[4] * w1 + F[5],
                 b2 = F[6] * u1 + F[7] * w1 + F[8];
    const double e0 = F[0] * u2 + F[3] * w2 + F[6], e1 = F[1] * u2 + F[4] * w2 + F[7];
    const double dn = u2 * b0 + w2 * b1 + b2;
    const double dd = 2.0 * (a0 * b0 + a1 * b1 + c0 * e0 + c1 * e1);
    const double ds = d > 1e-30 ? dd / (2.0 * s) : 0.0;
    J[k] = (dn * s - n * ds) / (s * s);
  }
  return n / s;
}

// q' = normalize(normalize([1, delta/2]) (x) q), t' = normalize(t + d3 b1 + d4 b2).
__device__ void apply_delta(const double* delta, const double* q, const double* t,
                            const double* b1, const double* b2, double* qn, double* tn) {
  double dq[4] = {1.0, 0.5 * delta[0], 0.5 * delta[1], 0.5 * delta[2]};
  const double nd = fmax(sqrt(dq[0] * dq[0] + dq[1] * dq[1] + dq[2] * dq[2] + dq[3] * dq[3]),
                         2.2250738585072014e-308);
  for (int i = 0; i < 4; ++i) dq[i] /= nd;
  const double aw = dq[0], ax = dq[1], ay = dq[2], az = dq[3];
  const double bw = q[0], bx = q[1], by = q[2], bz = q[3];
  double p[4] = {aw * bw - ax * bx - ay * by - az * bz, aw * bx + ax * bw + ay * bz - az * by,
                 aw * by - ax * bz + ay * bw + az * bx, aw * bz + ax * by - ay * bx + az * bw};
  const double np_ = fmax(sqrt(p[0] * p[0] + p[1] * p[1] + p[2] * p[2] + p[3] * p[3]),
                          2.2250738585072014e-308);
  for (int i = 0; i < 4; ++i) qn[i] = p[i] / np_;
  double tt[3];
  for (int i = 0; i < 3; ++i) tt[i] = t[i] + delta[3] * b1[i] + delta[4] * b2[i];
  const double nt = fmax(sqrt(tt[0] * tt[0] + tt[1] * tt[1] + tt[2] * tt[2]), 1e-12);
  for (int i = 0; i < 3; ++i) tn[i] = tt[i] / nt;
}

__global__ void refine_kernel(int iterations, const int* __restrict__ offsets,
                              const float* __restrict__ x1, const float* __restrict__ x2,
                              const float* __restrict__ wts, const float* __restrict__ q_in,
                              const float* __restrict__ t_in, float* __restrict__ q_out,
                              float* __restrict__ t_out, float* __restrict__ rms_out) {
  __shared__ double q[4], t[3], E[9], dE[45], En[9], qn[4], tn[3], lam;
  __shared__ double scratch[32];
  __shared__ double sums[21];
  const int k = blockIdx.x;
  const int lo = offsets[k], hi = offsets[k + 1];
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) q[i] = (double)q_in[4 * k + i];
    double tt[3];
    for (int i = 0; i < 3; ++i) tt[i] = (double)t_in[3 * k + i];
    const double nt = fmax(sqrt(tt[0] * tt[0] + tt[1] * tt[1] + tt[2] * tt[2]), 1e-12);
    for (int i = 0; i < 3; ++i) t[i] = tt[i] / nt;
    lam = 1e-4;
  }
  __syncthreads();
  for (int it = 0; it < iterations; ++it) {
    double b1[3], b2[3];
    tangent_basis(t, b1, b2);
    if (threadIdx.x == 0) {
      double R[9], Tx[9], S[9];
      quat_rotmat(q, R);
      skew3(t, Tx);
      matmul3(Tx, R, E);
      for (int a = 0; a < 3; ++a) {
        double e[3] = {0.0, 0.0, 0.0}, Ex[9], ExR[9];
        e[a] = 1.0;
        skew3(e, Ex);
        matmul3(Ex, R, ExR);
        matmul3(Tx, ExR, dE + 9 * a);
      }
      skew3(b1, S);
      matmul3(S, R, dE + 27);
      skew3(b2, S);
      matmul3(S, R, dE + 36);
    }
    __syncthreads();
    double acc[21];
    for (int j = 0; j < 21; ++j) acc[j] = 0.0;
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const double sw = sqrt((double)wts[i]);
      double J[5];
      const double r = sw * sampson_row(E, dE, 5, x1[2 * i], x1[2 * i + 1], x2[2 * i],
                                        x2[2 * i + 1], J);
      int m = 0;
      for (int a = 0; a < 5; ++a) {
        J[a] *= sw;
        for (int b = a; b < 5; ++b) acc[m++] += J[a] * J[b];
      }
      for (int a = 0; a < 5; ++a) acc[15 + a] -= J[a] * r;
      acc[20] += r * r;
    }
    for (int j = 0; j < 21; ++j) {
      const double s = dsum_block(acc[j], scratch);
      if (threadIdx.x == 0) sums[j] = s;
    }
    if (threadIdx.x == 0) {
      double H[25], g[5];
      int m = 0;
      for (int a = 0; a < 5; ++a)
        for (int b = a; b < 5; ++b) {
          H[5 * a + b] = sums[m];
          H[5 * b + a] = sums[m++];
        }
      for (int a = 0; a < 5; ++a) {
        H[6 * a] += lam * H[6 * a] + 1e-12;
        g[a] = sums[15 + a];
      }
      solve5(H, g);
      apply_delta(g, q, t, b1, b2, qn, tn);
      double R[9], Tx[9];
      quat_rotmat(qn, R);
      skew3(tn, Tx);
      matmul3(Tx, R, En);
    }
    __syncthreads();
    double c = 0.0;
    for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
      const double r = sqrt((double)wts[i]) *
                       sampson_row(En, nullptr, 0, x1[2 * i], x1[2 * i + 1], x2[2 * i],
                                   x2[2 * i + 1], nullptr);
      c += r * r;
    }
    const double new_cost = dsum_block(c, scratch);
    if (threadIdx.x == 0) {
      if (new_cost < sums[20]) {
        for (int i = 0; i < 4; ++i) q[i] = qn[i];
        for (int i = 0; i < 3; ++i) t[i] = tn[i];
        lam = fmax(lam / 3.0, 1e-10);
      } else {
        lam = fmin(lam * 5.0, 1e6);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    double R[9], Tx[9];
    quat_rotmat(q, R);
    skew3(t, Tx);
    matmul3(Tx, R, E);
  }
  __syncthreads();
  double wr = 0.0, ws = 0.0;
  for (int i = lo + threadIdx.x; i < hi; i += blockDim.x) {
    const double r = sampson_row(E, nullptr, 0, x1[2 * i], x1[2 * i + 1], x2[2 * i],
                                 x2[2 * i + 1], nullptr);
    wr += (double)wts[i] * r * r;
    ws += (double)wts[i];
  }
  wr = dsum_block(wr, scratch);
  ws = dsum_block(ws, scratch);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) q_out[4 * k + i] = (float)q[i];
    for (int i = 0; i < 3; ++i) t_out[3 * k + i] = (float)t[i];
    rms_out[k] = (float)sqrt(wr / fmax(ws, 1e-12));
  }
}

}  // namespace ctt

// b problems; offsets (b + 1) int32; E (b, 3, 3); x1, x2 (rows, 2); mask
// (rows) bytes. Writes R (b, 3, 3), t (b, 3), count (b), X (rows, 3), ok.
extern "C" int relative_pose_cheirality_f32(int b, const int* offsets, const float* E,
                                            const float* x1, const float* x2,
                                            const unsigned char* mask, float* R, float* t,
                                            float* X, int* count, unsigned char* ok,
                                            cudaStream_t stream) {
  if (b == 0) return (int)cudaGetLastError();
  ctt::cheirality_kernel<<<b, ctt::kRelThreads, 0, stream>>>(offsets, E, x1, x2, mask, R, t, X,
                                                             count, ok);
  return (int)cudaGetLastError();
}

// b candidates; offsets (b + 1) int32; x1, x2 (rows, 2), w (rows); q (b, 4),
// t (b, 3) in. Writes q_out (b, 4), t_out (b, 3), rms (b).
extern "C" int relative_pose_refine_f32(int b, int iterations, const int* offsets,
                                        const float* x1, const float* x2, const float* w,
                                        const float* q, const float* t, float* q_out,
                                        float* t_out, float* rms, cudaStream_t stream) {
  if (b == 0) return (int)cudaGetLastError();
  ctt::refine_kernel<<<b, ctt::kRelThreads, 0, stream>>>(iterations, offsets, x1, x2, w, q, t,
                                                         q_out, t_out, rms);
  return (int)cudaGetLastError();
}
