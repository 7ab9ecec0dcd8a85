// K40 gen_abs_refine: rig registration's pose refinement and its LO refit
// in float64, each in one launch of one block.
//
// Replaces colmap_tpu/estimators/generalized_pose.py
// refine_generalized_absolute_pose (l.262-345) and the weighted gdlt_pose
// (l.54-109) of the LO step and of the final refit over every inlier. Two
// entries:
//   gen_abs_refine_f64  the whole LM loop: for up to num_iterations, each
//     row's residual f ((Xc.xy / max(Xc.z, 1e-8)) - uv) through its
//     cam_from_rig, with Xc = cam_q (R(q) X + t) + cam_t (quat_rotate's
//     formula), and its analytic 2 x 6 Jacobian at delta = 0: the rotation
//     update normalize(1, delta/2) (x) q has derivative (0, I/2), so
//     d(R X)/d delta_rot = -[R X]x and d/d delta_t = I, and where the depth
//     is clamped its derivative is 0, as the reference's max; Cauchy x
//     inlier weights sqrt(1 / (1 + e^2 / s^2)) sqrt(w_in) on both
//     coordinates; H = Jw^T Jw, g = Jw^T rw and the cost as fixed-order block
//     sums; lane 0 solves (H + lam diag(diag H + 1e-12)) step = -g by
//     Gaussian elimination with partial pivoting; every row's candidate
//     residual and weight give the new cost; lane 0 accepts (q, t, lam x
//     0.3 floored at 1e-10, the 1e-12 relative early stop) or rejects (lam
//     x 10 capped at 1e8). The host reads q and t once, after the launch.
//   gen_abs_refit_f64  the weighted gDLT: the 12 x 12 normal equations
//     (78 lower-triangle entries), their right-hand side and sum w D^T D as
//     fixed-order block sums over the rows, lane 0's rotation step
//     (gdlt.cuh, K27's), a second pass for sum w D^T D (c - s R X), lane 0's
//     3 x 3 Cholesky for t; the model [R | t | s e1] and a 1-byte flag (the
//     solves succeeded and the model is finite) stay on the device.
//
// Block sums: each thread sums its rows (strided) in order, a fixed
// shuffle tree per warp, then the warps in order: no atomics, so two runs
// agree to the bit.
//
// Bound on the card: neither. At ~2000 rows a refinement iteration is
// ~2000 x ~300 float64 operations (about 20 ns of the card's float64 rate),
// and one block's serial steps (28 block sums, lane 0's 6 x 6 solve, the
// candidate pass) take microseconds; 30 iterations in one launch replace
// 30 x (jacfwd's torch ops, two host reads).
#include <cuda_runtime.h>

#include "gdlt.cuh"
#include "small_linalg.cuh"

namespace ctt {
namespace gref {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Sums NV doubles per thread over the block into out (shared, NV doubles),
// visible to every thread on return. scratch holds kWarps * NV doubles.
template <int NV>
__device__ void block_sums(const double* v, double* scratch, double* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < NV; ++k) {
    double x = v[k];
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
    if (lane == 0) scratch[warp * NV + k] = x;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < NV; k += blockDim.x) {
    double s = 0.0;
    for (int w = 0; w < kWarps; ++w) s += scratch[w * NV + k];
    out[k] = s;
  }
  __syncthreads();
}

// quat_rotate (geometry/rotation.py): v + 2 (w (u x v) + u x (u x v)).
__device__ __forceinline__ void qrot(const double* q, const double* v, double* out) {
  const double c0 = q[2] * v[2] - q[3] * v[1], c1 = q[3] * v[0] - q[1] * v[2],
               c2 = q[1] * v[1] - q[2] * v[0];
  const double d0 = q[2] * c2 - q[3] * c1, d1 = q[3] * c0 - q[1] * c2, d2 = q[1] * c1 - q[2] * c0;
  out[0] = v[0] + 2.0 * (q[0] * c0 + d0);
  out[1] = v[1] + 2.0 * (q[0] * c1 + d1);
  out[2] = v[2] + 2.0 * (q[0] * c2 + d2);
}

__device__ __forceinline__ void qmul(const double* a, const double* b, double* out) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// q' = normalize(1, delta/2) (x) q, t' = t + delta[3:].
__device__ __forceinline__ void perturb(const double* delta, const double* q, const double* t,
                                        double* qo, double* to) {
  double dq[4] = {1.0, 0.5 * delta[0], 0.5 * delta[1], 0.5 * delta[2]};
  const double nq = sqrt(dq[0] * dq[0] + dq[1] * dq[1] + dq[2] * dq[2] + dq[3] * dq[3]);
  for (int k = 0; k < 4; ++k) dq[k] /= nq;
  qmul(dq, q, qo);
  for (int k = 0; k < 3; ++k) to[k] = t[k] + delta[3 + k];
}

struct Rows {
  const double *X, *uv, *cam_q, *cam_t, *focal, *w_in;
};

// Row i's residual r (2) at (q, t), its weight, and with J non-null its
// Jacobian (2 x 6, row-major) at delta = 0. Returns the weighted squared
// residual (r w)^2.
__device__ __forceinline__ double row_terms(const Rows& in, int i, const double* q,
                                            const double* t, double inv_s2, double* r,
                                            double* wt, double* J) {
  const double X[3] = {in.X[3 * i], in.X[3 * i + 1], in.X[3 * i + 2]};
  const double* cq = in.cam_q + 4 * i;
  double Y[3], Xr[3], Xc[3];
  qrot(q, X, Y);
  for (int k = 0; k < 3; ++k) Xr[k] = Y[k] + t[k];
  qrot(cq, Xr, Xc);
  for (int k = 0; k < 3; ++k) Xc[k] += in.cam_t[3 * i + k];
  const bool clamped = !(Xc[2] > 1e-8);
  const double z = clamped ? 1e-8 : Xc[2];
  const double f = in.focal[i];
  const double u = Xc[0] / z, v = Xc[1] / z;
  r[0] = (u - in.uv[2 * i]) * f;
  r[1] = (v - in.uv[2 * i + 1]) * f;
  const double e2 = r[0] * r[0] + r[1] * r[1];
  const double w = 1.0 / (1.0 + e2 * inv_s2);
  *wt = sqrt(w) * sqrt(in.w_in[i]);
  if (J != nullptr) {
    // dXr / d delta: rotation columns -[Y]x, translation columns I; then
    // through cam_from_rig's rotation (quat_rotate is linear in v).
    for (int c = 0; c < 6; ++c) {
      double col[3];
      if (c < 3) {
        const double e[3] = {c == 0 ? 1.0 : 0.0, c == 1 ? 1.0 : 0.0, c == 2 ? 1.0 : 0.0};
        // e x Y = -[Y]x e
        col[0] = e[1] * Y[2] - e[2] * Y[1];
        col[1] = e[2] * Y[0] - e[0] * Y[2];
        col[2] = e[0] * Y[1] - e[1] * Y[0];
      } else {
        col[0] = c == 3 ? 1.0 : 0.0;
        col[1] = c == 4 ? 1.0 : 0.0;
        col[2] = c == 5 ? 1.0 : 0.0;
      }
      double dc[3];
      qrot(cq, col, dc);
      const double dz = clamped ? 0.0 : dc[2];
      J[c] = f * (dc[0] - u * dz) / z;
      J[6 + c] = f * (dc[1] - v * dz) / z;
    }
  }
  const double a = r[0] * *wt, b = r[1] * *wt;
  return a * a + b * b;
}

// Solves A x = b (6 x 6, row-major) in place by Gaussian elimination with
// partial pivoting; b holds x on return.
__device__ void solve6(double* A, double* b) {
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    for (int r = c + 1; r < 6; ++r)
      if (fabs(A[r * 6 + c]) > fabs(A[piv * 6 + c])) piv = r;
    if (piv != c) {
      for (int k = 0; k < 6; ++k) {
        const double tmp = A[c * 6 + k];
        A[c * 6 + k] = A[piv * 6 + k];
        A[piv * 6 + k] = tmp;
      }
      const double tmp = b[c];
      b[c] = b[piv];
      b[piv] = tmp;
    }
    for (int r = c + 1; r < 6; ++r) {
      const double f = A[r * 6 + c] / A[c * 6 + c];
      for (int k = c; k < 6; ++k) A[r * 6 + k] -= f * A[c * 6 + k];
      b[r] -= f * b[c];
    }
  }
  for (int r = 5; r >= 0; --r) {
    double s = b[r];
    for (int k = r + 1; k < 6; ++k) s -= A[r * 6 + k] * b[k];
    b[r] = s / A[r * 6 + r];
  }
}

constexpr int kNormal = 28;  // H's 21 lower-triangle entries, g (6), the cost

__global__ void __launch_bounds__(kThreads)
refine_kernel(int n, int iterations, double loss_scale, Rows in, const double* __restrict__ q0,
              const double* __restrict__ t0, double* __restrict__ q_out,
              double* __restrict__ t_out) {
  __shared__ double scratch[kWarps * kNormal];
  __shared__ double sums[kNormal], new_cost[1];
  __shared__ double q[4], t[3], qc[4], tc[3];
  __shared__ double lam, prev_cost;
  __shared__ int have_prev, stop;
  const double inv_s2 = 1.0 / (loss_scale * loss_scale);
  if (threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) q[k] = q0[k];
    for (int k = 0; k < 3; ++k) t[k] = t0[k];
    lam = 1e-4;
    prev_cost = 0.0;
    have_prev = 0;
    stop = 0;
  }
  __syncthreads();
  for (int it = 0; it < iterations; ++it) {
    double acc[kNormal];
    for (int k = 0; k < kNormal; ++k) acc[k] = 0.0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      double r[2], wt, J[12];
      row_terms(in, i, q, t, inv_s2, r, &wt, J);
      for (int a = 0; a < 2; ++a) {
        const double rw = r[a] * wt;
        double jw[6];
        for (int c = 0; c < 6; ++c) jw[c] = J[6 * a + c] * wt;
        int k = 0;
        for (int p = 0; p < 6; ++p)
          for (int c = 0; c <= p; ++c) acc[k++] += jw[p] * jw[c];
        for (int p = 0; p < 6; ++p) acc[21 + p] += jw[p] * rw;
        acc[27] += rw * rw;
      }
    }
    block_sums<kNormal>(acc, scratch, sums);
    if (threadIdx.x == 0) {
      double A[36], b[6];
      int k = 0;
      for (int p = 0; p < 6; ++p)
        for (int c = 0; c <= p; ++c) {
          A[6 * p + c] = sums[k];
          A[6 * c + p] = sums[k];
          ++k;
        }
      for (int p = 0; p < 6; ++p) {
        A[7 * p] += lam * (A[7 * p] + 1e-12);
        b[p] = -sums[21 + p];
      }
      solve6(A, b);
      perturb(b, q, t, qc, tc);
    }
    __syncthreads();
    double nc = 0.0;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      double r[2], wt;
      nc += row_terms(in, i, qc, tc, inv_s2, r, &wt, nullptr);
    }
    block_sums<1>(&nc, scratch, new_cost);
    if (threadIdx.x == 0) {
      const double cost = sums[27], ncost = new_cost[0];
      if (ncost < cost) {
        for (int k = 0; k < 4; ++k) q[k] = qc[k];
        for (int k = 0; k < 3; ++k) t[k] = tc[k];
        lam = fmax(lam * 0.3, 1e-10);
        if (have_prev && fabs(prev_cost - ncost) < 1e-12 * fmax(prev_cost, 1.0)) stop = 1;
        prev_cost = ncost;
        have_prev = 1;
      } else {
        lam = fmin(lam * 10.0, 1e8);
      }
    }
    __syncthreads();
    if (stop) break;
  }
  if (threadIdx.x == 0) {
    for (int k = 0; k < 4; ++k) q_out[k] = q[k];
    for (int k = 0; k < 3; ++k) t_out[k] = t[k];
  }
}

constexpr int kRefitSums = 78 + 12 + 9;  // AtA's lower triangle, Atb, sum w D^T D

// D = [d]x.
__device__ __forceinline__ void skew(const double* d, double* D) {
  D[0] = 0.0;   D[1] = -d[2]; D[2] = d[1];
  D[3] = d[2];  D[4] = 0.0;   D[5] = -d[0];
  D[6] = -d[1]; D[7] = d[0];  D[8] = 0.0;
}

__global__ void __launch_bounds__(kThreads)
refit_kernel(int n, int estimate_scale, const double* __restrict__ X,
             const double* __restrict__ centers, const double* __restrict__ dirs,
             const double* __restrict__ weights, double* __restrict__ model,
             unsigned char* __restrict__ ok_out) {
  __shared__ double scratch[kWarps * kRefitSums];
  __shared__ double sums[kRefitSums], mtb[3];
  __shared__ double R[9], s;
  __shared__ int ok;
  double acc[kRefitSums];
  for (int k = 0; k < kRefitSums; ++k) acc[k] = 0.0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const double w = weights[i];
    const double sw = sqrt(fmax(w, 0.0));
    double D[9];
    skew(dirs + 3 * i, D);
    const double* x = X + 3 * i;
    const double* c = centers + 3 * i;
    for (int j = 0; j < 3; ++j) {
      // Row j of A (sqrt(w)-weighted): D[j, p] X[q] for R[p, q], then D[j, :].
      double a[12];
      for (int p = 0; p < 3; ++p)
        for (int q = 0; q < 3; ++q) a[3 * p + q] = D[3 * j + p] * x[q] * sw;
      double bj = 0.0;
      for (int k = 0; k < 3; ++k) {
        a[9 + k] = D[3 * j + k] * sw;
        bj += D[3 * j + k] * c[k];
      }
      bj *= sw;
      int k = 0;
      for (int p = 0; p < 12; ++p)
        for (int q = 0; q <= p; ++q) acc[k++] += a[p] * a[q];
      for (int p = 0; p < 12; ++p) acc[78 + p] += a[p] * bj;
      for (int p = 0; p < 3; ++p)
        for (int q = 0; q < 3; ++q) acc[90 + 3 * p + q] += w * D[3 * j + p] * D[3 * j + q];
    }
  }
  block_sums<kRefitSums>(acc, scratch, sums);
  if (threadIdx.x == 0) {
    double AtA[144], Atb[12];
    int k = 0;
    for (int p = 0; p < 12; ++p)
      for (int q = 0; q <= p; ++q) AtA[12 * p + q] = sums[k++];
    for (int p = 0; p < 12; ++p) {
      AtA[13 * p] += 1e-10;
      Atb[p] = sums[78 + p];
    }
    double Rl[9], sl;
    ok = gdlt_rotation(AtA, Atb, estimate_scale != 0, Rl, &sl) ? 1 : 0;
    for (int k2 = 0; k2 < 9; ++k2) R[k2] = Rl[k2];
    s = ok ? sl : 1.0;
  }
  __syncthreads();
  // t from sum w D^T D t = sum w D^T D (c - s R X).
  double m[3] = {0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const double w = weights[i];
    double D[9];
    skew(dirs + 3 * i, D);
    const double* x = X + 3 * i;
    double e[3], De[3];
    for (int p = 0; p < 3; ++p)
      e[p] = centers[3 * i + p] - s * (R[3 * p] * x[0] + R[3 * p + 1] * x[1] + R[3 * p + 2] * x[2]);
    for (int p = 0; p < 3; ++p) De[p] = D[3 * p] * e[0] + D[3 * p + 1] * e[1] + D[3 * p + 2] * e[2];
    for (int q = 0; q < 3; ++q) m[q] += w * (D[q] * De[0] + D[3 + q] * De[1] + D[6 + q] * De[2]);
  }
  block_sums<3>(m, scratch, mtb);
  if (threadIdx.x == 0) {
    double MtM[9], tt[3];
    for (int k = 0; k < 9; ++k) MtM[k] = sums[90 + k];
    for (int p = 0; p < 3; ++p) {
      MtM[4 * p] += 1e-10;
      tt[p] = mtb[p];
    }
    bool good = ok && cholesky_solve<3>(MtM, tt);
    double out[15];
    for (int p = 0; p < 3; ++p) {
      for (int q = 0; q < 3; ++q) out[5 * p + q] = R[3 * p + q];
      out[5 * p + 3] = tt[p];
      out[5 * p + 4] = p == 0 ? s : 0.0;
    }
    for (int k = 0; k < 15; ++k) good = good && isfinite(out[k]);
    for (int k = 0; k < 15; ++k) model[k] = good ? out[k] : NAN;
    *ok_out = good ? 1 : 0;
  }
}

}  // namespace gref
}  // namespace ctt

// n rows: X (n, 3), uv (n, 2), cam_q (n, 4), cam_t (n, 3), focal (n), w_in
// (n), all double; q0 (4), t0 (3) the start. Writes q_out (4), t_out (3).
extern "C" int gen_abs_refine_f64(int n, int iterations, double loss_scale, const double* X,
                                  const double* uv, const double* cam_q, const double* cam_t,
                                  const double* focal, const double* w_in, const double* q0,
                                  const double* t0, double* q_out, double* t_out,
                                  cudaStream_t stream) {
  using namespace ctt::gref;
  refine_kernel<<<1, kThreads, 0, stream>>>(n, iterations, loss_scale,
                                            Rows{X, uv, cam_q, cam_t, focal, w_in}, q0, t0,
                                            q_out, t_out);
  return (int)cudaGetLastError();
}

// n rows: X, centers, dirs (n, 3), weights (n), double. Writes model (3, 5)
// [R | t | s e1] (NaN where a solve failed) and ok (one byte).
extern "C" int gen_abs_refit_f64(int n, int estimate_scale, const double* X,
                                 const double* centers, const double* dirs,
                                 const double* weights, double* model, unsigned char* ok,
                                 cudaStream_t stream) {
  using namespace ctt::gref;
  refit_kernel<<<1, kThreads, 0, stream>>>(n, estimate_scale, X, centers, dirs, weights, model,
                                           ok);
  return (int)cudaGetLastError();
}
