// K48 gen_rel_ransac: the batches of the generalized-relative-pose
// LO-RANSAC, the inlier mask of one model and the weighted refit.
//
// Replaces colmap_tpu/estimators/generalized_pose.py _gen_rel_ransac
// (l.397-452) with the body of optim/ransac.py ransac (propose_and_score),
// the 17-point solver it runs, g17_relative_pose (l.349), and the LO step's
// _weighted_g17 (l.454). Three entries:
//   gen_rel_propose_score: one warp per 17-row sample. Lanes 0-16 each form
//     one row of A (18 coefficients of the generalized epipolar constraint
//     q2' E q1 + q2' R m1 + m2' R q1 = 0 on Plucker rays, float64) in shared
//     memory; the 171 distinct entries of A^T A are summed over the 17 rows
//     in row order, six entries a lane. The smallest eigenvector of A^T A
//     comes from a parallel cyclic Jacobi on the 18 x 18 matrix in shared
//     memory (2.6 KB for the matrix and 2.6 KB for the eigenvectors a warp;
//     324 doubles would not fit one thread's registers): each round
//     rotates the 9 disjoint pairs of a round-robin ordering, lane j < 9
//     computes pair j's rotation (the algebraic rotation and skip rule of
//     small_linalg.cuh jacobi_eigh) and shuffles it to every lane, then
//     lane k < 18 applies the nine rotations to row k of the matrix and of
//     the eigenvectors and to column k of the matrix; 17 rounds a sweep,
//     until a sweep rotates nothing or after kMaxSweeps. The eigenvector's
//     sign is fixed so that the rotation block R_raw has det >= 0 (R_raw ~
//     lam R with lam > 0);
//     colmap_tpu takes eigh's sign as it comes, and with the other sign its
//     projection is not the rotation. Lane 0 then projects R_raw onto SO(3)
//     (gdlt.cuh nearest_rotation), divides E_raw by the mean singular value
//     and takes t from the skew part of E R^T (l.370-382). The warp scores
//     the model on all N rows in float32 in one strided pass, counts
//     inliers with __popc(__ballot_sync), writes the model and its count,
//     and keeps the batch's best with one 64-bit atomicMax on (count,
//     index). A model that is not finite counts 0.
//   gen_rel_inliers: one thread per row, the inlier mask of one model.
//   gen_rel_refit: the weighted 17-point solve over all N rows (the LO
//     refit, weights the inlier mask): blocks of kRefitRows rows write
//     their 171 partial sums, then one warp adds the partials in block
//     order and runs the same Jacobi solve; no float atomics, so two runs
//     agree to the bit. The model (float64) and a finite flag stay on the
//     device.
//
// Residual (_gen_rel_ransac's residual, l.414-441): for each row the
// relative pose of its two observing cameras, cam2_from_cam1 =
// cam2_from_rig2 * rig2_from_rig1 * rig1_from_cam1, E = [t_rel]x R_rel,
// and the Sampson error of (x1, x2) times focal^2. Computed without forming
// R_rel: E x1 = t_rel x (R2 Rm R1^T x1), E^T x2 = R1 Rm^T R2^T (x2 x t_rel),
// t_rel = R2 (Rm c1 + tm) + t2 with c1 = -R1^T t1, the rotations applied as
// quat_rotate. An inlier is a valid row with residual <= max_sq.
//
// Bound on the card: operations. Scoring is about 200 float32 flops a row
// and model; a sample's solve is ~17 x 171 multiply-adds for A^T A and
// ~10 sweeps x 17 rounds x 9 rotations x 54 updates of the Jacobi in
// float64, all on one warp.
#include <cuda_runtime.h>

#include "gdlt.cuh"
#include "sfm_common.cuh"
#include "small_linalg.cuh"

namespace ctt {
namespace grel {

constexpr int kWarps = 4;
constexpr int kSample = 17;
constexpr int kN = 18;                    // unknowns: vec_row(E), vec_row(R)
constexpr int kEntries = kN * (kN + 1) / 2;  // 171 distinct entries of A^T A
constexpr int kModel = 12;                // (3, 4) row-major [R | t]
constexpr int kMaxSweeps = 16;
constexpr int kRefitRows = 256;

struct Rows {
  const double* rays;        // (N, 12): d1, m1, d2, m2
  const float* obs;          // (N, 4): uv1, uv2
  const float* cams;         // (N, 14): q1, t1, q2, t2 (cam_from_rig, wxyz)
  const float* focal;        // (N,)
  const unsigned char* mask;
};

// The 18 coefficients of row r: q2_i q1_j (E), q2_i m1_j + m2_i q1_j (R).
__device__ __forceinline__ void gec_row(const double* ray, double* a) {
  const double *q1 = ray, *m1 = ray + 3, *q2 = ray + 6, *m2 = ray + 9;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      a[3 * i + j] = q2[i] * q1[j];
      a[9 + 3 * i + j] = q2[i] * m1[j] + m2[i] * q1[j];
    }
}

// Entry e of the packed upper triangle (row-major, p <= q).
__device__ __forceinline__ void entry_pq(int e, int* p, int* q) {
  int r = 0;
  while (e >= kN - r) {
    e -= kN - r;
    ++r;
  }
  *p = r;
  *q = r + e;
}

// Pair j of round r of the round-robin ordering of 18 indices: (r, 17) and
// ((r + j) % 17, (r - j) % 17) for j = 1..8; p < q.
__device__ __forceinline__ void round_pair(int r, int j, int* p, int* q) {
  int a, b;
  if (j == 0) {
    a = r;
    b = kN - 1;
  } else {
    a = (r + j) % (kN - 1);
    b = (r - j + kN - 1) % (kN - 1);
  }
  *p = a < b ? a : b;
  *q = a < b ? b : a;
}

// The unit eigenvector of the smallest eigenvalue of the symmetric 18 x 18
// matrix M (shared, row-major, destroyed) into u (shared, 18), by the whole
// warp; V is shared scratch (324 doubles). Each round, lane j < 9 computes
// pair j's rotation in registers and every lane takes the nine by shuffles;
// lane k < 18 then owns row k of M and of V for the column updates and
// column k of M for the row updates, so no two lanes write one entry and
// no index is divided.
__device__ void warp_smallest_eigvec(double* M, double* V, double* u, int lane) {
  constexpr int kPairs = kN / 2;
  for (int i = lane; i < kN * kN; i += 32) V[i] = (i / kN == i % kN) ? 1.0 : 0.0;
  __syncwarp();
  for (int sweep = 0; sweep < kMaxSweeps; ++sweep) {
    bool rotated = false;
    for (int r = 0; r < kN - 1; ++r) {
      int p = 0, q = 1;
      double c = 1.0, s = 0.0;
      bool mine = false;
      if (lane < kPairs) {
        round_pair(r, lane, &p, &q);
        const double apq = M[p * kN + q];
        const double diff = M[q * kN + q] - M[p * kN + p];
        if (!(apq == 0.0 || fabs(apq) * 1e12 < fabs(diff))) {
          const double tau = diff / (2.0 * apq);
          const double t =
              tau == 0.0 ? 1.0 : sgn(tau) / (fabs(tau) + sqrt(1.0 + tau * tau));
          c = rsqrt(1.0 + t * t);
          s = t * c;
          mine = true;
        }
      }
      rotated |= __any_sync(kFull, mine);
      int pp[kPairs], qq[kPairs];
      double cc[kPairs], ss[kPairs];
#pragma unroll
      for (int j = 0; j < kPairs; ++j) {
        pp[j] = __shfl_sync(kFull, p, j);
        qq[j] = __shfl_sync(kFull, q, j);
        cc[j] = __shfl_sync(kFull, c, j);
        ss[j] = __shfl_sync(kFull, s, j);
      }
      __syncwarp();
      if (lane < kN) {  // columns of M and of V: M <- M J, V <- V J
        double* mk = M + lane * kN;
        double* vk = V + lane * kN;
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const double mp = mk[pp[j]], mq = mk[qq[j]];
          mk[pp[j]] = cc[j] * mp - ss[j] * mq;
          mk[qq[j]] = ss[j] * mp + cc[j] * mq;
          const double vp = vk[pp[j]], vq = vk[qq[j]];
          vk[pp[j]] = cc[j] * vp - ss[j] * vq;
          vk[qq[j]] = ss[j] * vp + cc[j] * vq;
        }
      }
      __syncwarp();
      if (lane < kN) {  // rows of M: M <- J^T M
#pragma unroll
        for (int j = 0; j < kPairs; ++j) {
          const double ap = M[pp[j] * kN + lane], aq = M[qq[j] * kN + lane];
          M[pp[j] * kN + lane] = cc[j] * ap - ss[j] * aq;
          M[qq[j] * kN + lane] = ss[j] * ap + cc[j] * aq;
        }
      }
      __syncwarp();
    }
    if (!rotated) break;
  }
  // The smallest diagonal entry (the first on ties, as a stable sort).
  int best = 0;
  for (int i = 1; i < kN; ++i)
    if (M[i * kN + i] < M[best * kN + best]) best = i;
  if (lane < kN) u[lane] = V[lane * kN + best];
  __syncwarp();
}

// The model [R | t] (row-major, double) from the nullspace vector u (l.364-
// 382), its sign fixed by det(R_raw) >= 0.
__device__ void model_from_nullspace(const double* u, double* model) {
  double E[9], Rr[9];
  for (int i = 0; i < 9; ++i) {
    E[i] = u[i];
    Rr[i] = u[9 + i];
  }
  const double det = Rr[0] * (Rr[4] * Rr[8] - Rr[5] * Rr[7]) -
                     Rr[1] * (Rr[3] * Rr[8] - Rr[5] * Rr[6]) +
                     Rr[2] * (Rr[3] * Rr[7] - Rr[4] * Rr[6]);
  if (det < 0.0)
    for (int i = 0; i < 9; ++i) {
      E[i] = -E[i];
      Rr[i] = -Rr[i];
    }
  double R[9], sv[3];
  nearest_rotation(Rr, R, sv);
  // lam = mean(sv) * sign(det(U V^T)); det(U V^T) has the sign of det(R_raw).
  const double lam = (sv[0] + sv[1] + sv[2]) / 3.0 * (det == 0.0 ? 0.0 : 1.0);
  const double div = fabs(lam) < 1e-12 ? 1.0 : lam;
  for (int i = 0; i < 9; ++i) E[i] /= div;
  double T[9];  // E R^T ~ [t]x
  for (int p = 0; p < 3; ++p)
    for (int q = 0; q < 3; ++q)
      T[3 * p + q] = E[3 * p] * R[3 * q] + E[3 * p + 1] * R[3 * q + 1] + E[3 * p + 2] * R[3 * q + 2];
  const double t[3] = {0.5 * (T[7] - T[5]), 0.5 * (T[2] - T[6]), 0.5 * (T[3] - T[1])};
  for (int p = 0; p < 3; ++p) {
    for (int q = 0; q < 3; ++q) model[4 * p + q] = R[3 * p + q];
    model[4 * p + 3] = t[p];
  }
}

// v' = q v q* (quat_rotate; q = wxyz, unit).
__device__ __forceinline__ void qrot(const float* q, const float* v, float* o) {
  const float c0 = q[2] * v[2] - q[3] * v[1], c1 = q[3] * v[0] - q[1] * v[2],
              c2 = q[1] * v[1] - q[2] * v[0];
  o[0] = v[0] + 2.f * (q[0] * c0 + (q[2] * c2 - q[3] * c1));
  o[1] = v[1] + 2.f * (q[0] * c1 + (q[3] * c0 - q[1] * c2));
  o[2] = v[2] + 2.f * (q[0] * c2 + (q[1] * c1 - q[2] * c0));
}

__device__ __forceinline__ void qrot_inv(const float* q, const float* v, float* o) {
  const float qc[4] = {q[0], -q[1], -q[2], -q[3]};
  qrot(qc, v, o);
}

__device__ __forceinline__ void cross(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// Sampson error of row i under model m (float32 [R | t]) times focal^2.
__device__ __forceinline__ float residual(const Rows& in, const float* m, int i) {
  const float* cam = in.cams + 14 * i;
  const float *q1 = cam, *t1 = cam + 4, *q2 = cam + 7, *t2 = cam + 11;
  const float* o = in.obs + 4 * i;
  const float x1[3] = {o[0], o[1], 1.f}, x2[3] = {o[2], o[3], 1.f};
  float b1[3], c1[3], y[3], rx1[3], u[3], tr[3];
  qrot_inv(q1, x1, b1);  // R1^T x1
  qrot_inv(q1, t1, c1);  // -c1
  for (int p = 0; p < 3; ++p) {
    y[p] = m[4 * p] * b1[0] + m[4 * p + 1] * b1[1] + m[4 * p + 2] * b1[2];
    u[p] = -(m[4 * p] * c1[0] + m[4 * p + 1] * c1[1] + m[4 * p + 2] * c1[2]) + m[4 * p + 3];
  }
  qrot(q2, y, rx1);
  qrot(q2, u, tr);
  for (int p = 0; p < 3; ++p) tr[p] += t2[p];
  float ex1[3], w[3], w2[3], w3[3], etx2[3];
  cross(tr, rx1, ex1);
  cross(x2, tr, w);
  qrot_inv(q2, w, w2);
  for (int p = 0; p < 3; ++p) w3[p] = m[p] * w2[0] + m[4 + p] * w2[1] + m[8 + p] * w2[2];
  qrot(q1, w3, etx2);
  const float num = x2[0] * ex1[0] + x2[1] * ex1[1] + ex1[2];
  const float den = ex1[0] * ex1[0] + ex1[1] * ex1[1] + etx2[0] * etx2[0] + etx2[1] * etx2[1];
  const float f = in.focal[i];
  return num * num / fmaxf(den, 1e-12f) * (f * f);
}

__device__ __forceinline__ bool inlier(const Rows& in, const float* m, int i, float max_sq) {
  return in.mask[i] && residual(in, m, i) <= max_sq;
}

struct WarpShared {
  double A[kN * kN];  // the sample's rows, then the eigenvectors V
  double M[kN * kN];
  double u[kN];
  float model[kModel];
  int ok;
};

// M = sum_rows A^T A (17 rows in A) into the full symmetric M.
__device__ void gram17(WarpShared& w, int lane) {
  for (int e = lane; e < kEntries; e += 32) {
    int p, q;
    entry_pq(e, &p, &q);
    double s = 0.0;
    for (int r = 0; r < kSample; ++r) s += w.A[r * kN + p] * w.A[r * kN + q];
    w.M[p * kN + q] = s;
    w.M[q * kN + p] = s;
  }
  __syncwarp();
}

__global__ void __launch_bounds__(32 * kWarps)
propose_score_kernel(int n, int k, float max_sq, Rows in, const int* __restrict__ samples,
                     float* __restrict__ models_out, int* __restrict__ counts_out,
                     unsigned long long* __restrict__ best) {
  __shared__ WarpShared shared[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sample = blockIdx.x * kWarps + warp;
  if (sample >= k) return;  // whole warps leave together
  WarpShared& w = shared[warp];
  if (lane < kSample) {
    const int r = samples[kSample * sample + lane];
    gec_row(in.rays + 12 * r, w.A + lane * kN);
  }
  __syncwarp();
  gram17(w, lane);
  warp_smallest_eigvec(w.M, w.A, w.u, lane);
  if (lane == 0) {
    double md[kModel];
    model_from_nullspace(w.u, md);
    for (int i = 0; i < kModel; ++i) w.model[i] = (float)md[i];
    w.ok = all_finite(w.model, kModel);
  }
  __syncwarp();
  float m[kModel];
  for (int i = 0; i < kModel; ++i) m[i] = w.model[i];
  int cnt = 0;
  if (w.ok)
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

// Partial sums of w_r a_r a_r^T over the block's kRefitRows rows: the rows'
// coefficients in shared memory, then one thread an entry, rows in order.
__global__ void __launch_bounds__(kRefitRows)
refit_partial_kernel(int n, const double* __restrict__ rays, const double* __restrict__ weights,
                     double* __restrict__ partial) {
  __shared__ double a[kRefitRows * kN];
  __shared__ double wt[kRefitRows];
  const int r0 = blockIdx.x * kRefitRows, r = r0 + threadIdx.x;
  if (r < n) {
    gec_row(rays + 12 * r, a + threadIdx.x * kN);
    wt[threadIdx.x] = weights[r];
  } else {
    for (int j = 0; j < kN; ++j) a[threadIdx.x * kN + j] = 0.0;
    wt[threadIdx.x] = 0.0;
  }
  __syncthreads();
  const int rows = min(kRefitRows, n - r0);
  if (threadIdx.x < kEntries) {
    int p, q;
    entry_pq(threadIdx.x, &p, &q);
    double s = 0.0;
    for (int i = 0; i < rows; ++i) s += wt[i] * a[i * kN + p] * a[i * kN + q];
    partial[blockIdx.x * kEntries + threadIdx.x] = s;
  }
}

__global__ void __launch_bounds__(32)
refit_solve_kernel(int blocks, const double* __restrict__ partial, double* __restrict__ model,
                   unsigned char* __restrict__ ok_out) {
  __shared__ WarpShared w;
  const int lane = threadIdx.x;
  for (int e = lane; e < kEntries; e += 32) {
    int p, q;
    entry_pq(e, &p, &q);
    double s = 0.0;
    for (int b = 0; b < blocks; ++b) s += partial[b * kEntries + e];
    w.M[p * kN + q] = s;
    w.M[q * kN + p] = s;
  }
  __syncwarp();
  warp_smallest_eigvec(w.M, w.A, w.u, lane);
  if (lane == 0) {
    double md[kModel];
    model_from_nullspace(w.u, md);
    bool good = true;
    for (int i = 0; i < kModel; ++i) good = good && isfinite(md[i]);
    for (int i = 0; i < kModel; ++i) model[i] = good ? md[i] : NAN;
    *ok_out = good ? 1 : 0;
  }
}

}  // namespace grel
}  // namespace ctt

// n rows: rays (n, 12) double (d1, m1, d2, m2 in their rig frames), obs
// (n, 4) float (uv1, uv2 normalized), cams (n, 14) float (q1, t1, q2, t2:
// each row's cam_from_rig), focal (n), mask (n); samples (k, 17). Writes
// models (k, 3, 4), counts (k) and the packed best (atomicMax; zeroed by the
// caller).
extern "C" int gen_rel_propose_score_f32(int n, int k, float max_sq, const double* rays,
                                         const float* obs, const float* cams, const float* focal,
                                         const unsigned char* mask, const int* samples,
                                         float* models, int* counts, unsigned long long* best,
                                         cudaStream_t stream) {
  using namespace ctt::grel;
  const Rows in{rays, obs, cams, focal, mask};
  if (k > 0)
    propose_score_kernel<<<(k + kWarps - 1) / kWarps, 32 * kWarps, 0, stream>>>(
        n, k, max_sq, in, samples, models, counts, best);
  return (int)cudaGetLastError();
}

extern "C" int gen_rel_inliers_f32(int n, float max_sq, const float* obs, const float* cams,
                                   const float* focal, const unsigned char* mask,
                                   const float* model, unsigned char* inl, cudaStream_t stream) {
  using namespace ctt::grel;
  const Rows in{nullptr, obs, cams, focal, mask};
  if (n > 0) inliers_kernel<<<(n + 255) / 256, 256, 0, stream>>>(n, max_sq, in, model, inl);
  return (int)cudaGetLastError();
}

// n rows: rays (n, 12), weights (n), double; partial (ceil(n / 256), 171)
// scratch. Writes model (3, 4) double (NaN where not finite) and ok (one
// byte).
extern "C" int gen_rel_refit_f64(int n, const double* rays, const double* weights,
                                 double* partial, double* model, unsigned char* ok,
                                 cudaStream_t stream) {
  using namespace ctt::grel;
  const int blocks = (n + kRefitRows - 1) / kRefitRows;
  if (blocks > 0)
    refit_partial_kernel<<<blocks, kRefitRows, 0, stream>>>(n, rays, weights, partial);
  refit_solve_kernel<<<1, 32, 0, stream>>>(blocks, partial, model, ok);
  return (int)cudaGetLastError();
}
