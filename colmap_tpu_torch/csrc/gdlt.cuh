// The rotation step of gDLT (colmap_tpu/estimators/generalized_pose.py
// gdlt_pose, l.54-109) in double, shared by K27 (gen_abs_ransac.cu, a
// 6-point sample on one lane) and K40 (gen_abs_refine.cu, the weighted
// refit over every inlier): from the 12 x 12 normal equations of
// d x (R X + t - c) = 0 (lower triangle, 1e-10 I already added) and their
// right-hand side, the Cholesky solve, the raw rotation block's SVD through
// the Jacobi eigenvectors of M^T M, the proper rotation
// u0 v0^T + u1 v1^T + (u0 x u1)(v0 x v1)^T and, when asked, the world scale
// as the mean singular value (else 1). t is re-solved by the caller.
#pragma once

#include <cuda_runtime.h>

#include "small_linalg.cuh"

namespace ctt {

// The proper rotation nearest the 3 x 3 matrix M (row-major): with
// M = U diag(sv) V^T, R = U diag(1, 1, det(U V^T)) V^T, written as
// u0 v0^T + u1 v1^T + (u0 x u1)(v0 x v1)^T from M^T M's Jacobi eigenvectors;
// sv the singular values, largest first. Shared with K48 (gen_rel_ransac.cu),
// which projects the 17-point solve's rotation block.
__device__ inline void nearest_rotation(const double* M, double* R, double* sv) {
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
  for (int p = 0; p < 3; ++p)
    for (int q = 0; q < 3; ++q) R[3 * p + q] = u0[p] * v0[q] + u1[p] * v1[q] + u2[p] * v2[q];
  sv[0] = s0;
  sv[1] = s1;
  sv[2] = s2;
}

// AtA and Atb are destroyed; false where the Cholesky meets a pivot that is
// not positive.
__device__ inline bool gdlt_rotation(double* AtA, double* Atb, bool estimate_scale, double* R,
                                     double* s) {
  if (!cholesky_solve<12>(AtA, Atb)) return false;
  // The raw rotation block M = Atb[0..8] (row-major).
  double sv[3];
  nearest_rotation(Atb, R, sv);
  *s = estimate_scale ? (sv[0] + sv[1] + sv[2]) / 3.0 : 1.0;
  return true;
}

}  // namespace ctt
