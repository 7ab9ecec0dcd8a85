// The relative pose of an essential matrix, shared by K36
// (relative_pose.cu) and K37 (structure_less_ransac.cu), in float64 for one
// thread: colmap_tpu/geometry/essential.py decompose_essential_matrix
// (l.47) and, per row and candidate, triangulate_point_dlt (l.65) with the
// depth test of pose_from_essential_matrix (l.117-120); the small algebra
// of refine_relative_pose's tangent (relative_pose.py:29-53), a 5x5 solve,
// and the Newton polish of a five-point pose (K37).
#pragma once

#include <cuda_runtime.h>

#include "small_linalg.cuh"

namespace ctt {

__device__ __forceinline__ void cross3d(const double* a, const double* b, double* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// E -> R1, R2 (row-major) and unit t (decompose_essential_matrix).
__device__ inline void decompose_essential(const double* E, double* R1, double* R2, double* t) {
  double A[9], V[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      A[3 * i + j] = E[i] * E[j] + E[3 + i] * E[3 + j] + E[6 + i] * E[6 + j];
  jacobi_eigh<3, double>(A, V, 12);
  int i0 = 0, i1 = 1, i2 = 2;  // eigenvalues in descending order
  if (A[4 * i1] > A[4 * i0]) { const int s = i0; i0 = i1; i1 = s; }
  if (A[4 * i2] > A[4 * i1]) { const int s = i1; i1 = i2; i2 = s; }
  if (A[4 * i1] > A[4 * i0]) { const int s = i0; i0 = i1; i1 = s; }
  double v0[3], v1[3], v2[3], u0[3], u1[3], u2[3];
  for (int r = 0; r < 3; ++r) {
    v0[r] = V[3 * r + i0];
    v1[r] = V[3 * r + i1];
  }
  const double s0 = sqrt(fmax(A[4 * i0], 0.0)), s1 = sqrt(fmax(A[4 * i1], 0.0));
  for (int r = 0; r < 3; ++r) {
    u0[r] = (E[3 * r] * v0[0] + E[3 * r + 1] * v0[1] + E[3 * r + 2] * v0[2]) / fmax(s0, 1e-300);
    u1[r] = (E[3 * r] * v1[0] + E[3 * r + 1] * v1[1] + E[3 * r + 2] * v1[2]) / fmax(s1, 1e-300);
  }
  const double d = u0[0] * u1[0] + u0[1] * u1[1] + u0[2] * u1[2];
  for (int r = 0; r < 3; ++r) u1[r] -= d * u0[r];
  const double n1 = fmax(sqrt(u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2]), 1e-300);
  for (int r = 0; r < 3; ++r) u1[r] /= n1;
  cross3d(u0, u1, u2);
  cross3d(v0, v1, v2);
  // R1 = U W V^T with W = [[0,1,0],[-1,0,0],[0,0,1]]: U W = [-u1, u0, u2];
  // R2 = U W^T V^T: U W^T = [u1, -u0, u2].
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      R1[3 * i + j] = -u1[i] * v0[j] + u0[i] * v1[j] + u2[i] * v2[j];
      R2[3 * i + j] = u1[i] * v0[j] - u0[i] * v1[j] + u2[i] * v2[j];
    }
  const double nt = fmax(sqrt(u2[0] * u2[0] + u2[1] * u2[1] + u2[2] * u2[2]), 1e-30);
  for (int r = 0; r < 3; ++r) t[r] = u2[r] / nt;
}

// Two-view DLT of one row under P1 = [I | 0], P2 = [R | t]; returns the
// point and whether both depths lie in (1e-12, max_depth).
__device__ inline bool triangulate_row(const double* R, const double* t, double max_depth,
                                       double u1, double w1, double u2, double w2, double* X) {
  double A[4][4] = {{-1.0, 0.0, u1, 0.0}, {0.0, -1.0, w1, 0.0}, {0, 0, 0, 0}, {0, 0, 0, 0}};
  for (int k = 0; k < 3; ++k) {
    A[2][k] = u2 * R[6 + k] - R[k];
    A[3][k] = w2 * R[6 + k] - R[3 + k];
  }
  A[2][3] = u2 * t[2] - t[0];
  A[3][3] = w2 * t[2] - t[1];
  double AtA[16], Xh[4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j)
      AtA[4 * i + j] = A[0][i] * A[0][j] + A[1][i] * A[1][j] + A[2][i] * A[2][j] + A[3][i] * A[3][j];
  smallest_eigvec<4, double>(AtA, Xh, 10);
  const double w = fabs(Xh[3]) < 1e-30 ? 1.0 : Xh[3];
  for (int k = 0; k < 3; ++k) X[k] = Xh[k] / w;
  const double d1 = X[2];
  const double n2 = sqrt(R[6] * R[6] + R[7] * R[7] + R[8] * R[8]);
  const double d2 = (R[6] * X[0] + R[7] * X[1] + R[8] * X[2] + t[2]) * n2;
  return d1 > 1e-12 && d1 < max_depth && d2 > 1e-12 && d2 < max_depth;
}

// R (3x3, row-major) = A B.
__device__ __forceinline__ void matmul3(const double* A, const double* B, double* R) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      R[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

__device__ __forceinline__ void skew3(const double* v, double* S) {
  S[0] = 0.0;   S[1] = -v[2]; S[2] = v[1];
  S[3] = v[2];  S[4] = 0.0;   S[5] = -v[0];
  S[6] = -v[1]; S[7] = v[0];  S[8] = 0.0;
}

// Rotation matrix of a unit quaternion (w, x, y, z).
__device__ inline void quat_rotmat(const double* q, double* R) {
  const double w = q[0], x = q[1], y = q[2], z = q[3];
  R[0] = 1 - 2 * (y * y + z * z); R[1] = 2 * (x * y - w * z);     R[2] = 2 * (x * z + w * y);
  R[3] = 2 * (x * y + w * z);     R[4] = 1 - 2 * (x * x + z * z); R[5] = 2 * (y * z - w * x);
  R[6] = 2 * (x * z - w * y);     R[7] = 2 * (y * z + w * x);     R[8] = 1 - 2 * (x * x + y * y);
}

// _tangent_basis: two unit vectors orthogonal to unit t.
__device__ inline void tangent_basis(const double* t, double* b1, double* b2) {
  const double ref[3] = {fabs(t[0]) < 0.9 ? 1.0 : 0.0, fabs(t[0]) < 0.9 ? 0.0 : 1.0, 0.0};
  cross3d(t, ref, b1);
  const double n = fmax(sqrt(b1[0] * b1[0] + b1[1] * b1[1] + b1[2] * b1[2]), 1e-12);
  for (int i = 0; i < 3; ++i) b1[i] /= n;
  cross3d(t, b1, b2);
}

// Solves the 5x5 system A x = b in place (b <- x) by Gaussian elimination
// with partial pivoting (torch.linalg.solve's LU); NaN where a pivot is 0.
__device__ inline void solve5(double* A, double* b) {
  for (int c = 0; c < 5; ++c) {
    int piv = c;
    for (int r = c + 1; r < 5; ++r)
      if (fabs(A[5 * r + c]) > fabs(A[5 * piv + c])) piv = r;
    if (piv != c) {
      for (int k = 0; k < 5; ++k) {
        const double t = A[5 * c + k];
        A[5 * c + k] = A[5 * piv + k];
        A[5 * piv + k] = t;
      }
      const double t = b[c];
      b[c] = b[piv];
      b[piv] = t;
    }
    const double p = A[5 * c + c];
    for (int r = c + 1; r < 5; ++r) {
      const double f = A[5 * r + c] / p;
      for (int k = c; k < 5; ++k) A[5 * r + k] -= f * A[5 * c + k];
      b[r] -= f * b[c];
    }
  }
  for (int r = 4; r >= 0; --r) {
    double s = b[r];
    for (int k = r + 1; k < 5; ++k) s -= A[5 * r + k] * b[k];
    b[r] = s / A[5 * r + r];
  }
}

// Newton steps in float64 on the five epipolar constraints x2^T [t]x R x1 = 0
// over (R, unit t) (the tangent of refine_relative_pose): polishes a pose
// from a float32 five-point root to the exact root nearby; a step that is
// not finite is not taken.
__device__ inline void polish_pose(const double (*x1)[2], const double (*x2)[2], double* R,
                                   double* t, int steps) {
  for (int it = 0; it < steps; ++it) {
    double b1[3], b2[3], Tx[9], E[9], dE[5][9], S[9], ExR[9];
    tangent_basis(t, b1, b2);
    skew3(t, Tx);
    matmul3(Tx, R, E);
    for (int a = 0; a < 3; ++a) {
      const double e[3] = {a == 0 ? 1.0 : 0.0, a == 1 ? 1.0 : 0.0, a == 2 ? 1.0 : 0.0};
      skew3(e, S);
      matmul3(S, R, ExR);
      matmul3(Tx, ExR, dE[a]);
    }
    skew3(b1, S);
    matmul3(S, R, dE[3]);
    skew3(b2, S);
    matmul3(S, R, dE[4]);
    double J[25], f[5];
    for (int i = 0; i < 5; ++i) {
      const double p1[3] = {x1[i][0], x1[i][1], 1.0}, p2[3] = {x2[i][0], x2[i][1], 1.0};
      const double* Ms[6] = {E, dE[0], dE[1], dE[2], dE[3], dE[4]};
      double v[6];
      for (int m = 0; m < 6; ++m) {
        const double* M = Ms[m];
        v[m] = 0.0;
        for (int r = 0; r < 3; ++r)
          v[m] += p2[r] * (M[3 * r] * p1[0] + M[3 * r + 1] * p1[1] + M[3 * r + 2] * p1[2]);
      }
      f[i] = -v[0];
      for (int k = 0; k < 5; ++k) J[5 * i + k] = v[1 + k];
    }
    solve5(J, f);
    bool finite = true;
    for (int k = 0; k < 5; ++k) finite = finite && isfinite(f[k]);
    if (!finite) return;
    double dq[4] = {1.0, 0.5 * f[0], 0.5 * f[1], 0.5 * f[2]};
    const double nq = sqrt(dq[0] * dq[0] + dq[1] * dq[1] + dq[2] * dq[2] + dq[3] * dq[3]);
    for (int i = 0; i < 4; ++i) dq[i] /= nq;
    double dR[9], Rn[9];
    quat_rotmat(dq, dR);
    matmul3(dR, R, Rn);
    for (int i = 0; i < 9; ++i) R[i] = Rn[i];
    double tt[3];
    for (int i = 0; i < 3; ++i) tt[i] = t[i] + f[3] * b1[i] + f[4] * b2[i];
    const double nt = fmax(sqrt(tt[0] * tt[0] + tt[1] * tt[1] + tt[2] * tt[2]), 1e-12);
    for (int i = 0; i < 3; ++i) t[i] = tt[i] / nt;
  }
}

}  // namespace ctt
