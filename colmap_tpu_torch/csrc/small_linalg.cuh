// Small dense linear algebra for one thread: the symmetric eigensolver and
// the 3x3 decompositions the RANSAC and triangulation kernels (K6, K7, K8)
// run per sample, per refit or per track.
//
// Plain versions: colmap_tpu_torch/optim/small_linalg.py (eigh_small,
// svd3x3) and estimators/solvers/p3p.py (kabsch). The kernels never call a
// library for these: cuSOLVER's batched routines would add a launch and a
// round trip through device memory per sample.
//
// jacobi_eigh<N> is the cyclic Jacobi method with the algebraic rotation of
// Golub & Van Loan 8.4 (no trigonometry) and colmap_tpu's skip rule: a
// rotation whose |a_pq| * 1e12 < |a_qq - a_pp| is skipped. Matrices are
// row-major arrays in the thread's registers or local memory.
#pragma once

#include <cuda_runtime.h>

namespace ctt {

__device__ __forceinline__ float sgnf(float x) { return (float)((x > 0.f) - (x < 0.f)); }

// In place: on return the diagonal of A holds the eigenvalues and the
// columns of V the eigenvectors (unsorted).
template <int N>
__device__ void jacobi_eigh(float* A, float* V, int sweeps) {
  for (int i = 0; i < N * N; ++i) V[i] = (i / N == i % N) ? 1.f : 0.f;
  for (int i = 0; i < N; ++i)
    for (int j = i + 1; j < N; ++j) {
      const float m = 0.5f * (A[i * N + j] + A[j * N + i]);
      A[i * N + j] = m;
      A[j * N + i] = m;
    }
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int p = 0; p < N - 1; ++p) {
      for (int q = p + 1; q < N; ++q) {
        const float apq = A[p * N + q];
        const float diff = A[q * N + q] - A[p * N + p];
        if (apq == 0.f || fabsf(apq) * 1e12f < fabsf(diff)) continue;
        const float tau = diff / (2.f * apq);
        float t = tau == 0.f ? 1.f : sgnf(tau) / (fabsf(tau) + sqrtf(1.f + tau * tau));
        const float c = rsqrtf(1.f + t * t);
        const float s = t * c;
        // A <- A J (columns p, q), then A <- J^T A (rows p, q); V <- V J.
        for (int k = 0; k < N; ++k) {
          const float akp = A[k * N + p], akq = A[k * N + q];
          A[k * N + p] = c * akp - s * akq;
          A[k * N + q] = s * akp + c * akq;
        }
        for (int k = 0; k < N; ++k) {
          const float apk = A[p * N + k], aqk = A[q * N + k];
          A[p * N + k] = c * apk - s * aqk;
          A[q * N + k] = s * apk + c * aqk;
        }
        for (int k = 0; k < N; ++k) {
          const float vkp = V[k * N + p], vkq = V[k * N + q];
          V[k * N + p] = c * vkp - s * vkq;
          V[k * N + q] = s * vkp + c * vkq;
        }
      }
    }
  }
}

// Index of the smallest diagonal entry (the first on ties, as a stable sort).
template <int N>
__device__ __forceinline__ int argmin_diag(const float* A) {
  int best = 0;
  for (int i = 1; i < N; ++i)
    if (A[i * N + i] < A[best * N + best]) best = i;
  return best;
}

// Unit eigenvector (column of V) of the smallest eigenvalue of symmetric A.
template <int N>
__device__ void smallest_eigvec(float* A, float* out, int sweeps) {
  float V[N * N];
  jacobi_eigh<N>(A, V, sweeps);
  const int k = argmin_diag<N>(A);
  for (int i = 0; i < N; ++i) out[i] = V[i * N + k];
}

__device__ __forceinline__ void cross3(const float* a, const float* b, float* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// The two dominant right singular vectors v0, v1 of the 3x3 matrix M and
// the matching left vectors u0 = M v0 / s0, u1 (orthogonalized against u0
// and normalized), through the eigenvectors of M^T M (svd3x3 of
// small_linalg.py).
__device__ inline void svd3x3_top2(const float* M, float* u0, float* u1, float* v0, float* v1) {
  float MtM[9], V[9];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      MtM[i * 3 + j] = M[0 * 3 + i] * M[0 * 3 + j] + M[1 * 3 + i] * M[1 * 3 + j] +
                       M[2 * 3 + i] * M[2 * 3 + j];
  jacobi_eigh<3>(MtM, V, 8);
  // The largest and the second largest eigenvalue.
  const int lo = argmin_diag<3>(MtM);
  int i0 = lo == 0 ? 1 : 0;
  int i1 = 3 - lo - i0;
  if (MtM[i1 * 4] > MtM[i0 * 4]) {
    const int tmp = i0;
    i0 = i1;
    i1 = tmp;
  }
  for (int r = 0; r < 3; ++r) {
    v0[r] = V[r * 3 + i0];
    v1[r] = V[r * 3 + i1];
  }
  const float s0 = sqrtf(fmaxf(MtM[i0 * 4], 0.f)), s1 = sqrtf(fmaxf(MtM[i1 * 4], 0.f));
  for (int r = 0; r < 3; ++r) {
    u0[r] = (M[r * 3 + 0] * v0[0] + M[r * 3 + 1] * v0[1] + M[r * 3 + 2] * v0[2]) / fmaxf(s0, 1e-30f);
    u1[r] = (M[r * 3 + 0] * v1[0] + M[r * 3 + 1] * v1[1] + M[r * 3 + 2] * v1[2]) / fmaxf(s1, 1e-30f);
  }
  const float d = u0[0] * u1[0] + u0[1] * u1[1] + u0[2] * u1[2];
  for (int r = 0; r < 3; ++r) u1[r] -= d * u0[r];
  const float n = fmaxf(sqrtf(u1[0] * u1[0] + u1[1] * u1[1] + u1[2] * u1[2]), 1e-30f);
  for (int r = 0; r < 3; ++r) u1[r] /= n;
}

// The Kabsch rotation of H = sum src0 dst0^T (dst ~ R src): with
// H = U S V^T, R = V diag(1, 1, d) U^T,
// d = det(V U^T). Written as R = v0 u0^T + v1 u1^T + (v0 x v1)(u0 x u1)^T,
// the proper rotation taking u0 to v0 and u1 to v1, which needs only the
// two dominant singular pairs.
__device__ inline void kabsch_rotation(const float* H, float* R) {
  float u0[3], u1[3], v0[3], v1[3], u2[3], v2[3];
  svd3x3_top2(H, u0, u1, v0, v1);
  cross3(u0, u1, u2);
  cross3(v0, v1, v2);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) R[i * 3 + j] = v0[i] * u0[j] + v1[i] * u1[j] + v2[i] * u2[j];
}

}  // namespace ctt
