// Small dense linear algebra for one thread: the symmetric eigensolver, a
// Cholesky solve and the 3x3 decompositions the RANSAC and triangulation
// kernels (K6, K7, K8, K27) run per sample, per refit or per track.
//
// Plain versions: colmap_tpu_torch/optim/small_linalg.py (eigh_small,
// svd3x3) and estimators/solvers/p3p.py (kabsch). The kernels never call a
// library for these: cuSOLVER's batched routines would add a launch and a
// round trip through device memory per sample.
//
// jacobi_eigh<N, T> is the cyclic Jacobi method with the algebraic rotation
// of Golub & Van Loan 8.4 (no trigonometry) and colmap_tpu's skip rule: a
// rotation whose |a_pq| * 1e12 < |a_qq - a_pp| is skipped. T is float or
// double. Matrices are row-major arrays in the thread's registers or local
// memory.
#pragma once

#include <cuda_runtime.h>

namespace ctt {

__device__ __forceinline__ float sgnf(float x) { return (float)((x > 0.f) - (x < 0.f)); }

template <typename T>
__device__ __forceinline__ T sgn(T x) {
  return (T)((x > T(0)) - (x < T(0)));
}

__device__ __forceinline__ float rsqrt_t(float x) { return rsqrtf(x); }
__device__ __forceinline__ double rsqrt_t(double x) { return rsqrt(x); }
__device__ __forceinline__ float sqrt_t(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_t(double x) { return sqrt(x); }
__device__ __forceinline__ float fabs_t(float x) { return fabsf(x); }
__device__ __forceinline__ double fabs_t(double x) { return fabs(x); }

// In place: on return the diagonal of A holds the eigenvalues and the
// columns of V the eigenvectors (unsorted).
template <int N, typename T>
__device__ void jacobi_eigh(T* A, T* V, int sweeps) {
  for (int i = 0; i < N * N; ++i) V[i] = (i / N == i % N) ? T(1) : T(0);
  for (int i = 0; i < N; ++i)
    for (int j = i + 1; j < N; ++j) {
      const T m = T(0.5) * (A[i * N + j] + A[j * N + i]);
      A[i * N + j] = m;
      A[j * N + i] = m;
    }
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int p = 0; p < N - 1; ++p) {
      for (int q = p + 1; q < N; ++q) {
        const T apq = A[p * N + q];
        const T diff = A[q * N + q] - A[p * N + p];
        if (apq == T(0) || fabs_t(apq) * T(1e12) < fabs_t(diff)) continue;
        const T tau = diff / (T(2) * apq);
        T t = tau == T(0) ? T(1) : sgn(tau) / (fabs_t(tau) + sqrt_t(T(1) + tau * tau));
        const T c = rsqrt_t(T(1) + t * t);
        const T s = t * c;
        // A <- A J (columns p, q), then A <- J^T A (rows p, q); V <- V J.
        for (int k = 0; k < N; ++k) {
          const T akp = A[k * N + p], akq = A[k * N + q];
          A[k * N + p] = c * akp - s * akq;
          A[k * N + q] = s * akp + c * akq;
        }
        for (int k = 0; k < N; ++k) {
          const T apk = A[p * N + k], aqk = A[q * N + k];
          A[p * N + k] = c * apk - s * aqk;
          A[q * N + k] = s * apk + c * aqk;
        }
        for (int k = 0; k < N; ++k) {
          const T vkp = V[k * N + p], vkq = V[k * N + q];
          V[k * N + p] = c * vkp - s * vkq;
          V[k * N + q] = s * vkp + c * vkq;
        }
      }
    }
  }
}

// Index of the smallest diagonal entry (the first on ties, as a stable sort).
template <int N, typename T>
__device__ __forceinline__ int argmin_diag(const T* A) {
  int best = 0;
  for (int i = 1; i < N; ++i)
    if (A[i * N + i] < A[best * N + best]) best = i;
  return best;
}

// Unit eigenvector (column of V) of the smallest eigenvalue of symmetric A.
template <int N, typename T>
__device__ void smallest_eigvec(T* A, T* out, int sweeps) {
  T V[N * N];
  jacobi_eigh<N>(A, V, sweeps);
  const int k = argmin_diag<N>(A);
  for (int i = 0; i < N; ++i) out[i] = V[i * N + k];
}

// colmap_tpu's tournament order of the 36 pairs of 9 indices
// (optim/small_linalg.py _round_robin(9)): in round k (0..8) place 0 of the
// circle holds 0 and place j = 1..9 holds ((j - 1 - k) mod 9) + 1; place i
// meets place 9 - i (i = 0..4), and a meeting with the tenth index, 9, is
// no rotation. Every pair meets once in the 9 rounds.
__host__ __device__ constexpr int rr9_at(int k, int j) {
  return j == 0 ? 0 : ((j - 1 - k) % 9 + 9) % 9 + 1;
}

// Unit eigenvector of the smallest eigenvalue of the symmetric 9 x 9
// matrix whose upper triangle, row by row, is ut[45] (held by every lane),
// by a cyclic Jacobi over one warp: lane k < 9 keeps row k of A and of V in
// registers. In each round (colmap_tpu eigh_small's tournament, rr9_at) the
// lower lane p of each of the 4 pairs (p, q) takes the rotation from its
// row's A[p][p], A[p][q] and lane q's A[q][q] (jacobi_eigh's algebraic
// rotation and skip rule, its quotients by the fast reciprocal); every lane
// applies the 4 rotations to its rows of A and V (A J, V J), then each
// pair's lanes combine their rows (J^T A). The smallest diagonal entry
// picks the column (the first on ties). All 32 lanes of the warp call it;
// every lane gets out.
__device__ inline void warp_smallest_eigvec9(const float* ut, float* out, int sweeps) {
  constexpr unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float a[9], v[9];
#pragma unroll
  for (int s = 0; s < 9; ++s) {
    a[s] = 0.f;
    v[s] = s == lane ? 1.f : 0.f;
  }
#pragma unroll
  for (int r = 0, q = 0; r < 9; ++r)
#pragma unroll
    for (int s = r; s < 9; ++s, ++q) {
      if (lane == r) a[s] = ut[q];
      if (lane == s) a[r] = ut[q];
    }
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll
    for (int r = 0; r < 9; ++r) {
      // This lane's partner in round r (itself where it has none).
      int partner = lane;
      bool low = true;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const int e = rr9_at(r, i), f = rr9_at(r, 9 - i);
        if (e == 9 || f == 9) continue;
        const int p = e < f ? e : f, q = e < f ? f : e;
        if (lane == p) partner = q;
        if (lane == q) {
          partner = p;
          low = false;
        }
      }
      float diag = 0.f, off = 0.f;  // A[k][k] and A[k][partner] of this lane's row k
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        if (j == lane) diag = a[j];
        if (j == partner) off = a[j];
      }
      const float other = __shfl_sync(full, diag, partner);
      float c = 1.f, sn = 0.f;
      if (low && partner != lane) {
        const float diff = other - diag;
        if (!(off == 0.f || fabsf(off) * 1e12f < fabsf(diff))) {
          const float tau = __fdividef(diff, 2.f * off);
          const float t =
              tau == 0.f ? 1.f : __fdividef(sgn(tau), fabsf(tau) + sqrtf(1.f + tau * tau));
          c = rsqrtf(1.f + t * t);
          sn = t * c;
        }
      }
      // A <- A J, V <- V J: columns p and q of each lane's rows.
      float cr = 1.f, sr = 0.f;
#pragma unroll
      for (int i = 0; i < 5; ++i) {
        const int e = rr9_at(r, i), f = rr9_at(r, 9 - i);
        if (e == 9 || f == 9) continue;
        const int p = e < f ? e : f, q = e < f ? f : e;
        const float ci = __shfl_sync(full, c, p), si = __shfl_sync(full, sn, p);
        const float akp = a[p], akq = a[q];
        a[p] = ci * akp - si * akq;
        a[q] = si * akp + ci * akq;
        const float vkp = v[p], vkq = v[q];
        v[p] = ci * vkp - si * vkq;
        v[q] = si * vkp + ci * vkq;
        if (lane == p || lane == q) {
          cr = ci;
          sr = si;
        }
      }
      // A <- J^T A: rows p and q, each lane with its partner's row.
#pragma unroll
      for (int s = 0; s < 9; ++s) {
        const float o = __shfl_sync(full, a[s], partner);
        a[s] = low ? cr * a[s] - sr * o : sr * o + cr * a[s];
      }
    }
  }
  int best = 0;
  float dmin = __shfl_sync(full, a[0], 0);
#pragma unroll
  for (int j = 1; j < 9; ++j) {
    const float d = __shfl_sync(full, a[j], j);
    if (d < dmin) {
      dmin = d;
      best = j;
    }
  }
  float mine = 0.f;
#pragma unroll
  for (int j = 0; j < 9; ++j)
    if (j == best) mine = v[j];
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i] = __shfl_sync(full, mine, i);
}

// Solves A x = b in place for symmetric positive definite A (row-major,
// only the lower triangle read) by Cholesky: on return b holds x. Returns
// false, with b undefined, where a pivot is not positive.
template <int N, typename T>
__device__ bool cholesky_solve(T* A, T* b) {
  for (int j = 0; j < N; ++j) {
    T d = A[j * N + j];
    for (int k = 0; k < j; ++k) d -= A[j * N + k] * A[j * N + k];
    if (!(d > T(0))) return false;
    const T l = sqrt_t(d);
    A[j * N + j] = l;
    for (int i = j + 1; i < N; ++i) {
      T s = A[i * N + j];
      for (int k = 0; k < j; ++k) s -= A[i * N + k] * A[j * N + k];
      A[i * N + j] = s / l;
    }
  }
  for (int i = 0; i < N; ++i) {  // L y = b
    T s = b[i];
    for (int k = 0; k < i; ++k) s -= A[i * N + k] * b[k];
    b[i] = s / A[i * N + i];
  }
  for (int i = N - 1; i >= 0; --i) {  // L^T x = y
    T s = b[i];
    for (int k = i + 1; k < N; ++k) s -= A[k * N + i] * b[k];
    b[i] = s / A[i * N + i];
  }
  return true;
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
