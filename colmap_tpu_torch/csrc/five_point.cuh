// Nister's five-point essential-matrix solve on one warp, shared by K7
// (essential_ransac.cu, normalized image points) and K32
// (spherical_e_ransac.cu, unit bearing rays): only their 5 x 9 constraint
// rows differ, r2 (x) r1 for rays and (u2, v2, 1) (x) (u1, v1, 1) for points.
//
// Ports colmap_tpu/estimators/solvers/epipolar.py
// _essential_five_point_from_constraints (l.282) with optim/small_linalg.py
// nullspace_small (l.208):
//   - lane 0 (five_point_setup): the 4-dimensional null space of the
//     constraint matrix by Householder QR, the 10x20 cubic-constraint
//     matrix, Gauss-Jordan with partial pivoting, the 3x3 polynomial matrix
//     B(z) and its determinant, a degree-10 polynomial (normalized by its
//     largest coefficient), and its derivative;
//   - all lanes (five_point_models): both on the grid of G = 1024 cells in
//     theta over [-pi/2, pi/2] (z = tan theta, homogeneous (sin, cos) form),
//     32 points a lane, into shared memory. Ballots find the first 10 cells
//     whose value changes sign and the first 9 where only the derivative
//     does. Lanes 0-8 bisect the derivative in those 9 cells (24 steps, the
//     float32 depth of l.393) and split a cell where the value at the
//     extremum changes sign; lanes 0-27 bisect the <= 28 brackets (28 steps,
//     l.412). The first 10 valid brackets give the roots. Lanes 0-9: x(z),
//     y(z) by least squares on the rows of B, E, and three Newton-Schulz
//     steps onto the essential manifold (the depths are float32's; see
//     FivePointTraits).
// Degenerate samples (repeated rows, a singular elimination) give
// non-finite polynomials, no roots and NaN models; every loop has a fixed
// length.
//
// The solve is templated on its scalar type T. K7 and K32 run it in float
// (FivePoint): 24 extremum and 28 root bisection steps, 3 Newton-Schulz
// steps. K37 runs it in double (FivePointT<double>), the depths of the
// float64 plain version (50, 60, 4): in float32 the 10 x 20 elimination of
// an ill-conditioned sample loses roots that double keeps.
#pragma once

#include <cfloat>
#include <cuda_runtime.h>

#include "sfm_common.cuh"
#include "small_linalg.cuh"

namespace ctt {

constexpr int kGrid = 1024;

// The solve's depths and constants by scalar type (epipolar.py l.326-389).
template <typename T>
struct FivePointTraits;
template <>
struct FivePointTraits<float> {
  static constexpr int ext_steps = 24, root_steps = 28, schulz_steps = 3;
  static constexpr float pi = kPiF, tiny = 1e-30f, sqrt2 = 1.41421356237f;
};
template <>
struct FivePointTraits<double> {
  static constexpr int ext_steps = 50, root_steps = 60, schulz_steps = 4;
  static constexpr double pi = 3.141592653589793, tiny = 1e-300, sqrt2 = 1.4142135623730951;
};

__device__ __forceinline__ float sin_t(float x) { return sinf(x); }
__device__ __forceinline__ double sin_t(double x) { return sin(x); }
__device__ __forceinline__ float cos_t(float x) { return cosf(x); }
__device__ __forceinline__ double cos_t(double x) { return cos(x); }
__device__ __forceinline__ float tan_t(float x) { return tanf(x); }
__device__ __forceinline__ double tan_t(double x) { return tan(x); }
__device__ __forceinline__ float fmax_t(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_t(double a, double b) { return fmax(a, b); }

// Monomial index tables of epipolar.py (_MUL11: deg1 x deg1 -> deg2,
// _MUL21: deg2 x deg1 -> deg3).
static __constant__ unsigned char kMul11[4][4] = {{0, 3, 4, 6}, {3, 1, 5, 7}, {4, 5, 2, 8}, {6, 7, 8, 9}};
static __constant__ unsigned char kMul21[10][4] = {
    {0, 2, 4, 5}, {3, 1, 6, 7}, {10, 13, 16, 17}, {2, 3, 8, 9}, {4, 8, 10, 11},
    {8, 6, 13, 14}, {5, 9, 11, 12}, {9, 7, 14, 15}, {11, 14, 17, 18}, {12, 15, 18, 19}};

template <typename T>
__device__ inline void p11(const T* p, const T* q, T* out) {  // (4) x (4) -> (10)
  for (int k = 0; k < 10; ++k) out[k] = T(0);
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) out[kMul11[i][j]] += p[i] * q[j];
}

template <typename T>
__device__ inline void p21_acc(const T* p, const T* q, T sign, T* out) {  // += (10)x(4)
  for (int i = 0; i < 10; ++i)
    for (int j = 0; j < 4; ++j) out[kMul21[i][j]] += sign * p[i] * q[j];
}

// Descending-power polynomial a (deg da) times b (deg db), added with sign.
template <typename T>
__device__ inline void conv_acc(const T* a, int na, const T* b, int nb, T sign, T* out) {
  for (int i = 0; i < na; ++i)
    for (int j = 0; j < nb; ++j) out[i + j] += sign * a[i] * b[j];
}

template <typename T>
__device__ __forceinline__ T polyval_homog(const T* c, int n1, T s, T co) {
  T out = T(0), cp = T(1);
  for (int k = 0; k < n1; ++k) {
    out = out * s + c[k] * cp;
    cp *= co;
  }
  return out;
}

template <typename T>
__device__ __forceinline__ T peval(const T* p, int n1, T z) {
  T out = T(0);
  for (int k = 0; k < n1; ++k) out = out * z + p[k];
  return out;
}

template <typename T>
__device__ __forceinline__ T grid_theta(int g) {
  constexpr T pi = FivePointTraits<T>::pi;
  return (T)g / (T)kGrid * pi - pi / T(2);
}

// Per-warp shared state of one 5-point solve.
template <typename T>
struct FivePointT {
  T v[kGrid + 1];
  T dv[kGrid + 1];
  T n_poly[11];
  T d_poly[10];
  T bpoly[3][13];  // rows a, b, c of B(z): p1 (4), p2 (4), p3 (5)
  T EB[36];        // null-space basis, EB[(3i + j) * 4 + k]
  T lo[28], hi[28];
  int direct[10], ext[9];
  int n_direct, n_ext;
  T roots[10];
  int n_roots;
  T models[10][9];
};
using FivePoint = FivePointT<float>;

// Lane 0: null space, elimination and the polynomials, from B = A^T (9 x 5),
// whose column r is the constraint row of sample r (destroyed).
template <typename T>
__device__ inline void five_point_setup(T (*B)[5], FivePointT<T>& S) {
  // Householder QR of A^T: reflection j acts on rows j..8.
  T V[5][9], scale[5];
  for (int j = 0; j < 5; ++j) {
    T norm = T(0.);
    for (int i = j; i < 9; ++i) norm += B[i][j] * B[i][j];
    norm = sqrt_t(norm);
    const T alpha = -(B[j][j] >= T(0.) ? T(1.) : -T(1.)) * norm;
    T vn = T(0.);
    for (int i = j; i < 9; ++i) {
      V[j][i] = B[i][j] - (i == j ? alpha : T(0.));
      vn += V[j][i] * V[j][i];
    }
    vn = sqrt_t(vn);
    for (int i = j; i < 9; ++i) V[j][i] /= fmax_t(vn, T(1e-30));
    scale[j] = vn > T(1e-30) ? T(2.) : T(0.);
    for (int c = 0; c < 5; ++c) {
      T w = T(0.);
      for (int i = j; i < 9; ++i) w += V[j][i] * B[i][c];
      for (int i = j; i < 9; ++i) B[i][c] -= scale[j] * V[j][i] * w;
    }
  }
  // Null-space columns: Q e_c for c = 5..8, Q = H0 H1 ... H4.
  for (int k = 0; k < 4; ++k) {
    T x[9];
    for (int i = 0; i < 9; ++i) x[i] = i == 5 + k ? T(1.) : T(0.);
    for (int j = 4; j >= 0; --j) {
      T w = T(0.);
      for (int i = j; i < 9; ++i) w += V[j][i] * x[i];
      for (int i = j; i < 9; ++i) x[i] -= scale[j] * V[j][i] * w;
    }
    for (int i = 0; i < 9; ++i) S.EB[i * 4 + k] = x[i];
  }
  const T* EB = S.EB;
#define EBP(i, j) (EB + ((i) * 3 + (j)) * 4)
  T M[10][20];
  for (int r = 0; r < 10; ++r)
    for (int c = 0; c < 20; ++c) M[r][c] = T(0.);
  // det(E) by the first row.
  {
    T m1[10], m2[10];
    const int cols[3][2] = {{1, 2}, {0, 2}, {0, 1}};
    const T sgn[3] = {T(1.), -T(1.), T(1.)};
    for (int c = 0; c < 3; ++c) {
      const int j0 = cols[c][0], j1 = cols[c][1];
      p11(EBP(1, j0), EBP(2, j1), m1);
      p11(EBP(1, j1), EBP(2, j0), m2);
      for (int k = 0; k < 10; ++k) m1[k] -= m2[k];
      p21_acc(m1, EBP(0, c), sgn[c], M[0]);
    }
  }
  // 2 E E^T E - trace(E E^T) E = 0.
  T EEt[3][3][10];
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) {
      T acc[10] = {T(0.), T(0.), T(0.), T(0.), T(0.), T(0.), T(0.), T(0.), T(0.), T(0.)}, t[10];
      for (int j = 0; j < 3; ++j) {
        p11(EBP(i, j), EBP(k, j), t);
        for (int q = 0; q < 10; ++q) acc[q] += t[q];
      }
      for (int q = 0; q < 10; ++q) EEt[i][k][q] = acc[q];
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k) {
        T L[10];
        for (int q = 0; q < 10; ++q)
          L[q] = T(2.) * EEt[i][k][q] -
                 (i == k ? EEt[0][0][q] + EEt[1][1][q] + EEt[2][2][q] : T(0.));
        p21_acc(L, EBP(k, j), T(1.), M[1 + 3 * i + j]);
      }
#undef EBP
  // Gauss-Jordan with partial pivoting: [A1 | A2] -> [I | A1^-1 A2].
  for (int c = 0; c < 10; ++c) {
    int piv = c;
    for (int r = c + 1; r < 10; ++r)
      if (fabs_t(M[r][c]) > fabs_t(M[piv][c])) piv = r;
    if (piv != c)
      for (int q = 0; q < 20; ++q) {
        const T t = M[c][q];
        M[c][q] = M[piv][q];
        M[piv][q] = t;
      }
    const T inv = T(1.) / M[c][c];
    for (int q = c; q < 20; ++q) M[c][q] *= inv;
    for (int r = 0; r < 10; ++r) {
      if (r == c) continue;
      const T f = M[r][c];
      for (int q = c; q < 20; ++q) M[r][q] -= f * M[c][q];
    }
  }
  // Rows of B(z) (brow of epipolar.py); Mred = M[:, 10:].
  for (int i = 0; i < 3; ++i) {
    const T* r1 = M[4 + 2 * i] + 10;
    const T* r2 = M[5 + 2 * i] + 10;
    T* p = S.bpoly[i];
    p[0] = r2[0]; p[1] = r2[1] - r1[0]; p[2] = r2[2] - r1[1]; p[3] = -r1[2];
    p[4] = r2[3]; p[5] = r2[4] - r1[3]; p[6] = r2[5] - r1[4]; p[7] = -r1[5];
    p[8] = r2[6]; p[9] = r2[7] - r1[6]; p[10] = r2[8] - r1[7]; p[11] = r2[9] - r1[8];
    p[12] = -r1[9];
  }
  // det of [[p1a, p2a, p3a], [p1b, p2b, p3b], [p1c, p2c, p3c]]: degree 10.
  const T* a = S.bpoly[0];
  const T* b = S.bpoly[1];
  const T* c = S.bpoly[2];
  T t1[8], t2[8], t3[8], np[11];
  for (int q = 0; q < 8; ++q) t1[q] = t2[q] = t3[q] = T(0.);
  for (int q = 0; q < 11; ++q) np[q] = T(0.);
  conv_acc(b + 4, 4, c + 8, 5, T(1.), t1);   // p2b p3c
  conv_acc(c + 4, 4, b + 8, 5, -T(1.), t1);  // - p2c p3b
  conv_acc(t1, 8, a, 4, T(1.), np);          // p1a (...)
  conv_acc(b, 4, c + 8, 5, T(1.), t2);       // p1b p3c
  conv_acc(c, 4, b + 8, 5, -T(1.), t2);      // - p1c p3b
  conv_acc(a + 4, 4, t2, 8, -T(1.), np);     // - p2a (...)
  conv_acc(b, 4, c + 4, 4, T(1.), t3);       // p1b p2c
  conv_acc(c, 4, b + 4, 4, -T(1.), t3);      // - p1c p2b
  conv_acc(a + 8, 5, t3, 7, T(1.), np);      // p3a (...)
  T mx = T(0.);
  for (int q = 0; q < 11; ++q) mx = fmax_t(mx, fabs_t(np[q]));
  bool finite = true;
  for (int q = 0; q < 11; ++q) finite = finite && isfinite(np[q]);
  const T inv = T(1.) / fmax_t(mx, FivePointTraits<T>::tiny);
  for (int q = 0; q < 11; ++q) S.n_poly[q] = finite ? np[q] * inv : NAN;
  for (int q = 0; q < 10; ++q) S.d_poly[q] = S.n_poly[q] * (T)(10 - q);
}

// Lanes 0-9: the model of root r (or NaN).
template <typename T>
__device__ inline void five_point_model(const FivePointT<T>& S, int r, T* E) {
  const T z = S.roots[r];
  T al[3], a2[3], b3[3];
  for (int i = 0; i < 3; ++i) {
    al[i] = peval(S.bpoly[i], 4, z);
    a2[i] = peval(S.bpoly[i] + 4, 4, z);
    b3[i] = -peval(S.bpoly[i] + 8, 5, z);
  }
  const T g11 = al[0] * al[0] + al[1] * al[1] + al[2] * al[2];
  const T g12 = al[0] * a2[0] + al[1] * a2[1] + al[2] * a2[2];
  const T g22 = a2[0] * a2[0] + a2[1] * a2[1] + a2[2] * a2[2];
  const T h1 = al[0] * b3[0] + al[1] * b3[1] + al[2] * b3[2];
  const T h2 = a2[0] * b3[0] + a2[1] * b3[1] + a2[2] * b3[2];
  const T det_g = g11 * g22 - g12 * g12;
  const T safe = fabs_t(det_g) < T(1e-30) ? T(1.) : det_g;
  const T xs = (g22 * h1 - g12 * h2) / safe;
  const T ys = (g11 * h2 - g12 * h1) / safe;
  T Y[9], fro = T(0.);
  for (int e = 0; e < 9; ++e) {
    const T* b = S.EB + e * 4;
    Y[e] = xs * b[0] + ys * b[1] + z * b[2] + b[3];
    fro += Y[e] * Y[e];
  }
  const T s = FivePointTraits<T>::sqrt2 / fmax_t(sqrt_t(fro), T(1e-30));
  for (int e = 0; e < 9; ++e) Y[e] *= s;
  for (int it = 0; it < FivePointTraits<T>::schulz_steps; ++it) {  // Y <- 1.5 Y - 0.5 Y Y^T Y
    T YYt[9], Z[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        YYt[i * 3 + j] = Y[i * 3] * Y[j * 3] + Y[i * 3 + 1] * Y[j * 3 + 1] + Y[i * 3 + 2] * Y[j * 3 + 2];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Z[i * 3 + j] = YYt[i * 3] * Y[j] + YYt[i * 3 + 1] * Y[3 + j] + YYt[i * 3 + 2] * Y[6 + j];
    for (int e = 0; e < 9; ++e) Y[e] = T(1.5) * Y[e] - T(0.5) * Z[e];
  }
  const bool ok = fabs_t(det_g) >= T(1e-30);
  for (int e = 0; e < 9; ++e) E[e] = ok ? Y[e] : NAN;
}

// All lanes of the warp: the roots of S's polynomial and the (up to) 10
// models into S.models (NaN rows where a slot has no root); S is lane 0's
// five_point_setup. Ends with the warp synchronized.
template <typename T>
__device__ inline void five_point_models(FivePointT<T>& S, int lane) {
  __syncwarp();
  // The polynomial and its derivative on the grid.
  for (int g = lane; g <= kGrid; g += 32) {
    const T th = grid_theta<T>(g);
    const T sn = sin_t(th), cs = cos_t(th);
    S.v[g] = polyval_homog(S.n_poly, 11, sn, cs);
    S.dv[g] = polyval_homog(S.d_poly, 10, sn, cs);
  }
  __syncwarp();
  // First 10 sign-change cells and first 9 extremum-only cells, in order.
  const unsigned lt = (1u << lane) - 1u;
  int nd = 0, ne = 0;
  for (int base = 0; base < kGrid; base += 32) {
    const int c = base + lane;
    const bool sc = S.v[c] * S.v[c + 1] < T(0.);
    const bool ex = S.dv[c] * S.dv[c + 1] < T(0.) && !sc;
    const unsigned bs = __ballot_sync(kFull, sc), be = __ballot_sync(kFull, ex);
    const int ps = nd + __popc(bs & lt), pe = ne + __popc(be & lt);
    if (sc && ps < 10) S.direct[ps] = c;
    if (ex && pe < 9) S.ext[pe] = c;
    nd += __popc(bs);
    ne += __popc(be);
  }
  nd = min(nd, 10);
  ne = min(ne, 9);
  // Lanes 0-8: bisect the derivative to the extremum; split the cell there.
  T e_mid = T(0.);
  bool split = false;
  if (lane < ne) {
    const int c = S.ext[lane];
    T lo = grid_theta<T>(c), hi = grid_theta<T>(c + 1);
    const T s_dlo = sgn(S.dv[c]);
    for (int it = 0; it < FivePointTraits<T>::ext_steps; ++it) {
      const T mid = T(0.5) * (lo + hi);
      const bool right = sgn(polyval_homog(S.d_poly, 10, sin_t(mid), cos_t(mid))) == s_dlo;
      lo = right ? mid : lo;
      hi = right ? hi : mid;
    }
    e_mid = T(0.5) * (lo + hi);
    const T v_mid = polyval_homog(S.n_poly, 11, sin_t(e_mid), cos_t(e_mid));
    split = sgn(v_mid) != sgn(S.v[c]) && v_mid != T(0.);
  }
  // Brackets: slots 0-9 direct cells, 10-18 (lo, mid), 19-27 (mid, hi).
  if (lane < nd) {
    S.lo[lane] = grid_theta<T>(S.direct[lane]);
    S.hi[lane] = grid_theta<T>(S.direct[lane] + 1);
  }
  if (lane < 9) {
    const int c = lane < ne ? S.ext[lane] : 0;
    S.lo[10 + lane] = grid_theta<T>(c);
    S.hi[10 + lane] = e_mid;
    S.lo[19 + lane] = e_mid;
    S.hi[19 + lane] = grid_theta<T>(c + 1);
  }
  const unsigned split_bits = __ballot_sync(kFull, split);
  __syncwarp();
  const bool valid = lane < 10 ? lane < nd
                               : (lane < 28 && ((split_bits >> ((lane - 10) % 9)) & 1u) != 0u);
  T root = T(0.);
  if (valid) {
    T lo = S.lo[lane], hi = S.hi[lane];
    const T s_lo = sgn(polyval_homog(S.n_poly, 11, sin_t(lo), cos_t(lo)));
    for (int it = 0; it < FivePointTraits<T>::root_steps; ++it) {
      const T mid = T(0.5) * (lo + hi);
      const bool right = sgn(polyval_homog(S.n_poly, 11, sin_t(mid), cos_t(mid))) == s_lo;
      lo = right ? mid : lo;
      hi = right ? hi : mid;
    }
    root = tan_t(T(0.5) * (lo + hi));
  }
  // The first 10 valid brackets, in slot order.
  const unsigned vb = __ballot_sync(kFull, valid);
  const int pos = __popc(vb & lt);
  if (valid && pos < 10) S.roots[pos] = root;
  if (lane == 0) S.n_roots = min(__popc(vb), 10);
  __syncwarp();
  if (lane < 10) {
    T E[9];
    if (lane < S.n_roots) {
      five_point_model(S, lane, E);
    } else {
      for (int e = 0; e < 9; ++e) E[e] = NAN;
    }
    for (int e = 0; e < 9; ++e) S.models[lane][e] = E[e];
  }
  __syncwarp();
}

}  // namespace ctt
