// K7 essential_ransac: the batches and the refit of the 5-point LO-RANSAC.
//
// Replaces colmap_tpu/estimators/two_view_geometry.py _ransac_e (l.127) with
// the body of optim/ransac.py ransac (l.78) and what it runs:
// estimators/solvers/epipolar.py essential_five_point (l.259) and
// _essential_five_point_from_constraints (l.282), optim/small_linalg.py
// nullspace_small (l.208), epipolar.py essential_eight_point (l.117) for
// the LO refit, and geometry/essential.py sampson_error (l.141).
//
// Three entries:
//   essential_propose_score: one warp per minimal sample.
//     - Lane 0: the 5x9 constraint matrix, its 4-dimensional null space by
//       Householder QR, the 10x20 cubic-constraint matrix, Gauss-Jordan
//       with partial pivoting, the 3x3 polynomial matrix B(z) and its
//       determinant, a degree-10 polynomial (normalized by its largest
//       coefficient), and its derivative.
//     - All lanes: both on the grid of G = 1024 cells in theta over
//       [-pi/2, pi/2] (z = tan theta, homogeneous (sin, cos) form), 32
//       points a lane, into shared memory. Ballots find the first 10 cells
//       whose value changes sign and the first 9 where only the derivative
//       does. Lanes 0-8 bisect the derivative in those 9 cells (24 steps,
//       the float32 depth of l.393) and split a cell where the value at
//       the extremum changes sign; lanes 0-27 bisect the <= 28 brackets
//       (28 steps, l.412). The first 10 valid brackets give the roots.
//     - Lanes 0-9: x(z), y(z) by least squares on the rows of B, E, and
//       three Newton-Schulz steps onto the essential manifold.
//     - The warp scores the 10 models on all N rows by Sampson error in one
//       strided pass (__popc(__ballot_sync)), writes models and counts, and
//       keeps the batch's best with one 64-bit atomicMax on (count, index).
//   essential_refit: one block, the weighted 8-point on the inliers of the
//     given model: Hartley normalization (weighted centroid, then mean
//     distance), A^T A (9x9, 45 block sums), its smallest eigenvector by
//     Jacobi (small_linalg.cuh), denormalization, projection to singular
//     values (1, 1, 0); kept if its support is larger.
//   essential_inliers: one thread per row, the inlier mask of one model.
//
// The pair axis (estimators/two_view_batch.py _verify_block, l.62): every
// entry takes B problems, x1, x2 (B, N, 2), mask (B, N), one max_sq for all
// or one per problem (max_sq_arr), and propose_score an optional ``active``
// byte per problem whose zeros it skips; grids span (sample, problem),
// (problem) and (row, problem). The mapper's one-pair calls are B = 1.
//
// Degenerate samples (repeated rows, a singular elimination) give
// non-finite polynomials, no roots and models that score 0; every loop has
// a fixed length.
//
// Bound on the card: operations. Per sample the grid costs 1025 x 2
// polynomial evaluations of degree 10 (~40 flops each) and the bisections
// 9 x 24 + 28 x 28 evaluations with a sine and a cosine, about 10^5 flops;
// the scoring 10 x N Sampson errors (~25 flops each). Lane 0's serial
// elimination (a few thousand flops) leaves 31 lanes idle; spreading it
// over the warp is later work, as is fusing the host's batch loop.
#include <cfloat>
#include <cuda_runtime.h>

#include "sfm_common.cuh"
#include "small_linalg.cuh"

namespace ctt {

constexpr int kEWarps = 2;
constexpr int kGrid = 1024;

// Monomial index tables of epipolar.py (_MUL11: deg1 x deg1 -> deg2,
// _MUL21: deg2 x deg1 -> deg3).
__constant__ unsigned char kMul11[4][4] = {{0, 3, 4, 6}, {3, 1, 5, 7}, {4, 5, 2, 8}, {6, 7, 8, 9}};
__constant__ unsigned char kMul21[10][4] = {
    {0, 2, 4, 5}, {3, 1, 6, 7}, {10, 13, 16, 17}, {2, 3, 8, 9}, {4, 8, 10, 11},
    {8, 6, 13, 14}, {5, 9, 11, 12}, {9, 7, 14, 15}, {11, 14, 17, 18}, {12, 15, 18, 19}};

__device__ void p11(const float* p, const float* q, float* out) {  // (4) x (4) -> (10)
  for (int k = 0; k < 10; ++k) out[k] = 0.f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) out[kMul11[i][j]] += p[i] * q[j];
}

__device__ void p21_acc(const float* p, const float* q, float sign, float* out) {  // += (10)x(4)
  for (int i = 0; i < 10; ++i)
    for (int j = 0; j < 4; ++j) out[kMul21[i][j]] += sign * p[i] * q[j];
}

// Descending-power polynomial a (deg da) times b (deg db), added with sign.
__device__ void conv_acc(const float* a, int na, const float* b, int nb, float sign, float* out) {
  for (int i = 0; i < na; ++i)
    for (int j = 0; j < nb; ++j) out[i + j] += sign * a[i] * b[j];
}

__device__ __forceinline__ float polyval_homog(const float* c, int n1, float s, float co) {
  float out = 0.f, cp = 1.f;
  for (int k = 0; k < n1; ++k) {
    out = out * s + c[k] * cp;
    cp *= co;
  }
  return out;
}

__device__ __forceinline__ float peval(const float* p, int n1, float z) {
  float out = 0.f;
  for (int k = 0; k < n1; ++k) out = out * z + p[k];
  return out;
}

__device__ __forceinline__ float grid_theta(int g) {
  return (float)g / (float)kGrid * kPiF - kPiF / 2.f;
}

__device__ __forceinline__ float sampson(const float* E, float u1, float v1, float u2, float v2) {
  const float a = E[0] * u1 + E[1] * v1 + E[2];
  const float b = E[3] * u1 + E[4] * v1 + E[5];
  const float c = E[6] * u1 + E[7] * v1 + E[8];
  const float at = E[0] * u2 + E[3] * v2 + E[6];
  const float bt = E[1] * u2 + E[4] * v2 + E[7];
  const float r = u2 * a + v2 * b + c;
  return r * r / fmaxf(a * a + b * b + at * at + bt * bt, 1e-30f);
}

// Per-warp shared state of one 5-point solve.
struct FivePoint {
  float v[kGrid + 1];
  float dv[kGrid + 1];
  float n_poly[11];
  float d_poly[10];
  float bpoly[3][13];  // rows a, b, c of B(z): p1 (4), p2 (4), p3 (5)
  float EB[36];        // null-space basis, EB[(3i + j) * 4 + k]
  float lo[28], hi[28];
  int direct[10], ext[9];
  int n_direct, n_ext;
  float roots[10];
  int n_roots;
  float models[10][9];
};

// Lane 0: null space, elimination and the polynomials.
__device__ void five_point_setup(const float* x1, const float* x2, FivePoint& S) {
  // B = A^T (9 x 5): column r is the constraint row of sample point r.
  float B[9][5];
  for (int r = 0; r < 5; ++r) {
    const float u1 = x1[2 * r], v1 = x1[2 * r + 1], u2 = x2[2 * r], v2 = x2[2 * r + 1];
    const float row[9] = {u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, 1.f};
    for (int c = 0; c < 9; ++c) B[c][r] = row[c];
  }
  // Householder QR of A^T: reflection j acts on rows j..8.
  float V[5][9], scale[5];
  for (int j = 0; j < 5; ++j) {
    float norm = 0.f;
    for (int i = j; i < 9; ++i) norm += B[i][j] * B[i][j];
    norm = sqrtf(norm);
    const float alpha = -(B[j][j] >= 0.f ? 1.f : -1.f) * norm;
    float vn = 0.f;
    for (int i = j; i < 9; ++i) {
      V[j][i] = B[i][j] - (i == j ? alpha : 0.f);
      vn += V[j][i] * V[j][i];
    }
    vn = sqrtf(vn);
    for (int i = j; i < 9; ++i) V[j][i] /= fmaxf(vn, 1e-30f);
    scale[j] = vn > 1e-30f ? 2.f : 0.f;
    for (int c = 0; c < 5; ++c) {
      float w = 0.f;
      for (int i = j; i < 9; ++i) w += V[j][i] * B[i][c];
      for (int i = j; i < 9; ++i) B[i][c] -= scale[j] * V[j][i] * w;
    }
  }
  // Null-space columns: Q e_c for c = 5..8, Q = H0 H1 ... H4.
  for (int k = 0; k < 4; ++k) {
    float x[9];
    for (int i = 0; i < 9; ++i) x[i] = i == 5 + k ? 1.f : 0.f;
    for (int j = 4; j >= 0; --j) {
      float w = 0.f;
      for (int i = j; i < 9; ++i) w += V[j][i] * x[i];
      for (int i = j; i < 9; ++i) x[i] -= scale[j] * V[j][i] * w;
    }
    for (int i = 0; i < 9; ++i) S.EB[i * 4 + k] = x[i];
  }
  const float* EB = S.EB;
#define EBP(i, j) (EB + ((i) * 3 + (j)) * 4)
  float M[10][20];
  for (int r = 0; r < 10; ++r)
    for (int c = 0; c < 20; ++c) M[r][c] = 0.f;
  // det(E) by the first row.
  {
    float m1[10], m2[10];
    const int cols[3][2] = {{1, 2}, {0, 2}, {0, 1}};
    const float sgn[3] = {1.f, -1.f, 1.f};
    for (int c = 0; c < 3; ++c) {
      const int j0 = cols[c][0], j1 = cols[c][1];
      p11(EBP(1, j0), EBP(2, j1), m1);
      p11(EBP(1, j1), EBP(2, j0), m2);
      for (int k = 0; k < 10; ++k) m1[k] -= m2[k];
      p21_acc(m1, EBP(0, c), sgn[c], M[0]);
    }
  }
  // 2 E E^T E - trace(E E^T) E = 0.
  float EEt[3][3][10];
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k) {
      float acc[10] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, t[10];
      for (int j = 0; j < 3; ++j) {
        p11(EBP(i, j), EBP(k, j), t);
        for (int q = 0; q < 10; ++q) acc[q] += t[q];
      }
      for (int q = 0; q < 10; ++q) EEt[i][k][q] = acc[q];
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      for (int k = 0; k < 3; ++k) {
        float L[10];
        for (int q = 0; q < 10; ++q)
          L[q] = 2.f * EEt[i][k][q] -
                 (i == k ? EEt[0][0][q] + EEt[1][1][q] + EEt[2][2][q] : 0.f);
        p21_acc(L, EBP(k, j), 1.f, M[1 + 3 * i + j]);
      }
#undef EBP
  // Gauss-Jordan with partial pivoting: [A1 | A2] -> [I | A1^-1 A2].
  for (int c = 0; c < 10; ++c) {
    int piv = c;
    for (int r = c + 1; r < 10; ++r)
      if (fabsf(M[r][c]) > fabsf(M[piv][c])) piv = r;
    if (piv != c)
      for (int q = 0; q < 20; ++q) {
        const float t = M[c][q];
        M[c][q] = M[piv][q];
        M[piv][q] = t;
      }
    const float inv = 1.f / M[c][c];
    for (int q = c; q < 20; ++q) M[c][q] *= inv;
    for (int r = 0; r < 10; ++r) {
      if (r == c) continue;
      const float f = M[r][c];
      for (int q = c; q < 20; ++q) M[r][q] -= f * M[c][q];
    }
  }
  // Rows of B(z) (brow of epipolar.py); Mred = M[:, 10:].
  for (int i = 0; i < 3; ++i) {
    const float* r1 = M[4 + 2 * i] + 10;
    const float* r2 = M[5 + 2 * i] + 10;
    float* p = S.bpoly[i];
    p[0] = r2[0]; p[1] = r2[1] - r1[0]; p[2] = r2[2] - r1[1]; p[3] = -r1[2];
    p[4] = r2[3]; p[5] = r2[4] - r1[3]; p[6] = r2[5] - r1[4]; p[7] = -r1[5];
    p[8] = r2[6]; p[9] = r2[7] - r1[6]; p[10] = r2[8] - r1[7]; p[11] = r2[9] - r1[8];
    p[12] = -r1[9];
  }
  // det of [[p1a, p2a, p3a], [p1b, p2b, p3b], [p1c, p2c, p3c]]: degree 10.
  const float* a = S.bpoly[0];
  const float* b = S.bpoly[1];
  const float* c = S.bpoly[2];
  float t1[8], t2[8], t3[8], np[11];
  for (int q = 0; q < 8; ++q) t1[q] = t2[q] = t3[q] = 0.f;
  for (int q = 0; q < 11; ++q) np[q] = 0.f;
  conv_acc(b + 4, 4, c + 8, 5, 1.f, t1);   // p2b p3c
  conv_acc(c + 4, 4, b + 8, 5, -1.f, t1);  // - p2c p3b
  conv_acc(t1, 8, a, 4, 1.f, np);          // p1a (...)
  conv_acc(b, 4, c + 8, 5, 1.f, t2);       // p1b p3c
  conv_acc(c, 4, b + 8, 5, -1.f, t2);      // - p1c p3b
  conv_acc(a + 4, 4, t2, 8, -1.f, np);     // - p2a (...)
  conv_acc(b, 4, c + 4, 4, 1.f, t3);       // p1b p2c
  conv_acc(c, 4, b + 4, 4, -1.f, t3);      // - p1c p2b
  conv_acc(a + 8, 5, t3, 7, 1.f, np);      // p3a (...)
  float mx = 0.f;
  for (int q = 0; q < 11; ++q) mx = fmaxf(mx, fabsf(np[q]));
  bool finite = true;
  for (int q = 0; q < 11; ++q) finite = finite && isfinite(np[q]);
  const float inv = 1.f / fmaxf(mx, 1e-30f);
  for (int q = 0; q < 11; ++q) S.n_poly[q] = finite ? np[q] * inv : NAN;
  for (int q = 0; q < 10; ++q) S.d_poly[q] = S.n_poly[q] * (float)(10 - q);
}

// Lanes 0-9: the model of root r (or NaN).
__device__ void five_point_model(const FivePoint& S, int r, float* E) {
  const float z = S.roots[r];
  float al[3], a2[3], b3[3];
  for (int i = 0; i < 3; ++i) {
    al[i] = peval(S.bpoly[i], 4, z);
    a2[i] = peval(S.bpoly[i] + 4, 4, z);
    b3[i] = -peval(S.bpoly[i] + 8, 5, z);
  }
  const float g11 = al[0] * al[0] + al[1] * al[1] + al[2] * al[2];
  const float g12 = al[0] * a2[0] + al[1] * a2[1] + al[2] * a2[2];
  const float g22 = a2[0] * a2[0] + a2[1] * a2[1] + a2[2] * a2[2];
  const float h1 = al[0] * b3[0] + al[1] * b3[1] + al[2] * b3[2];
  const float h2 = a2[0] * b3[0] + a2[1] * b3[1] + a2[2] * b3[2];
  const float det_g = g11 * g22 - g12 * g12;
  const float safe = fabsf(det_g) < 1e-30f ? 1.f : det_g;
  const float xs = (g22 * h1 - g12 * h2) / safe;
  const float ys = (g11 * h2 - g12 * h1) / safe;
  float Y[9], fro = 0.f;
  for (int e = 0; e < 9; ++e) {
    const float* b = S.EB + e * 4;
    Y[e] = xs * b[0] + ys * b[1] + z * b[2] + b[3];
    fro += Y[e] * Y[e];
  }
  const float s = 1.41421356237f / fmaxf(sqrtf(fro), 1e-30f);
  for (int e = 0; e < 9; ++e) Y[e] *= s;
  for (int it = 0; it < 3; ++it) {  // Y <- 1.5 Y - 0.5 Y Y^T Y
    float YYt[9], Z[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        YYt[i * 3 + j] = Y[i * 3] * Y[j * 3] + Y[i * 3 + 1] * Y[j * 3 + 1] + Y[i * 3 + 2] * Y[j * 3 + 2];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Z[i * 3 + j] = YYt[i * 3] * Y[j] + YYt[i * 3 + 1] * Y[3 + j] + YYt[i * 3 + 2] * Y[6 + j];
    for (int e = 0; e < 9; ++e) Y[e] = 1.5f * Y[e] - 0.5f * Z[e];
  }
  const bool ok = fabsf(det_g) >= 1e-30f;
  for (int e = 0; e < 9; ++e) E[e] = ok ? Y[e] : NAN;
}

__global__ void essential_propose_score_kernel(int n, int k, float max_sq,
                                               const float* __restrict__ max_sq_arr,
                                               const float* __restrict__ x1,
                                               const float* __restrict__ x2,
                                               const unsigned char* __restrict__ mask,
                                               const int* __restrict__ samples,
                                               const unsigned char* __restrict__ active,
                                               float* __restrict__ models_out,
                                               int* __restrict__ counts_out,
                                               unsigned long long* __restrict__ best) {
  __shared__ FivePoint shared[kEWarps];
  const int pair = blockIdx.y;
  if (active != nullptr && !active[pair]) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sample = blockIdx.x * kEWarps + warp;
  if (sample >= k) return;  // whole warps leave together
  x1 += (size_t)pair * n * 2;
  x2 += (size_t)pair * n * 2;
  mask += (size_t)pair * n;
  samples += (size_t)pair * k * 5;
  models_out += (size_t)pair * k * 90;
  counts_out += (size_t)pair * k * 10;
  best += pair;
  if (max_sq_arr != nullptr) max_sq = max_sq_arr[pair];
  FivePoint& S = shared[warp];
  if (lane == 0) {
    float s1[10], s2[10];
    for (int r = 0; r < 5; ++r) {
      const int row = samples[sample * 5 + r];
      s1[2 * r] = x1[2 * row];
      s1[2 * r + 1] = x1[2 * row + 1];
      s2[2 * r] = x2[2 * row];
      s2[2 * r + 1] = x2[2 * row + 1];
    }
    five_point_setup(s1, s2, S);
  }
  __syncwarp();
  // The polynomial and its derivative on the grid.
  for (int g = lane; g <= kGrid; g += 32) {
    const float th = grid_theta(g);
    const float sn = sinf(th), cs = cosf(th);
    S.v[g] = polyval_homog(S.n_poly, 11, sn, cs);
    S.dv[g] = polyval_homog(S.d_poly, 10, sn, cs);
  }
  __syncwarp();
  // First 10 sign-change cells and first 9 extremum-only cells, in order.
  const unsigned lt = (1u << lane) - 1u;
  int nd = 0, ne = 0;
  for (int base = 0; base < kGrid; base += 32) {
    const int c = base + lane;
    const bool sc = S.v[c] * S.v[c + 1] < 0.f;
    const bool ex = S.dv[c] * S.dv[c + 1] < 0.f && !sc;
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
  float e_mid = 0.f;
  bool split = false;
  if (lane < ne) {
    const int c = S.ext[lane];
    float lo = grid_theta(c), hi = grid_theta(c + 1);
    const float s_dlo = sgnf(S.dv[c]);
    for (int it = 0; it < 24; ++it) {
      const float mid = 0.5f * (lo + hi);
      const bool right = sgnf(polyval_homog(S.d_poly, 10, sinf(mid), cosf(mid))) == s_dlo;
      lo = right ? mid : lo;
      hi = right ? hi : mid;
    }
    e_mid = 0.5f * (lo + hi);
    const float v_mid = polyval_homog(S.n_poly, 11, sinf(e_mid), cosf(e_mid));
    split = sgnf(v_mid) != sgnf(S.v[c]) && v_mid != 0.f;
  }
  // Brackets: slots 0-9 direct cells, 10-18 (lo, mid), 19-27 (mid, hi).
  if (lane < nd) {
    S.lo[lane] = grid_theta(S.direct[lane]);
    S.hi[lane] = grid_theta(S.direct[lane] + 1);
  }
  if (lane < 9) {
    const int c = lane < ne ? S.ext[lane] : 0;
    S.lo[10 + lane] = grid_theta(c);
    S.hi[10 + lane] = e_mid;
    S.lo[19 + lane] = e_mid;
    S.hi[19 + lane] = grid_theta(c + 1);
  }
  const unsigned split_bits = __ballot_sync(kFull, split);
  __syncwarp();
  const bool valid = lane < 10 ? lane < nd
                               : (lane < 28 && ((split_bits >> ((lane - 10) % 9)) & 1u) != 0u);
  float root = 0.f;
  if (valid) {
    float lo = S.lo[lane], hi = S.hi[lane];
    const float s_lo = sgnf(polyval_homog(S.n_poly, 11, sinf(lo), cosf(lo)));
    for (int it = 0; it < 28; ++it) {
      const float mid = 0.5f * (lo + hi);
      const bool right = sgnf(polyval_homog(S.n_poly, 11, sinf(mid), cosf(mid))) == s_lo;
      lo = right ? mid : lo;
      hi = right ? hi : mid;
    }
    root = tanf(0.5f * (lo + hi));
  }
  // The first 10 valid brackets, in slot order.
  const unsigned vb = __ballot_sync(kFull, valid);
  const int pos = __popc(vb & lt);
  if (valid && pos < 10) S.roots[pos] = root;
  if (lane == 0) S.n_roots = min(__popc(vb), 10);
  __syncwarp();
  if (lane < 10) {
    float E[9];
    if (lane < S.n_roots) {
      five_point_model(S, lane, E);
    } else {
      for (int e = 0; e < 9; ++e) E[e] = NAN;
    }
    for (int e = 0; e < 9; ++e) S.models[lane][e] = E[e];
  }
  __syncwarp();
  // Score the 10 models on all rows.
  bool finite[10];
  for (int r = 0; r < 10; ++r) finite[r] = all_finite(S.models[r], 9);
  int cnt[10];
  for (int r = 0; r < 10; ++r) cnt[r] = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    const bool ok = i < n && mask[i];
    float u1 = 0.f, v1 = 0.f, u2 = 0.f, v2 = 0.f;
    if (ok) {
      u1 = x1[2 * i];
      v1 = x1[2 * i + 1];
      u2 = x2[2 * i];
      v2 = x2[2 * i + 1];
    }
    for (int r = 0; r < 10; ++r) {
      const bool in = ok && finite[r] && sampson(S.models[r], u1, v1, u2, v2) <= max_sq;
      cnt[r] += __popc(__ballot_sync(kFull, in));
    }
  }
  if (lane < 10) {
    int c = 0;
    for (int r = 0; r < 10; ++r) c = r == lane ? cnt[r] : c;
    const int idx = sample * 10 + lane;
    for (int e = 0; e < 9; ++e) models_out[idx * 9 + e] = S.models[lane][e];
    counts_out[idx] = c;
    atomicMax(best, pack_best(c, idx));
  }
}

constexpr int kRefitThreads = 256;

__device__ __forceinline__ bool e_inlier(const float* E, const float* x1, const float* x2,
                                         const unsigned char* mask, int i, float max_sq) {
  return mask[i] && sampson(E, x1[2 * i], x1[2 * i + 1], x2[2 * i], x2[2 * i + 1]) <= max_sq;
}

__global__ void essential_refit_kernel(int n, float max_sq, const float* __restrict__ max_sq_arr,
                                       int count_in, const int* __restrict__ count_arr,
                                       const float* __restrict__ x1, const float* __restrict__ x2,
                                       const unsigned char* __restrict__ mask,
                                       const float* __restrict__ model_in,
                                       float* __restrict__ model_out, int* __restrict__ count_out) {
  __shared__ float scratch[32 * 45];
  __shared__ float refined[9];
  __shared__ bool refined_ok;
  const int pair = blockIdx.x;
  x1 += (size_t)pair * n * 2;
  x2 += (size_t)pair * n * 2;
  mask += (size_t)pair * n;
  model_in += pair * 9;
  model_out += pair * 9;
  count_out += pair;
  if (max_sq_arr != nullptr) max_sq = max_sq_arr[pair];
  if (count_arr != nullptr) count_in = count_arr[pair];
  float m[9];
  for (int e = 0; e < 9; ++e) m[e] = model_in[e];
  // Hartley normalization of both point sets over the inliers.
  float c[5] = {0.f, 0.f, 0.f, 0.f, 0.f};  // W, sum x1, sum x2
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!e_inlier(m, x1, x2, mask, i, max_sq)) continue;
    c[0] += 1.f;
    c[1] += x1[2 * i];
    c[2] += x1[2 * i + 1];
    c[3] += x2[2 * i];
    c[4] += x2[2 * i + 1];
  }
  block_sum<5>(c, scratch);
  const float W = fmaxf(c[0], 1e-30f);
  const float c1x = c[1] / W, c1y = c[2] / W, c2x = c[3] / W, c2y = c[4] / W;
  float d[2] = {0.f, 0.f};
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!e_inlier(m, x1, x2, mask, i, max_sq)) continue;
    const float a = x1[2 * i] - c1x, b = x1[2 * i + 1] - c1y;
    const float e = x2[2 * i] - c2x, f = x2[2 * i + 1] - c2y;
    d[0] += sqrtf(a * a + b * b);
    d[1] += sqrtf(e * e + f * f);
  }
  block_sum<2>(d, scratch);
  const float s1 = 1.41421356237f / fmaxf(d[0] / W, 1e-30f);
  const float s2 = 1.41421356237f / fmaxf(d[1] / W, 1e-30f);
  // A^T A over the inliers (upper triangle, 45 entries).
  float ata[45];
  for (int q = 0; q < 45; ++q) ata[q] = 0.f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (!e_inlier(m, x1, x2, mask, i, max_sq)) continue;
    const float u1 = (x1[2 * i] - c1x) * s1, v1 = (x1[2 * i + 1] - c1y) * s1;
    const float u2 = (x2[2 * i] - c2x) * s2, v2 = (x2[2 * i + 1] - c2y) * s2;
    const float a[9] = {u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, 1.f};
    int q = 0;
    for (int r = 0; r < 9; ++r)
      for (int s = r; s < 9; ++s) ata[q++] += a[r] * a[s];
  }
  block_sum<45>(ata, scratch);
  if (threadIdx.x == 0) {
    float A[81], f[9];
    int q = 0;
    for (int r = 0; r < 9; ++r)
      for (int s = r; s < 9; ++s) {
        A[r * 9 + s] = ata[q];
        A[s * 9 + r] = ata[q++];
      }
    smallest_eigvec<9>(A, f, 10);
    // E = T2^T F T1 with T = [[s, 0, -s cx], [0, s, -s cy], [0, 0, 1]].
    const float T1[9] = {s1, 0.f, -s1 * c1x, 0.f, s1, -s1 * c1y, 0.f, 0.f, 1.f};
    const float T2[9] = {s2, 0.f, -s2 * c2x, 0.f, s2, -s2 * c2y, 0.f, 0.f, 1.f};
    float FT1[9], E[9];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        FT1[i * 3 + j] = f[i * 3] * T1[j] + f[i * 3 + 1] * T1[3 + j] + f[i * 3 + 2] * T1[6 + j];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        E[i * 3 + j] = T2[i] * FT1[j] + T2[3 + i] * FT1[3 + j] + T2[6 + i] * FT1[6 + j];
    // Singular values (1, 1, 0): E = u0 v0^T + u1 v1^T.
    float u0[3], u1[3], v0[3], v1[3];
    svd3x3_top2(E, u0, u1, v0, v1);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) refined[i * 3 + j] = u0[i] * v0[j] + u1[i] * v1[j];
    refined_ok = all_finite(refined, 9);
  }
  __syncthreads();
  float r[9];
  for (int e = 0; e < 9; ++e) r[e] = refined[e];
  float cnt[1] = {0.f};
  if (refined_ok)
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      if (e_inlier(r, x1, x2, mask, i, max_sq)) cnt[0] += 1.f;
  block_sum<1>(cnt, scratch);
  if (threadIdx.x == 0) {
    const int count_r = (int)cnt[0];
    const bool take = refined_ok && count_r > count_in;
    for (int e = 0; e < 9; ++e) model_out[e] = take ? r[e] : m[e];
    count_out[0] = take ? count_r : count_in;
  }
}

__global__ void essential_inliers_kernel(int n, float max_sq, const float* __restrict__ max_sq_arr,
                                         const float* __restrict__ x1,
                                         const float* __restrict__ x2,
                                         const unsigned char* __restrict__ mask,
                                         const float* __restrict__ model,
                                         unsigned char* __restrict__ inl) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int pair = blockIdx.y;
  if (i >= n) return;
  if (max_sq_arr != nullptr) max_sq = max_sq_arr[pair];
  float m[9];
  for (int e = 0; e < 9; ++e) m[e] = model[pair * 9 + e];
  const size_t off = (size_t)pair * n;
  inl[off + i] = e_inlier(m, x1 + 2 * off, x2 + 2 * off, mask + off, i, max_sq);
}

}  // namespace ctt

extern "C" int essential_propose_score_f32(int b, int n, int k, float max_sq,
                                           const float* max_sq_arr, const float* x1,
                                           const float* x2, const unsigned char* mask,
                                           const int* samples, const unsigned char* active,
                                           float* models, int* counts, unsigned long long* best,
                                           void* stream) {
  using namespace ctt;
  if (b == 0 || k == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((k + kEWarps - 1) / kEWarps), (unsigned)b);
  essential_propose_score_kernel<<<grid, 32 * kEWarps, 0, (cudaStream_t)stream>>>(
      n, k, max_sq, max_sq_arr, x1, x2, mask, samples, active, models, counts, best);
  return (int)cudaGetLastError();
}

extern "C" int essential_refit_f32(int b, int n, float max_sq, const float* max_sq_arr,
                                   int count_in, const int* count_arr, const float* x1,
                                   const float* x2, const unsigned char* mask,
                                   const float* model_in, float* model_out, int* count_out,
                                   void* stream) {
  using namespace ctt;
  if (b == 0) return (int)cudaGetLastError();
  essential_refit_kernel<<<b, kRefitThreads, 0, (cudaStream_t)stream>>>(
      n, max_sq, max_sq_arr, count_in, count_arr, x1, x2, mask, model_in, model_out, count_out);
  return (int)cudaGetLastError();
}

extern "C" int essential_inliers_f32(int b, int n, float max_sq, const float* max_sq_arr,
                                     const float* x1, const float* x2, const unsigned char* mask,
                                     const float* model, unsigned char* inl, void* stream) {
  using namespace ctt;
  if (b == 0 || n == 0) return (int)cudaGetLastError();
  const dim3 grid((unsigned)((n + 255) / 256), (unsigned)b);
  essential_inliers_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(n, max_sq, max_sq_arr, x1, x2,
                                                                   mask, model, inl);
  return (int)cudaGetLastError();
}
