// K33 spherical_h_ransac: the batches and the refit of the ray-space
// homography LO-RANSAC (spherical, 360-degree cameras).
//
// Replaces colmap_tpu/estimators/spherical.py _ransac_h_rays (l.103) with the
// body of optim/ransac.py ransac (l.78) and what it runs:
// estimators/solvers/epipolar.py homography_ray_dlt (l.151, the 4-ray solve
// and the weighted N-ray refit) and spherical.py
// homography_ray_angular_error (l.72).
//
// The kernels are those of two_view_ransac.cuh (K12's) over the model below,
// on rays x1, x2 (B, N, 3):
//   solve: each of the 4 ray pairs gives the three rows c_k (x) r1 of
//     [r2]_x H r1 = 0, c_k the rows of [r2]_x. Since r2^T [r2]_x = 0, the
//     sum of r2_k times row k vanishes, so dropping the row k* of largest
//     |r2_k| (the first on ties) leaves two rows that span the same space.
//     The 8 kept rows have exactly the null space of the plain version's 12
//     (its smallest right singular vector); Householder QR of the 8 x 9
//     matrix in registers (nullspace9<8, 1>, K12's route) gives it, scaled
//     to unit Frobenius norm. Without the normal matrix the solve keeps A's
//     condition number instead of its square.
//   residual: 2 (1 - cos angle(H r1, r2)), written as |h - q|^2 with h and q
//     the unit vectors along H r1 and r2: the same value, without the
//     float32 cancellation of 1 - cos at thresholds of ~1e-5 rad^2.
//   refit: the weighted N-ray DLT, no conditioning (unit rays).
// The pair axis is K12's.
//
// Bound on the card: operations, as K12: a sample costs ~2.4e3 flops (the 8
// rows and the Householder QR) and N residuals of ~45 flops on the warp.
// The solve's arrays sit in local memory; solved by lane 0 of each warp,
// each sample's words took their own cache lines, and the solves cost as
// much as the score pass over 8192 rays. So the model sets kLaneSolve: a
// block of 8 warps has its 8 samples solved side by side by lanes 0-7 of
// warp 0, then each warp scores one: the same bits as lane 0's solves, and
// on the H100 faster than them and than blocks of 32 warps.
#include <cfloat>
#include <cuda_runtime.h>

#include "two_view_ransac.cuh"

namespace ctt {

struct HomographyRays {
  static constexpr int kSample = 4, kSolutions = 1;
  static constexpr int kDim = 3;
  static constexpr bool kHartley = false;
  // The block's samples are solved one a lane (two_view_ransac.cuh).
  static constexpr bool kLaneSolve = true;

  // The three rows c_k (x) r1 of [r2]_x H r1 = 0, added to the normal matrix
  // (the refit).
  __device__ __forceinline__ static void accumulate(const float* a, const float* b, float* ata) {
    const float c[3][3] = {{0.f, -b[2], b[1]}, {b[2], 0.f, -b[0]}, {-b[1], b[0], 0.f}};
    for (int k = 0; k < 3; ++k) {
      float row[9];
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) row[3 * i + j] = c[k][i] * a[j];
      int q = 0;
      for (int r = 0; r < 9; ++r)
        for (int s = r; s < 9; ++s) ata[q++] += row[r] * row[s];
    }
  }

  // Columns 2 pr and 2 pr + 1 of B = A^T: the two rows c_k (x) a of [b]_x
  // other than k* = argmax_k |b_k| (the first on ties), in the order of k.
  __device__ __forceinline__ static void kept_rows(const float* a, const float* b, int pr,
                                                   float (*B)[8]) {
    const float m0 = fabsf(b[0]), m1 = fabsf(b[1]), m2 = fabsf(b[2]);
    const int ks = m1 > m0 ? (m2 > m1 ? 2 : 1) : (m2 > m0 ? 2 : 0);
    const float c0[3] = {0.f, -b[2], b[1]}, c1[3] = {b[2], 0.f, -b[0]},
                c2[3] = {-b[1], b[0], 0.f};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float u = ks == 0 ? c1[i] : c0[i];
      const float v = ks == 2 ? c1[i] : c2[i];
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        B[3 * i + j][2 * pr] = u * a[j];
        B[3 * i + j][2 * pr + 1] = v * a[j];
      }
    }
  }

  __device__ static void solve(float* s1, float* s2, float* model) {
    float B[9][8];
#pragma unroll
    for (int pr = 0; pr < 4; ++pr) kept_rows(s1 + 3 * pr, s2 + 3 * pr, pr, B);
    nullspace9<8, 1>(B, model);
    unit_frobenius(model);
  }

  __device__ __forceinline__ static float residual(const float* H, const float* a,
                                                   const float* b) {
    float h[3];
    for (int i = 0; i < 3; ++i) h[i] = H[3 * i] * a[0] + H[3 * i + 1] * a[1] + H[3 * i + 2] * a[2];
    const float hn = 1.f / fmaxf(sqrtf(h[0] * h[0] + h[1] * h[1] + h[2] * h[2]), 1e-20f);
    const float bn = 1.f / fmaxf(sqrtf(b[0] * b[0] + b[1] * b[1] + b[2] * b[2]), 1e-20f);
    float d2 = 0.f;
    for (int i = 0; i < 3; ++i) {
      const float d = h[i] * hn - b[i] * bn;
      d2 += d * d;
    }
    return d2;
  }

  __device__ static void finish(const float* f, const Hartley&, const Hartley&, float* model) {
    for (int e = 0; e < 9; ++e) model[e] = f[e];
    unit_frobenius(model);
  }
};

}  // namespace ctt

CTT_TWO_VIEW_ENTRIES(spherical_h, ctt::HomographyRays, 8)
