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
//   solve: each of the 4 ray pairs adds the three rows of
//     [r2]_x H r1 = 0, c_k (x) r1 with c_k the rows of [r2]_x, to the 9 x 9
//     normal matrix; its smallest eigenvector (Jacobi, small_linalg.cuh) is
//     H, scaled to unit Frobenius norm. The plain version takes the same
//     route: the 12 x 9 system is overdetermined, so its smallest right
//     singular vector is the smallest eigenvector of A^T A.
//   residual: 2 (1 - cos angle(H r1, r2)), written as |h - q|^2 with h and q
//     the unit vectors along H r1 and r2: the same value, without the
//     float32 cancellation of 1 - cos at thresholds of ~1e-5 rad^2.
//   refit: the weighted N-ray DLT, no conditioning (unit rays).
// The pair axis is K12's.
//
// Bound on the card: operations, as K12: a sample costs ~10^4 flops on lane
// 0 (the 9 x 9 Jacobi) and N residuals of ~25 flops on the warp.
#include <cfloat>
#include <cuda_runtime.h>

#include "two_view_ransac.cuh"

namespace ctt {

struct HomographyRays {
  static constexpr int kSample = 4, kSolutions = 1;
  static constexpr int kDim = 3;
  static constexpr bool kHartley = false;

  // The three rows c_k (x) r1 of [r2]_x H r1 = 0, added to the normal matrix.
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

  __device__ static void solve(float* s1, float* s2, float* model) {
    float ata[45];
    for (int q = 0; q < 45; ++q) ata[q] = 0.f;
    for (int r = 0; r < 4; ++r) accumulate(s1 + 3 * r, s2 + 3 * r, ata);
    float A[81], f[9];
    int q = 0;
    for (int r = 0; r < 9; ++r)
      for (int s = r; s < 9; ++s) {
        A[r * 9 + s] = ata[q];
        A[s * 9 + r] = ata[q++];
      }
    smallest_eigvec<9>(A, f, 10);
    finish(f, Hartley{}, Hartley{}, model);
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

CTT_TWO_VIEW_ENTRIES(spherical_h, ctt::HomographyRays, 4)
