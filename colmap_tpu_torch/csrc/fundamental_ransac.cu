// K11 fundamental_ransac: the batches, the refit and the fit of the
// fundamental-matrix LO-RANSAC, over a block of pairs.
//
// Replaces colmap_tpu/estimators/two_view_geometry.py _ransac_f (l.101) with
// the body of optim/ransac.py ransac (l.78) and what it runs:
// estimators/solvers/epipolar.py fundamental_seven_point (l.471) and
// fundamental_eight_point (l.96, the LO refit and the fit on the E inliers
// of estimators/two_view_batch.py l.84), optim/small_linalg.py
// nullspace_small (l.208), optim/polynomial.py solve_cubic, and
// geometry/essential.py squared_epipolar_line_distance (l.164); the pair
// axis is that of estimators/two_view_batch.py _verify_block (l.62).
//
// The kernels are those of two_view_ransac.cuh over the model below:
//   solve: the 7 sample points are Hartley-normalized in float32 (pixel
//     coordinates are ~1e3), the 2-dimensional null space of the 7 x 9
//     constraint matrix comes from Householder QR, det(a F1 + (1 - a) F2) is
//     a cubic in a, interpolated at a = 0, 1, 2, -1 and solved in closed
//     form; each real root gives T2^T F T1 of unit Frobenius norm. The three
//     slots of a sample keep the layout of the plain version (one real
//     root: slot 0; complex roots: NaN), so a best index means the same.
//   residual: the squared distance of x2 to the line F x1.
//   refit: the weighted 8-point; rank 2 is enforced by removing the
//     component along the smallest right singular vector.
//
// Bound on the card: operations. A sample costs a few thousand flops on lane
// 0 and 3 x N residuals of ~20 flops on the warp; a block of 64 pairs x 128
// samples x 8192 rows is ~4 Gflop a launch, tens of microseconds at the
// float32 peak. Lane 0's serial solve leaves 31 lanes idle and the host's
// read per batch leaves the card idle between launches; both are later work.
#include <cuda_runtime.h>

#include "epipolar.cuh"
#include "two_view_ransac.cuh"

namespace ctt {

__device__ __forceinline__ float det3(const float* M) {
  return M[0] * (M[4] * M[8] - M[5] * M[7]) - M[1] * (M[3] * M[8] - M[5] * M[6]) +
         M[2] * (M[3] * M[7] - M[4] * M[6]);
}

struct Fundamental {
  static constexpr int kSample = 7, kSolutions = 3;
  static constexpr int kDim = 2;
  static constexpr bool kHartley = true;

  __device__ static void solve(float* s1, float* s2, float* models) {
    const Hartley T1 = hartley_sample<7>(s1), T2 = hartley_sample<7>(s2);
    float B[9][7];
    for (int r = 0; r < 7; ++r) {
      const float u1 = s1[2 * r], v1 = s1[2 * r + 1], u2 = s2[2 * r], v2 = s2[2 * r + 1];
      const float row[9] = {u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, 1.f};
      for (int c = 0; c < 9; ++c) B[c][r] = row[c];
    }
    float ns[18];
    nullspace9<7, 2>(B, ns);
    float f1[9], f2[9];
    for (int e = 0; e < 9; ++e) {
      f1[e] = ns[2 * e];
      f2[e] = ns[2 * e + 1];
    }
    // g(a) = det(a F1 + (1 - a) F2) at a = 0, 1, 2, -1.
    float g[4];
    const float nodes[4] = {0.f, 1.f, 2.f, -1.f};
    for (int q = 0; q < 4; ++q) {
      float M[9];
      for (int e = 0; e < 9; ++e) M[e] = nodes[q] * f1[e] + (1.f - nodes[q]) * f2[e];
      g[q] = det3(M);
    }
    // c3 a^3 + c2 a^2 + c1 a + c0 through the four values.
    const float c0 = g[0];
    const float c2 = 0.5f * (g[1] + g[3]) - c0;
    const float h = 0.5f * (g[1] - g[3]);
    const float c3 = (g[2] - 4.f * c2 - c0 - 2.f * h) / 6.f;
    const float c1 = h - c3;
    const float sa = fabsf(c3) < 1e-30f ? 1.f : c3;
    float roots[3];
    bool ok[3];
    solve_cubic_monic(c2 / sa, c1 / sa, c0 / sa, roots, ok);
    for (int q = 0; q < 3; ++q) {
      float* F = models + 9 * q;
      for (int e = 0; e < 9; ++e) F[e] = roots[q] * f1[e] + (1.f - roots[q]) * f2[e];
      apply_t2t_m_t1(T1, T2, F);
      unit_frobenius(F);
      if (!ok[q])
        for (int e = 0; e < 9; ++e) F[e] = NAN;
    }
  }

  __device__ __forceinline__ static float residual(const float* F, float u1, float v1, float u2,
                                                   float v2) {
    return epipolar_line_sq(F, u1, v1, u2, v2);
  }

  __device__ __forceinline__ static void accumulate(float u1, float v1, float u2, float v2,
                                                    float* ata) {
    const float a[9] = {u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, 1.f};
    int q = 0;
    for (int r = 0; r < 9; ++r)
      for (int s = r; s < 9; ++s) ata[q++] += a[r] * a[s];
  }

  __device__ static void finish(const float* f, const Hartley& T1, const Hartley& T2,
                                float* model) {
    // Rank 2: F - (F v2) v2^T, v2 the smallest right singular vector.
    float FtF[9], v2[3], Fv[3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        FtF[i * 3 + j] = f[i] * f[j] + f[3 + i] * f[3 + j] + f[6 + i] * f[6 + j];
    smallest_eigvec<3>(FtF, v2, 8);
    for (int i = 0; i < 3; ++i) Fv[i] = f[i * 3] * v2[0] + f[i * 3 + 1] * v2[1] + f[i * 3 + 2] * v2[2];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) model[i * 3 + j] = f[i * 3 + j] - Fv[i] * v2[j];
    apply_t2t_m_t1(T1, T2, model);
    unit_frobenius(model);
  }
};

}  // namespace ctt

CTT_TWO_VIEW_ENTRIES(fundamental, ctt::Fundamental, 4)

extern "C" int fundamental_fit_f32(int b, int n, const float* x1, const float* x2,
                                   const unsigned char* rows, float* model_out, void* stream) {
  if (b == 0) return (int)cudaGetLastError();
  ctt::two_view_refit_kernel<ctt::Fundamental, true, false>
      <<<b, ctt::kTwoViewRefitThreads, 0, (cudaStream_t)stream>>>(
          n, 0.f, nullptr, 0, nullptr, x1, x2, rows, nullptr, model_out, nullptr, 0.f, nullptr,
          nullptr);
  return (int)cudaGetLastError();
}
