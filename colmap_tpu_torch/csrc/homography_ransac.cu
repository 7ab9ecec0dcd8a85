// K12 homography_ransac: the batches and the refit of the homography
// LO-RANSAC, over a block of pairs.
//
// Replaces colmap_tpu/estimators/two_view_geometry.py _ransac_h (l.153) with
// the body of optim/ransac.py ransac (l.78) and what it runs:
// estimators/solvers/epipolar.py homography_dlt (l.515, the 4-point solve
// and the weighted N-point refit) and homography_transfer_error (l.541),
// optim/small_linalg.py nullspace_small (l.208); the pair axis is that of
// estimators/two_view_batch.py _verify_block (l.62).
//
// The kernels are those of two_view_ransac.cuh over the model below:
//   solve: the 4 sample points are Hartley-normalized in float32, the null
//     vector of the 8 x 9 DLT matrix comes from Householder QR, and
//     H = T2^-1 Hn T1 is scaled to unit Frobenius norm (one slot a sample).
//   residual: the squared forward transfer error |H x1 - x2|^2, infinite
//     where the transferred point lies at infinity (|w| < 1e-12).
//   refit: the weighted N-point DLT; each row to fit adds its two DLT rows
//     to the 9 x 9 normal matrix.
//
// Bound on the card: operations, as K11: a sample costs a few thousand
// flops on lane 0 and N residuals of ~20 flops on the warp. On a scene that
// no plane explains, H never reaches the early-exit support and runs all
// 10000 trials (79 batches of 128), so it is the RANSAC with the most
// launches and host reads of a verification block.
#include <cfloat>
#include <cuda_runtime.h>

#include "two_view_ransac.cuh"

namespace ctt {

struct Homography {
  static constexpr int kSample = 4, kSolutions = 1;

  // The two DLT rows of a normalized correspondence.
  __device__ __forceinline__ static void dlt_rows(float u1, float v1, float u2, float v2,
                                                  float* r1, float* r2) {
    const float a[9] = {-u1, -v1, -1.f, 0.f, 0.f, 0.f, u2 * u1, u2 * v1, u2};
    const float b[9] = {0.f, 0.f, 0.f, -u1, -v1, -1.f, v2 * u1, v2 * v1, v2};
    for (int c = 0; c < 9; ++c) {
      r1[c] = a[c];
      r2[c] = b[c];
    }
  }

  __device__ static void solve(float* s1, float* s2, float* model) {
    const Hartley T1 = hartley_sample<4>(s1), T2 = hartley_sample<4>(s2);
    float B[9][8];
    for (int r = 0; r < 4; ++r) {
      float r1[9], r2[9];
      dlt_rows(s1[2 * r], s1[2 * r + 1], s2[2 * r], s2[2 * r + 1], r1, r2);
      for (int c = 0; c < 9; ++c) {
        B[c][r] = r1[c];
        B[c][4 + r] = r2[c];
      }
    }
    nullspace9<8, 1>(B, model);
    finish(model, T1, T2, model);
  }

  __device__ __forceinline__ static float residual(const float* H, float u1, float v1, float u2,
                                                   float v2) {
    const float hx = H[0] * u1 + H[1] * v1 + H[2];
    const float hy = H[3] * u1 + H[4] * v1 + H[5];
    const float w = H[6] * u1 + H[7] * v1 + H[8];
    if (fabsf(w) < 1e-12f) return INFINITY;
    const float dx = hx / w - u2, dy = hy / w - v2;
    return dx * dx + dy * dy;
  }

  __device__ __forceinline__ static void accumulate(float u1, float v1, float u2, float v2,
                                                    float* ata) {
    float a[9], b[9];
    dlt_rows(u1, v1, u2, v2, a, b);
    int q = 0;
    for (int r = 0; r < 9; ++r)
      for (int s = r; s < 9; ++s) ata[q++] += a[r] * a[s] + b[r] * b[s];
  }

  __device__ static void finish(const float* h, const Hartley& T1, const Hartley& T2,
                                float* model) {
    float H[9];
    for (int e = 0; e < 9; ++e) H[e] = h[e];
    apply_t2inv_m_t1(T1, T2, H);
    unit_frobenius(H);
    for (int e = 0; e < 9; ++e) model[e] = H[e];
  }
};

}  // namespace ctt

CTT_TWO_VIEW_ENTRIES(homography, ctt::Homography, 4)
