// K46 degensac: DEGENSAC's plane-and-parallax hypotheses and their support.
//
// Replaces the hypothesis and scoring half of
// colmap_tpu/estimators/degensac.py degensac_recover_f (l.70-110):
// fundamental_from_plane_and_parallax (l.47) on K pairs of off-plane rows
// and squared_epipolar_line_distance (geometry/essential.py) on all N rows.
// The refit of the best (l.112-118, the weighted 8-point) and the final
// inlier mask run on K11's refit and inliers entries.
//
// degensac_propose_score: one warp per hypothesis, four a block. Lane 0
// forms the hypothesis of rows (ia, ib): the parallax lines l = (H x1) x x2
// of both rows, each scaled to unit length (the normalized F does not
// depend on their scale, and pixel coordinates of ~1e3 would take the
// epipole e' = la x lb near float32's range), e' = la x lb, and F = [e']x H
// of unit Frobenius norm. The warp scores F on all N rows in one strided
// pass (epipolar.cuh, K11's residual: the same inlier test row for row),
// counts with __popc(__ballot_sync), writes F and its count (0 where ia =
// ib or F is not finite) and keeps the best with one 64-bit atomicMax on
// (count, index): the first hypothesis of largest support, as jnp.argmax.
//
// Bound on the card: operations. A hypothesis costs ~150 flops on lane 0
// and N residuals of ~20 flops on the warp; its rows (20 bytes each) come
// from L2 after the first warps read them, so 256 hypotheses x 8192 rows is
// ~4e7 flops against 0.16 MB of inputs.
#include <cuda_runtime.h>

#include "epipolar.cuh"
#include "sfm_common.cuh"

namespace ctt {

constexpr int kDegensacWarps = 4;

__device__ __forceinline__ void cross3(const float* a, const float* b, float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void unit3(float* v) {
  const float inv = 1.f / fmaxf(sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]), 1e-30f);
  for (int i = 0; i < 3; ++i) v[i] *= inv;
}

// The parallax line (H x1) x x2 of row i, unit length.
__device__ __forceinline__ void parallax_line(const float* H, const float* x1, const float* x2,
                                              int i, float* l) {
  const float p[3] = {x1[2 * i], x1[2 * i + 1], 1.f};
  const float q[3] = {x2[2 * i], x2[2 * i + 1], 1.f};
  float hp[3];
  for (int r = 0; r < 3; ++r) hp[r] = H[3 * r] * p[0] + H[3 * r + 1] * p[1] + H[3 * r + 2] * p[2];
  cross3(hp, q, l);
  unit3(l);
}

__global__ void degensac_propose_score_kernel(int n, int k, float max_sq,
                                              const float* __restrict__ x1,
                                              const float* __restrict__ x2,
                                              const unsigned char* __restrict__ mask,
                                              const float* __restrict__ Hg,
                                              const int* __restrict__ ia,
                                              const int* __restrict__ ib,
                                              float* __restrict__ models_out,
                                              int* __restrict__ counts_out,
                                              unsigned long long* __restrict__ best) {
  __shared__ float models[kDegensacWarps][9];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.x * kDegensacWarps + warp;
  if (h >= k) return;  // whole warps leave together
  const int a = ia[h], b = ib[h];
  if (lane == 0) {
    float H[9];
    for (int e = 0; e < 9; ++e) H[e] = Hg[e];
    float la[3], lb[3], e2[3];
    parallax_line(H, x1, x2, a, la);
    parallax_line(H, x1, x2, b, lb);
    cross3(la, lb, e2);
    // [e']x H, row-major.
    const float ex[9] = {0.f, -e2[2], e2[1], e2[2], 0.f, -e2[0], -e2[1], e2[0], 0.f};
    float F[9], nrm = 0.f;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        F[3 * i + j] = ex[3 * i] * H[j] + ex[3 * i + 1] * H[3 + j] + ex[3 * i + 2] * H[6 + j];
        nrm += F[3 * i + j] * F[3 * i + j];
      }
    const float inv = 1.f / fmaxf(sqrtf(nrm), 1e-30f);
    for (int e = 0; e < 9; ++e) models[warp][e] = F[e] * inv;
  }
  __syncwarp();
  float F[9];
  for (int e = 0; e < 9; ++e) F[e] = models[warp][e];
  const bool valid = a != b && all_finite(F, 9);
  int cnt = 0;
  for (int base = 0; base < n; base += 32) {
    const int i = base + lane;
    bool in = false;
    if (valid && i < n && mask[i])
      in = epipolar_line_sq(F, x1[2 * i], x1[2 * i + 1], x2[2 * i], x2[2 * i + 1]) <= max_sq;
    cnt += __popc(__ballot_sync(kFull, in));
  }
  if (lane < 9) models_out[(size_t)h * 9 + lane] = F[lane];
  if (lane == 0) {
    counts_out[h] = cnt;
    atomicMax(best, pack_best(cnt, h));
  }
}

}  // namespace ctt

extern "C" int degensac_propose_score_f32(int n, int k, float max_sq, const float* x1,
                                          const float* x2, const unsigned char* mask,
                                          const float* H, const int* ia, const int* ib,
                                          float* models, int* counts, unsigned long long* best,
                                          void* stream) {
  using namespace ctt;
  if (k == 0) return (int)cudaGetLastError();
  const int blocks = (k + kDegensacWarps - 1) / kDegensacWarps;
  degensac_propose_score_kernel<<<blocks, 32 * kDegensacWarps, 0, (cudaStream_t)stream>>>(
      n, k, max_sq, x1, x2, mask, H, ia, ib, models, counts, best);
  return (int)cudaGetLastError();
}
