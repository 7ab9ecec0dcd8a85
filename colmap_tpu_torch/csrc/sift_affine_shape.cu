// K45 sift_affine_shape: Baumberg's affine shape adaptation of SIFT keypoints.
//
// Replaces colmap_tpu/feature/sift.py affine_shape (l.472, vmapped over the
// keypoints at l.525; the fori_loop of l.518), reached with
// SiftOptions.estimate_affine_shape. For each keypoint a det-1 shape A
// starts at the identity; each of the ``iters`` iterations samples the
// 16 x 16 grid of the warped patch P(p) = I((x, y) + sigma A p) (bilinear
// samples of the level's central-difference gradients, sift_common.cuh, as
// K15 and K16), takes the patch-frame gradients (gv, gu) = A^T grad I, the
// Gaussian-weighted second-moment matrix M = sum w (gv, gu)(gv, gu)^T / sum
// w (+1e-10 on the diagonal), and updates A <- A M^(-1/2) / sqrt|det|, with
// M^(1/2) in closed form. A shape that is not finite or has an entry of 8
// or more becomes the identity.
//
// One warp per keypoint, four a block. Lane l takes samples l, l + 32, ...,
// l + 224 and sums them in that order; the three moment sums (and sum w)
// then go through a butterfly of warp shuffles, so every lane holds the
// same sums, in a fixed order that does not depend on scheduling (each
// iteration feeds its sums back into A, so the order must not move). Every
// lane then updates its copy of A identically; lane 0 writes it.
//
// Bound on the card: bytes. A keypoint's samples read the level pixels
// under its (up to 8x stretched) window; the ~50 flops a sample and
// iteration take less time at the float32 peak than those bytes.
#include <cuda_runtime.h>

#include "sift_common.cuh"

namespace ctt {
namespace sift {

constexpr int kShapeWarps = 4;

__device__ __forceinline__ float warp_sum_shape(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void affine_shape_kernel(int K, int H, int W, int iters,
                                    const float* __restrict__ gauss, const float* __restrict__ xs,
                                    const float* __restrict__ ys, const float* __restrict__ sigmas,
                                    const int* __restrict__ lvls, float* __restrict__ shapes) {
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kShapeWarps + (threadIdx.x >> 5);
  if (k >= K) return;  // whole warps leave together
  const float* L = gauss + (size_t)lvls[k] * H * W;
  const float x = xs[k], y = ys[k], sg = sigmas[k];
  const float eps = 1e-10f;
  float w_part = 0.f;
  for (int s = lane; s < kSamples; s += 32) {
    const float pu = (float)(s >> 4) - kR + 0.5f, pv = (float)(s & 15) - kR + 0.5f;
    w_part += expf(-((pu * pu + pv * pv) / 32.f));  // 2 (1.5 R / 3)^2 = 32
  }
  const float w_sum = warp_sum_shape(w_part);
  float a00 = 1.f, a01 = 0.f, a10 = 0.f, a11 = 1.f;
  for (int it = 0; it < iters; ++it) {
    const float f00 = sg * a00, f01 = sg * a01, f10 = sg * a10, f11 = sg * a11;
    float ma = 0.f, mb = 0.f, mc = 0.f;
    for (int s = lane; s < kSamples; s += 32) {
      const float pu = (float)(s >> 4) - kR + 0.5f, pv = (float)(s & 15) - kR + 0.5f;
      const float xx = x + (f00 * pv + f01 * pu);
      const float yy = y + (f10 * pv + f11 * pu);
      float sgx, sgy;
      sample_gradient(L, H, W, yy, xx, &sgx, &sgy);
      const float gv = a00 * sgx + a10 * sgy;
      const float gu = a01 * sgx + a11 * sgy;
      const float w = expf(-((pu * pu + pv * pv) / 32.f));
      ma += w * gv * gv;
      mb += w * gv * gu;
      mc += w * gu * gu;
    }
    const float m_a = warp_sum_shape(ma) / w_sum + eps;
    const float m_b = warp_sum_shape(mb) / w_sum;
    const float m_c = warp_sum_shape(mc) / w_sum + eps;
    // sqrt(M) = (M + sqrt(det M) I) / sqrt(tr M + 2 sqrt(det M)); its inverse
    // by the adjugate, det(sqrt(M)) = sqrt(det M).
    const float sq_det = sqrtf(fmaxf(m_a * m_c - m_b * m_b, eps * eps));
    const float denom = sqrtf(fmaxf(m_a + m_c + 2.f * sq_det, eps));
    const float s11 = (m_a + sq_det) / denom, s12 = m_b / denom, s22 = (m_c + sq_det) / denom;
    const float i11 = s22 / sq_det, i12 = -s12 / sq_det, i22 = s11 / sq_det;
    const float n00 = a00 * i11 + a01 * i12, n01 = a00 * i12 + a01 * i22;
    const float n10 = a10 * i11 + a11 * i12, n11 = a10 * i12 + a11 * i22;
    const float inv = 1.f / sqrtf(fmaxf(fabsf(n00 * n11 - n01 * n10), eps));
    a00 = n00 * inv;
    a01 = n01 * inv;
    a10 = n10 * inv;
    a11 = n11 * inv;
  }
  const bool ok = isfinite(a00) && isfinite(a01) && isfinite(a10) && isfinite(a11) &&
                  fmaxf(fmaxf(fabsf(a00), fabsf(a01)), fmaxf(fabsf(a10), fabsf(a11))) < 8.f;
  if (lane == 0) {
    float* out = shapes + (size_t)k * 4;
    out[0] = ok ? a00 : 1.f;
    out[1] = ok ? a01 : 0.f;
    out[2] = ok ? a10 : 0.f;
    out[3] = ok ? a11 : 1.f;
  }
}

}  // namespace sift
}  // namespace ctt

extern "C" int sift_affine_shape_f32(int K, int H, int W, int iters, const float* gauss,
                                     const float* x, const float* y, const float* sigma,
                                     const int* lvl, float* shapes, void* stream) {
  using namespace ctt::sift;
  if (H < 2 || W < 2 || iters < 0) return (int)cudaErrorInvalidValue;
  if (K == 0) return (int)cudaGetLastError();
  const int blocks = (K + kShapeWarps - 1) / kShapeWarps;
  affine_shape_kernel<<<blocks, 32 * kShapeWarps, 0, (cudaStream_t)stream>>>(
      K, H, W, iters, gauss, x, y, sigma, lvl, shapes);
  return (int)cudaGetLastError();
}
