// Gradient sampling shared by the SIFT orientation and descriptor kernels
// (K15, K16).
//
// colmap_tpu stores central-difference gradient stacks gx, gy of the whole
// Gaussian stack (sift.py:248-251) and samples them bilinearly at the 16 x 16
// warped patch grid (``bilinear_lvl``, :268-284). Here the gradients come
// from the level on the fly: a bilinear sample of gx needs the level at a
// 2 x 4 neighbourhood, of gy at 4 x 2; no gradient stack is stored.
#pragma once

#include <cuda_runtime.h>

namespace ctt {
namespace sift {

constexpr int kR = 8;         // half window: 16 x 16 samples
constexpr int kSamples = 256;
constexpr int kOriBins = 36;
constexpr int kDescDim = 128;
constexpr int kRowCols = 9;   // x, y, sigma, theta, response, frame (4)
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// Central difference along x of level L (H x W) at (y, x); zero on the
// first and last column, as colmap_tpu's gx stack.
__device__ __forceinline__ float grad_x(const float* __restrict__ L, int W, int y, int x) {
  return (x >= 1 && x <= W - 2) ? 0.5f * (L[y * W + x + 1] - L[y * W + x - 1]) : 0.f;
}

// Central difference along y; zero on the first and last row.
__device__ __forceinline__ float grad_y(const float* __restrict__ L, int H, int W, int y, int x) {
  return (y >= 1 && y <= H - 2) ? 0.5f * (L[(y + 1) * W + x] - L[(y - 1) * W + x]) : 0.f;
}

// bilinear_lvl of both gradients at (yy, xx): the cell's corner clipped to
// [0, H-2] x [0, W-2] and the fractions to [0, 1].
__device__ __forceinline__ void sample_gradient(const float* __restrict__ L, int H, int W,
                                                float yy, float xx, float* sgx, float* sgy) {
  int y0 = (int)floorf(fminf(fmaxf(yy, -1.f), (float)H));
  int x0 = (int)floorf(fminf(fmaxf(xx, -1.f), (float)W));
  y0 = min(max(y0, 0), H - 2);
  x0 = min(max(x0, 0), W - 2);
  const float fy = fminf(fmaxf(yy - (float)y0, 0.f), 1.f);
  const float fx = fminf(fmaxf(xx - (float)x0, 0.f), 1.f);
  const float a = (1.f - fy) * (1.f - fx), b = (1.f - fy) * fx, c = fy * (1.f - fx), d = fy * fx;
  *sgx = grad_x(L, W, y0, x0) * a + grad_x(L, W, y0, x0 + 1) * b + grad_x(L, W, y0 + 1, x0) * c +
         grad_x(L, W, y0 + 1, x0 + 1) * d;
  *sgy = grad_y(L, H, W, y0, x0) * a + grad_y(L, H, W, y0, x0 + 1) * b +
         grad_y(L, H, W, y0 + 1, x0) * c + grad_y(L, H, W, y0 + 1, x0 + 1) * d;
}

// Magnitude and angle of the gradient of the warped patch
// P(p) = I((x, y) + F p) at sample s of the 16 x 16 grid (row i = s / 16,
// column j = s % 16, offsets -7.5 ... 7.5), by the chain rule: the image
// gradient rotated into the patch frame, (gv, gu) = F^T grad I
// (colmap_tpu's sample_warped_grads_batched, exact path).
__device__ __forceinline__ void warped_gradient(const float* __restrict__ L, int H, int W, float x,
                                                float y, float f00, float f01, float f10,
                                                float f11, int s, float* m, float* a) {
  const float pu = (float)(s >> 4) - kR + 0.5f;  // patch row offset
  const float pv = (float)(s & 15) - kR + 0.5f;  // patch column offset
  const float xx = x + (f00 * pv + f01 * pu);
  const float yy = y + (f10 * pv + f11 * pu);
  float sgx, sgy;
  sample_gradient(L, H, W, yy, xx, &sgx, &sgy);
  const float gv = f00 * sgx + f10 * sgy;
  const float gu = f01 * sgx + f11 * sgy;
  *m = sqrtf(gv * gv + gu * gu + 1e-20f);
  *a = atan2f(gu, gv);
}

// max(0, 1 - circular distance) of a bin position to bin b on n bins.
__device__ __forceinline__ float circular_weight(float pos, float b, float n) {
  const float d = fabsf(pos - b);
  return fmaxf(0.f, 1.f - fminf(d, n - d));
}

}  // namespace sift
}  // namespace ctt
