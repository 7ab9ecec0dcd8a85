// K15 sift_orientation: dominant orientations of SIFT keypoints.
//
// Replaces the first half of colmap_tpu/feature/sift.py
// _orientations_and_descriptors (l.236): sample_warped_grads_batched with
// frames sigma I (l.377-395, 529-531), per_kp (l.397-418) and peaks
// (l.534-554). One warp per keypoint, four keypoints a block:
//   - 16 x 16 samples at offsets -7.5 ... 7.5 scaled by sigma, each a
//     bilinear sample (bilinear_lvl's clamps) of the central-difference
//     gradients of the keypoint's level, computed on the fly from the level
//     (sift_common.cuh); lane l takes samples l, l + 32, ...;
//   - magnitude times a Gaussian of sd 1.5 R / 3, soft-assigned linearly to
//     the two nearest of 36 circular bins; each lane keeps its own
//     histogram in shared memory and the 32 are summed in lane order, so
//     the sum does not depend on scheduling;
//   - two circular 3-tap smoothings (h[b-1] + h[b]) + h[b+1], / 3;
//   - peaks: local maxima (>= both neighbours) at or above 0.8 of the
//     largest bin, the n_ori highest by value (the first index wins a tie,
//     as the stable jnp.argsort), ok where the value is > 0, parabolic
//     interpolation of each; theta = (b + 0.5 + di) / 36 2 pi - pi.
// With upright, theta is 0 and only the first row is ok; no sampling runs.
// colmap_tpu's bf16 hat-function window sampling (a TPU gather workaround,
// l.304-375) is not carried over: every sample is exact.
//
// Bound on the card: bytes. The samples of a keypoint span a window of its
// level about 16 sqrt(2) sigma + 4 px on a side, read once from device
// memory (12 reads a sample, the rest from L1); its ~70 flops a sample
// (atan2 and sqrt among them) take far less time than that window's bytes.
#include <cuda_runtime.h>

#include "sift_common.cuh"

namespace ctt {
namespace sift {

constexpr int kOriWarps = 4;
constexpr int kHistStride = kOriBins + 1;  // padded per-lane histogram
constexpr int kMaxOrientations = 8;

__global__ void orientation_kernel(int K, int H, int W, int n_ori, int upright,
                                   const float* __restrict__ gauss, const float* __restrict__ xs,
                                   const float* __restrict__ ys, const float* __restrict__ sigmas,
                                   const int* __restrict__ lvls, float* __restrict__ theta,
                                   unsigned char* __restrict__ ok) {
  __shared__ float part[kOriWarps][32 * kHistStride];
  __shared__ float hist[kOriWarps][2][kOriBins];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k = blockIdx.x * kOriWarps + warp;
  if (k >= K) return;  // whole warps leave together
  if (upright) {
    if (lane < n_ori) {
      theta[(size_t)k * n_ori + lane] = 0.f;
      ok[(size_t)k * n_ori + lane] = lane == 0 ? 1 : 0;
    }
    return;
  }
  const float* L = gauss + (size_t)lvls[k] * H * W;
  const float x = xs[k], y = ys[k], sg = sigmas[k];
  float* mine = part[warp] + lane * kHistStride;
  for (int b = 0; b < kOriBins; ++b) mine[b] = 0.f;
  for (int s = lane; s < kSamples; s += 32) {
    float m, a;
    warped_gradient(L, H, W, x, y, sg, 0.f, 0.f, sg, s, &m, &a);
    const float pu = (float)(s >> 4) - kR + 0.5f, pv = (float)(s & 15) - kR + 0.5f;
    const float wm = m * expf(-((pu * pu + pv * pv) / 32.f));  // 2 (1.5 R / 3)^2 = 32
    const float bin_f = (a + kPi) / kTwoPi * (float)kOriBins - 0.5f;
    const float b0 = floorf(bin_f);
    const int i0 = ((int)b0 % kOriBins + kOriBins) % kOriBins;
    mine[i0] += wm * circular_weight(bin_f, b0, (float)kOriBins);
    mine[(i0 + 1) % kOriBins] += wm * circular_weight(bin_f, b0 + 1.f, (float)kOriBins);
  }
  __syncwarp();
  for (int b = lane; b < kOriBins; b += 32) {
    float acc = 0.f;
    for (int l = 0; l < 32; ++l) acc += part[warp][l * kHistStride + b];
    hist[warp][0][b] = acc;
  }
  __syncwarp();
  for (int pass = 0; pass < 2; ++pass) {
    const float* src = hist[warp][pass];
    float* dst = hist[warp][pass ^ 1];
    float v[2];
    for (int q = 0; q < 2; ++q) {
      const int b = lane + 32 * q;
      if (b < kOriBins)
        v[q] = (src[(b + kOriBins - 1) % kOriBins] + src[b] + src[(b + 1) % kOriBins]) / 3.f;
    }
    __syncwarp();
    for (int q = 0; q < 2; ++q) {
      const int b = lane + 32 * q;
      if (b < kOriBins) dst[b] = v[q];
    }
    __syncwarp();
  }
  if (lane != 0) return;
  const float* h = hist[warp][0];  // after two passes the result is back in slot 0
  float hmax = h[0];
  for (int b = 1; b < kOriBins; ++b) hmax = fmaxf(hmax, h[b]);
  float score[kOriBins];
  for (int b = 0; b < kOriBins; ++b) {
    const float l = h[(b + kOriBins - 1) % kOriBins], r = h[(b + 1) % kOriBins];
    const bool peak = h[b] >= l && h[b] >= r && h[b] >= 0.8f * hmax;
    score[b] = peak ? h[b] : -INFINITY;
  }
  unsigned long long taken = 0ull;
  for (int j = 0; j < n_ori; ++j) {
    int best = -1;  // the highest untaken score, the first index on a tie
    for (int b = 0; b < kOriBins; ++b)
      if (!((taken >> b) & 1ull) && (best < 0 || score[b] > score[best])) best = b;
    taken |= 1ull << best;
    const float sc = score[best];
    const float h0 = h[(best + kOriBins - 1) % kOriBins], h1 = h[best];
    const float h2 = h[(best + 1) % kOriBins];
    const float denom = h0 - 2.f * h1 + h2;
    const float di = fabsf(denom) > 1e-12f ? 0.5f * (h0 - h2) / denom : 0.f;
    theta[(size_t)k * n_ori + j] = ((float)best + 0.5f + di) / (float)kOriBins * 2.f * kPi - kPi;
    ok[(size_t)k * n_ori + j] = sc > 0.f ? 1 : 0;
  }
}

}  // namespace sift
}  // namespace ctt

extern "C" int sift_orientation_f32(int K, int H, int W, int n_ori, int upright, const float* gauss,
                                    const float* x, const float* y, const float* sigma,
                                    const int* lvl, float* theta, unsigned char* ok,
                                    void* stream) {
  using namespace ctt::sift;
  if (n_ori < 1 || n_ori > kMaxOrientations || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const int blocks = (K + kOriWarps - 1) / kOriWarps;
  orientation_kernel<<<blocks, 32 * kOriWarps, 0, (cudaStream_t)stream>>>(
      K, H, W, n_ori, upright, gauss, x, y, sigma, lvl, theta, ok);
  return (int)cudaGetLastError();
}
