// K16 sift_descriptor: SIFT descriptors, normalized and quantized.
//
// Replaces the second half of colmap_tpu/feature/sift.py
// _orientations_and_descriptors (l.236): the frames sigma R(theta)
// (l.556-571), sample_warped_grads_batched (l.377-395), raw_descriptor
// (l.420-443), domain-size pooling (l.452-470), normalize_desc (l.445-450),
// and _describe_all's uint8 quantization and 9-float row (l.681-692).
// One warp per (keypoint, orientation) row, four rows a block; a row whose
// orientation is not ok is skipped (its outputs stay zero):
//   - the frame F = sigma [[c, -s], [s, c]] (times each DSP scale);
//   - the 256 warped samples: gradient magnitude times a Gaussian of sd R,
//     and the angle atan2(gu, gv) mod 2 pi, one sample per lane at a time,
//     staged in shared memory;
//   - trilinear soft assignment to 4 x 4 spatial x 8 circular orientation
//     bins: lane l owns bins l, l + 32, l + 64, l + 96 (spatial column
//     l / 8 and orientation l % 8, rows 0..3) and walks all 256 samples in
//     order, so each bin is a sum in sample order, without atomics;
//   - DSP: the raw histograms of every scale are summed, then divided by
//     their count, before normalization;
//   - L1_ROOT (divide by the L1 norm, square root) or L2, warp reductions;
//   - uint8: clip(rint(512 d), 0, 255) (rintf rounds half to even, as
//     jnp.round);
//   - the row (x, y, sigma, theta, response, F) for the host.
// Affine frames (estimate_affine_shape): with a (K, 2, 2) ``shapes`` array
// the frame is F = sigma A R(theta), A the keypoint's det-1 shape from K45
// (colmap_tpu l.566-571), and the row carries that F; a null ``shapes`` is
// the identity and runs the code above unchanged. Samples read the level
// through L1, so a stretched frame needs no other load path.
//
// Bound on the card: bytes. A row reads its level's window (about
// 16 sqrt(2) sigma + 4 px on a side, per DSP scale) once from device memory
// and writes a 137-byte row; its 256 gradient samples and 128 x 256 bin
// weights take less time at the float32 peak than that window's bytes.
#include <cuda_runtime.h>

#include "sift_common.cuh"

namespace ctt {
namespace sift {

constexpr int kDescWarps = 4;

__device__ __forceinline__ float warp_sum_f(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void descriptor_kernel(int K, int H, int W, int n_ori, int l2, int n_scales,
                                  const float* __restrict__ scales,
                                  const float* __restrict__ gauss, const float* __restrict__ xs,
                                  const float* __restrict__ ys, const float* __restrict__ sigmas,
                                  const float* __restrict__ responses,
                                  const int* __restrict__ lvls, const float* __restrict__ thetas,
                                  const float* __restrict__ shapes,
                                  const bool* __restrict__ ok, float* __restrict__ data,
                                  unsigned char* __restrict__ desc) {
  __shared__ float wmag[kDescWarps][kSamples];
  __shared__ float obin[kDescWarps][kSamples];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kDescWarps + warp;
  if (row >= K * n_ori || !ok[row]) return;  // whole warps leave together
  const int k = row / n_ori;
  const float* L = gauss + (size_t)lvls[k] * H * W;
  const float x = xs[k], y = ys[k], sg = sigmas[k], th = thetas[row];
  const float c = cosf(th), s = sinf(th);
  float f00 = sg * c, f01 = sg * -s, f10 = sg * s, f11 = sg * c;
  if (shapes != nullptr) {  // F = sigma A R(theta)
    const float* A = shapes + (size_t)k * 4;
    f00 = sg * (A[0] * c + A[1] * s);
    f01 = sg * (A[0] * -s + A[1] * c);
    f10 = sg * (A[2] * c + A[3] * s);
    f11 = sg * (A[2] * -s + A[3] * c);
  }
  const int v_bin = lane >> 3, o_bin = lane & 7;  // this lane's spatial column and orientation
  float acc[4] = {0.f, 0.f, 0.f, 0.f};  // spatial rows 0..3
  for (int sc = 0; sc < n_scales; ++sc) {
    const float f = scales[sc];
    for (int q = lane; q < kSamples; q += 32) {
      float m, a;
      warped_gradient(L, H, W, x, y, f00 * f, f01 * f, f10 * f, f11 * f, q, &m, &a);
      const float pu = (float)(q >> 4) - kR + 0.5f, pv = (float)(q & 15) - kR + 0.5f;
      wmag[warp][q] = m * expf(-((pu * pu + pv * pv) / 128.f));  // 2 (0.5 2 R)^2 = 128
      const float a_mod = a < 0.f ? a + kTwoPi : a;  // jnp.mod(a, 2 pi)
      obin[warp][q] = a_mod / kTwoPi * 8.f - 0.5f;
    }
    __syncwarp();
    for (int q = 0; q < kSamples; ++q) {
      const float pu = (float)(q >> 4) - kR + 0.5f, pv = (float)(q & 15) - kR + 0.5f;
      const float bv = (pv + kR - 0.5f) / (2.f * kR) * 4.f - 0.5f;
      const float wv = fmaxf(0.f, 1.f - fabsf(bv - (float)v_bin));
      if (wv == 0.f) continue;
      const float wo = circular_weight(obin[warp][q], (float)o_bin, 8.f);
      if (wo == 0.f) continue;
      const float bu = (pu + kR - 0.5f) / (2.f * kR) * 4.f - 0.5f;
      const float w = wmag[warp][q] * wv * wo;
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[u] += w * fmaxf(0.f, 1.f - fabsf(bu - (float)u));
    }
    __syncwarp();
  }
  if (n_scales > 1)
    for (int u = 0; u < 4; ++u) acc[u] /= (float)n_scales;
  float norm;
  if (l2) {
    norm = sqrtf(warp_sum_f(acc[0] * acc[0] + acc[1] * acc[1] + acc[2] * acc[2] + acc[3] * acc[3]));
  } else {
    norm = warp_sum_f(fabsf(acc[0]) + fabsf(acc[1]) + fabsf(acc[2]) + fabsf(acc[3]));
  }
  norm = fmaxf(norm, 1e-12f);
  unsigned char* out = desc + (size_t)row * kDescDim;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float d = acc[u] / norm;
    if (!l2) d = sqrtf(d);
    out[u * 32 + lane] = (unsigned char)fminf(fmaxf(rintf(d * 512.f), 0.f), 255.f);
  }
  if (lane == 0) {
    float* r = data + (size_t)row * kRowCols;
    r[0] = x;
    r[1] = y;
    r[2] = sg;
    r[3] = th;
    r[4] = responses[k];
    r[5] = f00;
    r[6] = f01;
    r[7] = f10;
    r[8] = f11;
  }
}

}  // namespace sift
}  // namespace ctt

extern "C" int sift_descriptor_f32(int K, int H, int W, int n_ori, int l2, int n_scales,
                                   const float* scales, const float* gauss, const float* x,
                                   const float* y, const float* sigma, const float* response,
                                   const int* lvl, const float* theta, const float* shapes,
                                   const bool* ok, float* data, unsigned char* desc,
                                   void* stream) {
  using namespace ctt::sift;
  if (n_ori < 1 || n_scales < 1 || H < 2 || W < 2) return (int)cudaErrorInvalidValue;
  const int rows = K * n_ori;
  const int blocks = (rows + kDescWarps - 1) / kDescWarps;
  descriptor_kernel<<<blocks, 32 * kDescWarps, 0, (cudaStream_t)stream>>>(
      K, H, W, n_ori, l2, n_scales, scales, gauss, x, y, sigma, response, lvl, theta, shapes, ok,
      data, desc);
  return (int)cudaGetLastError();
}
