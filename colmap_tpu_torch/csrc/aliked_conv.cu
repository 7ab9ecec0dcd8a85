// K50 aliked_conv: the convolutions of ALIKED's backbone and score head.
//
// Replaces colmap_tpu/feature/aliked.py backbone_and_score (l.120-138): four
// conv blocks (two 3 x 3 SAME convs + SELU each, a 2 x 2 VALID average pool
// before blocks 2-4, l.106-113), the 1 x 1 aggregation convs, the bilinear
// upsampling of a2-a4 to H x W (jax.image.resize "bilinear": half-pixel
// centres, l.116-117), SELU over the concat (l.133) and the 4-conv score
// head ending in a sigmoid (l.134-137).
//
// (a) aliked_conv_f32: out = act(conv(x) + b), k in {1, 3}, SAME zero
// padding, float32 FMAs (no tensor cores: TF32 would miss the 1e-4 gate).
// With pool set, each input value is the 2 x 2 mean of x, computed as the
// tile loads, so the pooled map is never written. ``out`` may be a channel
// slice of a larger map: the aggregation conv a1 writes feat[0:32] directly.
// A block computes a 32 x 16 pixel tile for COT output channels: per stage
// of 8 input channels it stages the (16 + k - 1) x (32 + k - 1) input window
// and the stage's COT x 8 x k x k weights in shared memory; each thread keeps
// 2 pixels (rows y and y + 8) x COT outputs in registers and reads each
// weight as a broadcast float4, so a stage costs ~1 shared load per 5 FMAs.
//
// (b) aliked_upsample_selu_f32: dst = selu(bilinear(src)), one thread a
// pixel and channel, with PyTorch's half-pixel source index (clamped at 0)
// and edge handling, which equal jax.image.resize's for upsampling.
//
// Bound on the card: operations. The dense network is ~166 GMAC at 3072 x
// 2304 (smh1's 128 -> 8 3 x 3 conv over the full image is 65 of them): ~5
// ms at 67 TFLOP/s; it writes ~3.7 GB (feat is 3.6 GB), ~1.1 ms at 3.35 TB/s.
#include <cuda_runtime.h>

namespace ctt {
namespace aliked {

constexpr float kSeluAlpha = 1.6732632423543772f;
constexpr float kSeluScale = 1.0507009873554805f;
constexpr int kTX = 32, kTY = 16, kRowsPerThread = 2, kStage = 8;

__device__ __forceinline__ float activate(float v, int act) {
  if (act == 1) return kSeluScale * (v > 0.f ? v : kSeluAlpha * expm1f(v));
  if (act == 2) return 1.f / (1.f + expf(-v));
  return v;
}

template <int COT, int K>
__global__ void __launch_bounds__(256)
conv_kernel(int cin, int hin, int win, int h, int w, int cout, int pool, int act,
            const float* __restrict__ x, const float* __restrict__ wgt,
            const float* __restrict__ bias, float* __restrict__ out) {
  constexpr int P = K / 2, SH = kTY + K - 1, SW = kTX + K - 1, KK = K * K;
  __shared__ float xs[kStage][SH][SW];
  __shared__ __align__(16) float ws[kStage][KK][COT];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTX + tx;
  const int x0 = blockIdx.x * kTX, y0 = blockIdx.y * kTY, co0 = blockIdx.z * COT;
  const size_t in_plane = (size_t)hin * win;
  float acc[kRowsPerThread][COT];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r)
#pragma unroll
    for (int c = 0; c < COT; ++c) acc[r][c] = 0.f;

  for (int ci0 = 0; ci0 < cin; ci0 += kStage) {
    const int ncc = min(kStage, cin - ci0);
    __syncthreads();
    for (int i = tid; i < kStage * SH * SW; i += 256) {
      const int cc = i / (SH * SW), rem = i % (SH * SW), sy = rem / SW, sx = rem % SW;
      const int gy = y0 - P + sy, gx = x0 - P + sx;
      float v = 0.f;
      if (cc < ncc && gy >= 0 && gy < h && gx >= 0 && gx < w) {
        const float* plane = x + (size_t)(ci0 + cc) * in_plane;
        if (pool) {
          const float* r0 = plane + (size_t)(2 * gy) * win + 2 * gx;
          v = (((__ldg(r0) + __ldg(r0 + 1)) + __ldg(r0 + win)) + __ldg(r0 + win + 1)) * 0.25f;
        } else {
          v = __ldg(plane + (size_t)gy * win + gx);
        }
      }
      xs[cc][sy][sx] = v;
    }
    for (int i = tid; i < kStage * KK * COT; i += 256) {
      const int co = i % COT, tap = (i / COT) % KK, cc = i / (COT * KK);
      ws[cc][tap][co] = (cc < ncc && co0 + co < cout)
                            ? __ldg(wgt + ((size_t)(co0 + co) * cin + ci0 + cc) * KK + tap)
                            : 0.f;
    }
    __syncthreads();
    for (int cc = 0; cc < ncc; ++cc) {
#pragma unroll
      for (int ky = 0; ky < K; ++ky) {
#pragma unroll
        for (int kx = 0; kx < K; ++kx) {
          float in[kRowsPerThread];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r) in[r] = xs[cc][ty + 8 * r + ky][tx + kx];
          const float4* wv = reinterpret_cast<const float4*>(&ws[cc][ky * K + kx][0]);
#pragma unroll
          for (int q = 0; q < COT / 4; ++q) {
            const float4 wq = wv[q];
#pragma unroll
            for (int r = 0; r < kRowsPerThread; ++r) {
              acc[r][4 * q + 0] = fmaf(in[r], wq.x, acc[r][4 * q + 0]);
              acc[r][4 * q + 1] = fmaf(in[r], wq.y, acc[r][4 * q + 1]);
              acc[r][4 * q + 2] = fmaf(in[r], wq.z, acc[r][4 * q + 2]);
              acc[r][4 * q + 3] = fmaf(in[r], wq.w, acc[r][4 * q + 3]);
            }
          }
        }
      }
    }
  }
  const int px = x0 + tx;
  if (px >= w) return;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int py = y0 + ty + 8 * r;
    if (py >= h) continue;
#pragma unroll
    for (int c = 0; c < COT; ++c) {
      if (co0 + c < cout)
        out[(size_t)(co0 + c) * h * w + (size_t)py * w + px] =
            activate(acc[r][c] + __ldg(bias + co0 + c), act);
    }
  }
}

template <int COT, int K>
void launch_conv(int cin, int hin, int win, int h, int w, int cout, int pool, int act,
                 const float* x, const float* wgt, const float* b, float* out,
                 cudaStream_t stream) {
  const dim3 grid((w + kTX - 1) / kTX, (h + kTY - 1) / kTY, (cout + COT - 1) / COT);
  conv_kernel<COT, K><<<grid, dim3(kTX, kTY / kRowsPerThread), 0, stream>>>(
      cin, hin, win, h, w, cout, pool, act, x, wgt, b, out);
}

__global__ void __launch_bounds__(256)
upsample_selu_kernel(int h, int w, int H, int W, const float* __restrict__ src,
                     float* __restrict__ dst) {
  const int X = blockIdx.x * 32 + threadIdx.x, Y = blockIdx.y * 8 + threadIdx.y;
  const int c = blockIdx.z;
  if (X >= W || Y >= H) return;
  const float sh = (float)h / (float)H, sw = (float)w / (float)W;
  const float fy = fmaxf(sh * ((float)Y + 0.5f) - 0.5f, 0.f);
  const float fx = fmaxf(sw * ((float)X + 0.5f) - 0.5f, 0.f);
  const int y0 = (int)fy, x0 = (int)fx;
  const int y1 = y0 + (y0 < h - 1 ? 1 : 0), x1 = x0 + (x0 < w - 1 ? 1 : 0);
  const float ly1 = fy - (float)y0, lx1 = fx - (float)x0;
  const float ly0 = 1.f - ly1, lx0 = 1.f - lx1;
  const float* s = src + (size_t)c * h * w;
  const float v = ly0 * (lx0 * __ldg(s + (size_t)y0 * w + x0) + lx1 * __ldg(s + (size_t)y0 * w + x1)) +
                  ly1 * (lx0 * __ldg(s + (size_t)y1 * w + x0) + lx1 * __ldg(s + (size_t)y1 * w + x1));
  dst[(size_t)c * H * W + (size_t)Y * W + X] = activate(v, 1);
}

}  // namespace aliked
}  // namespace ctt

// x (cin, hin, win); w (cout, cin, k, k); b (cout,); out (cout, h, w) with
// h, w = hin, win, or hin / 2, win / 2 with pool. act: 0 none, 1 SELU, 2
// sigmoid. Returns cudaGetLastError().
extern "C" int aliked_conv_f32(int cin, int hin, int win, int cout, int k, int pool, int act,
                               const float* x, const float* wgt, const float* b, float* out,
                               cudaStream_t stream) {
  using namespace ctt::aliked;
  const int h = pool ? hin / 2 : hin, w = pool ? win / 2 : win;
  if (h > 0 && w > 0 && cout > 0 && cin > 0) {
    const int cot = cout >= 16 ? 16 : (cout >= 8 ? 8 : 4);
    if (k == 3) {
      if (cot == 16) launch_conv<16, 3>(cin, hin, win, h, w, cout, pool, act, x, wgt, b, out, stream);
      else if (cot == 8) launch_conv<8, 3>(cin, hin, win, h, w, cout, pool, act, x, wgt, b, out, stream);
      else launch_conv<4, 3>(cin, hin, win, h, w, cout, pool, act, x, wgt, b, out, stream);
    } else if (k == 1) {
      if (cot == 16) launch_conv<16, 1>(cin, hin, win, h, w, cout, pool, act, x, wgt, b, out, stream);
      else if (cot == 8) launch_conv<8, 1>(cin, hin, win, h, w, cout, pool, act, x, wgt, b, out, stream);
      else launch_conv<4, 1>(cin, hin, win, h, w, cout, pool, act, x, wgt, b, out, stream);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}

// src (c, h, w) -> dst (c, H, W) = selu(bilinear upsample). Returns
// cudaGetLastError().
extern "C" int aliked_upsample_selu_f32(int c, int h, int w, int H, int W, const float* src,
                                        float* dst, cudaStream_t stream) {
  using namespace ctt::aliked;
  if (c > 0 && H > 0 && W > 0 && h > 0 && w > 0) {
    const dim3 grid((W + 31) / 32, (H + 7) / 8, c);
    upsample_selu_kernel<<<grid, dim3(32, 8), 0, stream>>>(h, w, H, W, src, dst);
  }
  return (int)cudaGetLastError();
}
