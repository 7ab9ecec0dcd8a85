// K52 aliked_sddh: ALIKED's SDDH descriptors, computed sparsely.
//
// Replaces colmap_tpu/feature/aliked.py sddh_descriptors (l.201-218) with
// _bilinear_sample (l.179-198). colmap_tpu convolves the whole feature map
// (3 x 3 conv1 D -> D, SELU, 3 x 3 conv2 D -> 2M, and the 1 x 1 weight conv
// D -> D: 1.42 TMAC at 3072 x 2304), then samples it at the keypoints. This
// kernel computes only what the samples read, ~3 MMAC a keypoint:
//
// (a) aliked_sddh_offsets_f32, one block of 2D threads a keypoint. The
// bilinear sample of the offset map at xy (clipped to [0, W - 1.001] x
// [0, H - 1.001], corners (x0, y0) .. (x0 + 1, y0 + 1)) needs conv2 at the 4
// corners, which reads SELU(conv1) on the 4 x 4 block around them, which
// reads the features on the 6 x 6 block around that. The block stages that
// 6 x 6 x D patch in shared memory with 0 outside the image (conv1's SAME
// padding), computes the 4 x 4 x D SELU(conv1) values (a thread one output
// channel for 8 of the 16 positions, from the 4 x 6 rows of the patch it
// needs, held in registers per input channel) and sets those outside the
// image to 0 (conv2's SAME padding: colmap_tpu pads off_feat with zeros, it
// does not compute it there). conv2 at the 4 corners splits each output's
// D x 9 sum over the threads left (2 parts at D = 128, M = 16) and adds the
// parts in a fixed order; then the corners' bilinear blend as
// _bilinear_sample writes it and 5 tanh(o / 5). Channel 2m is sample m's x,
// 2m + 1 its y (reshape(-1, M, 2)).
//
// (b) aliked_sddh_describe_f32, one block of D threads for 4 keypoints.
// The 1 x 1 weight conv commutes with the bilinear sample (its four weights
// sum to 1), so a thread samples one feature channel at each of the M
// deformed positions (clipped as above), then one output channel of
// W s + b for the M samples of a keypoint (each weight read once for the M),
// SELU, and the M aggregation products sum_m sum_d sel[m][d] agg[m][d][e]
// (each agg value read once for the block's 4 keypoints). The L2 norm sums
// the squares by warp shuffles and the warps' partials in order: no float
// atomics, the same bits in every run.
//
// Weights arrive tap-major ((Cin, k, k, Cout), (Cin, Cout)): consecutive
// threads (output channels) read consecutive addresses.
//
// Bound on the card: operations on the sparse work. At D = 128, M = 16 a
// keypoint takes 16 x 128 x 1152 (conv1) + 4 x 32 x 1152 (conv2) + 2 x 16 x
// 128 x 128 (weight conv, aggregation) = 3.0 MMAC: 24.7 GMAC at K = 8192,
// 0.74 ms at 67 TFLOP/s.
#include <cuda_runtime.h>

namespace ctt {
namespace aliked_sddh {

constexpr float kSeluAlpha = 1.6732632423543772f;
constexpr float kSeluScale = 1.0507009873554805f;
constexpr float kBound = 5.f;
constexpr int kDescKeypoints = 4;

__device__ __forceinline__ float selu(float v) {
  return kSeluScale * (v > 0.f ? v : kSeluAlpha * expm1f(v));
}

// Clipped bilinear position: (x0, y0, fx, fy) as _bilinear_sample computes
// them, with colmap_tpu's float32 bounds W - 1.001 and H - 1.001.
struct Corner {
  int x0, y0;
  float fx, fy;
};

__device__ __forceinline__ Corner corner(float x, float y, float xmax, float ymax) {
  x = fminf(fmaxf(x, 0.f), xmax);
  y = fminf(fmaxf(y, 0.f), ymax);
  Corner c;
  c.x0 = (int)floorf(x);
  c.y0 = (int)floorf(y);
  c.fx = x - (float)c.x0;
  c.fy = y - (float)c.y0;
  return c;
}

__device__ __forceinline__ float blend(const Corner& c, float v00, float v01, float v10, float v11) {
  return v00 * (1.f - c.fy) * (1.f - c.fx) + v01 * (1.f - c.fy) * c.fx +
         v10 * c.fy * (1.f - c.fx) + v11 * c.fy * c.fx;
}

__global__ void __launch_bounds__(512)
offsets_kernel(int C, int h, int w, int m2, float xmax, float ymax, const float* __restrict__ feat,
               const float* __restrict__ xy, const float* __restrict__ w1t,
               const float* __restrict__ b1, const float* __restrict__ w2t,
               const float* __restrict__ b2, float* __restrict__ offsets) {
  extern __shared__ __align__(16) float smem[];
  float* patch = smem;           // (C, 6, 6)
  float* of = patch + C * 36;    // (C, 4, 4)
  float* part = of + C * 16;     // (parts, 4 * m2)
  const int k = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const Corner cr = corner(xy[2 * k], xy[2 * k + 1], xmax, ymax);
  const size_t plane = (size_t)h * w;

  for (int i = tid; i < C * 36; i += nt) {
    const int c = i / 36, r = (i % 36) / 6, q = i % 6;
    const int gy = cr.y0 - 2 + r, gx = cr.x0 - 2 + q;
    patch[i] = (gy >= 0 && gy < h && gx >= 0 && gx < w)
                   ? __ldg(feat + (size_t)c * plane + (size_t)gy * w + gx)
                   : 0.f;
  }
  __syncthreads();

  // conv1 + SELU on the 4 x 4 block: thread (ci, half) computes rows
  // 2 half, 2 half + 1 of the block, columns 0-3.
  {
    const int ci = tid % C, half = tid / C;
    float acc[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
    for (int cj = 0; cj < C; ++cj) {
      float win[4][6];
      const float* pc = patch + cj * 36 + (2 * half) * 6;
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 6; ++b) win[a][b] = pc[a * 6 + b];
      const float* wc = w1t + (size_t)cj * 9 * C + ci;
#pragma unroll
      for (int ey = 0; ey < 3; ++ey)
#pragma unroll
        for (int ex = 0; ex < 3; ++ex) {
          const float wv = __ldg(wc + (ey * 3 + ex) * C);
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(wv, win[a + ey][b + ex], acc[a][b]);
        }
    }
    const float bias = __ldg(b1 + ci);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int pr = 2 * half + a;
        const int gy = cr.y0 - 1 + pr, gx = cr.x0 - 1 + b;
        const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
        of[ci * 16 + pr * 4 + b] = inside ? selu(acc[a][b] + bias) : 0.f;
      }
  }
  __syncthreads();

  // conv2 at the 4 corners: output o = (corner, channel), its cj range cut
  // into `parts` pieces summed in order.
  const int n_out = 4 * m2, parts = nt / n_out;
  if (tid < n_out * parts) {
    const int o = tid % n_out, p = tid / n_out;
    const int c2 = o % m2, cor = o / m2, cy = cor / 2, cx = cor % 2;
    const int per = (C + parts - 1) / parts, lo = p * per, hi = min(C, lo + per);
    float acc = 0.f;
    for (int cj = lo; cj < hi; ++cj) {
      const float* oc = of + cj * 16;
      const float* wc = w2t + (size_t)cj * 9 * m2 + c2;
#pragma unroll
      for (int ey = 0; ey < 3; ++ey)
#pragma unroll
        for (int ex = 0; ex < 3; ++ex)
          acc = fmaf(__ldg(wc + (ey * 3 + ex) * m2), oc[(cy + ey) * 4 + cx + ex], acc);
    }
    part[p * n_out + o] = acc;
  }
  __syncthreads();
  if (tid < m2) {
    float v[4];
#pragma unroll
    for (int cor = 0; cor < 4; ++cor) {
      float s = 0.f;
      for (int p = 0; p < parts; ++p) s += part[p * n_out + cor * m2 + tid];
      v[cor] = s + __ldg(b2 + tid);
    }
    const float o = blend(cr, v[0], v[1], v[2], v[3]);
    offsets[(size_t)k * m2 + tid] = kBound * tanhf(o / kBound);
  }
}

template <int M>
__global__ void __launch_bounds__(256)
describe_kernel(int C, int h, int w, int n, float xmax, float ymax,
                const float* __restrict__ feat, const float* __restrict__ xy,
                const float* __restrict__ offsets, const float* __restrict__ wt,
                const float* __restrict__ b, const float* __restrict__ agg,
                float* __restrict__ desc) {
  extern __shared__ __align__(16) float smem[];
  float* samp = smem;                          // (kDescKeypoints, M, C)
  float* red = samp + kDescKeypoints * M * C;  // (kDescKeypoints, C / 32)
  const int e = threadIdx.x, k0 = blockIdx.x * kDescKeypoints;
  const int nk = min(kDescKeypoints, n - k0);
  const size_t plane = (size_t)h * w;
  const float* fc = feat + (size_t)e * plane;

  // Bilinear samples of channel e at each keypoint's M deformed positions
  // (0 for the block's missing keypoints).
  for (int kk = 0; kk < kDescKeypoints; ++kk) {
    const int k = k0 + kk;
    for (int m = 0; m < M; ++m) {
      float v = 0.f;
      if (kk < nk) {
        const float sx = xy[2 * k] + offsets[(size_t)k * 2 * M + 2 * m];
        const float sy = xy[2 * k + 1] + offsets[(size_t)k * 2 * M + 2 * m + 1];
        const Corner cr = corner(sx, sy, xmax, ymax);
        const float* r0 = fc + (size_t)cr.y0 * w + cr.x0;
        v = blend(cr, __ldg(r0), __ldg(r0 + 1), __ldg(r0 + w), __ldg(r0 + w + 1));
      }
      samp[(kk * M + m) * C + e] = v;
    }
  }
  __syncthreads();

  // W s + b for output channel e (each weight read once for the block's
  // kDescKeypoints x M samples, four input channels a step), then SELU,
  // written back over the samples.
  float acc[kDescKeypoints][M];
#pragma unroll
  for (int kk = 0; kk < kDescKeypoints; ++kk)
#pragma unroll
    for (int m = 0; m < M; ++m) acc[kk][m] = 0.f;
  for (int d = 0; d < C; d += 4) {
    const float w0 = __ldg(wt + (size_t)d * C + e), w1 = __ldg(wt + (size_t)(d + 1) * C + e);
    const float w2 = __ldg(wt + (size_t)(d + 2) * C + e), w3 = __ldg(wt + (size_t)(d + 3) * C + e);
#pragma unroll
    for (int kk = 0; kk < kDescKeypoints; ++kk)
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 s4 = *reinterpret_cast<const float4*>(samp + (kk * M + m) * C + d);
        float a = acc[kk][m];
        a = fmaf(w0, s4.x, a);
        a = fmaf(w1, s4.y, a);
        a = fmaf(w2, s4.z, a);
        acc[kk][m] = fmaf(w3, s4.w, a);
      }
  }
  __syncthreads();
  const float bias = __ldg(b + e);
#pragma unroll
  for (int kk = 0; kk < kDescKeypoints; ++kk)
#pragma unroll
    for (int m = 0; m < M; ++m) samp[(kk * M + m) * C + e] = selu(acc[kk][m] + bias);
  __syncthreads();

  // The aggregation: desc[e] = sum_m sum_d sel[m][d] agg[m][d][e].
  float out[kDescKeypoints];
#pragma unroll
  for (int kk = 0; kk < kDescKeypoints; ++kk) out[kk] = 0.f;
  for (int m = 0; m < M; ++m) {
    const float* am = agg + (size_t)m * C * C + e;
    for (int d = 0; d < C; d += 4) {
      const float a0 = __ldg(am + (size_t)d * C), a1 = __ldg(am + (size_t)(d + 1) * C);
      const float a2 = __ldg(am + (size_t)(d + 2) * C), a3 = __ldg(am + (size_t)(d + 3) * C);
#pragma unroll
      for (int kk = 0; kk < kDescKeypoints; ++kk) {
        const float4 s4 = *reinterpret_cast<const float4*>(samp + (kk * M + m) * C + d);
        float o = out[kk];
        o = fmaf(s4.x, a0, o);
        o = fmaf(s4.y, a1, o);
        o = fmaf(s4.z, a2, o);
        out[kk] = fmaf(s4.w, a3, o);
      }
    }
  }

  // L2 norms: warp shuffles, then the warps' partials in order.
  const int lane = e & 31, warp = e >> 5, nw = C >> 5;
#pragma unroll
  for (int kk = 0; kk < kDescKeypoints; ++kk) {
    float sq = out[kk] * out[kk];
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, s);
    if (lane == 0) red[kk * nw + warp] = sq;
  }
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < kDescKeypoints; ++kk) {
    if (kk >= nk) break;
    float tot = 0.f;
    for (int i = 0; i < nw; ++i) tot += red[kk * nw + i];
    desc[(size_t)(k0 + kk) * C + e] = out[kk] / fmaxf(sqrtf(tot), 1e-12f);
  }
}

template <int M>
int launch_describe(int C, int h, int w, int n, float xmax, float ymax, const float* feat,
                    const float* xy, const float* offsets, const float* wt, const float* b,
                    const float* agg, float* desc, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kDescKeypoints * M * C + kDescKeypoints * (C / 32));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        describe_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  describe_kernel<M><<<(n + kDescKeypoints - 1) / kDescKeypoints, C, smem, stream>>>(
      C, h, w, n, xmax, ymax, feat, xy, offsets, wt, b, agg, desc);
  return 0;
}

}  // namespace aliked_sddh
}  // namespace ctt

// feat (C, h, w); xy (n, 2); w1t (C, 3, 3, C) = conv1 tap-major, b1 (C,);
// w2t (C, 3, 3, m2), b2 (m2,). Writes offsets (n, m2), bounded. Needs
// C <= 256 and 4 m2 <= 2C. Returns cudaGetLastError().
extern "C" int aliked_sddh_offsets_f32(int C, int h, int w, int n, int m2, const float* feat,
                                       const float* xy, const float* w1t, const float* b1,
                                       const float* w2t, const float* b2, float* offsets,
                                       cudaStream_t stream) {
  using namespace ctt::aliked_sddh;
  const int threads = 2 * C;
  if (threads > 512 || 4 * m2 > threads || h < 2 || w < 2) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int parts = threads / (4 * m2);
    const size_t smem = sizeof(float) * ((size_t)C * 52 + (size_t)parts * 4 * m2);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          offsets_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    const float xmax = (float)((double)w - 1.001), ymax = (float)((double)h - 1.001);
    offsets_kernel<<<n, threads, smem, stream>>>(C, h, w, m2, xmax, ymax, feat, xy, w1t, b1, w2t,
                                                 b2, offsets);
  }
  return (int)cudaGetLastError();
}

// feat (C, h, w); xy (n, 2); offsets (n, 2M); wt (C, C) = the 1 x 1 weight
// conv as (Cin, Cout), b (C,); agg (M, C, C). Writes desc (n, C), L2-unit.
// Needs C a multiple of 32 up to 256 and M 16 or 32. Returns
// cudaGetLastError().
extern "C" int aliked_sddh_describe_f32(int C, int h, int w, int n, int M, const float* feat,
                                        const float* xy, const float* offsets, const float* wt,
                                        const float* b, const float* agg, float* desc,
                                        cudaStream_t stream) {
  using namespace ctt::aliked_sddh;
  if (C > 256 || C % 32 || (M != 16 && M != 32) || h < 2 || w < 2)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const float xmax = (float)((double)w - 1.001), ymax = (float)((double)h - 1.001);
    const int err = M == 16 ? launch_describe<16>(C, h, w, n, xmax, ymax, feat, xy, offsets, wt,
                                                  b, agg, desc, stream)
                            : launch_describe<32>(C, h, w, n, xmax, ymax, feat, xy, offsets, wt,
                                                  b, agg, desc, stream);
    if (err != 0) return err;
  }
  return (int)cudaGetLastError();
}
