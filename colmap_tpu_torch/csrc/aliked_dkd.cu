// K51 aliked_dkd: ALIKED's keypoint detection on the score map.
//
// Replaces colmap_tpu/feature/aliked.py _nms_keypoints (l.141-176): a
// (2r + 1)^2 max filter with -inf outside the image (reduce_window SAME),
// peaks where score >= pooled and score > threshold, lax.top_k of K, and a
// (2r + 1)^2 soft-argmax refinement (softmax(20 w), clipped indices), the
// refined position clipped to the image.
//
// (a) aliked_dkd_peaks_f32: one thread a pixel reads its window through L1
// and tests the peak; a warp compacts its candidates with one atomicAdd (a
// ballot and a prefix of its mask) as 64-bit keys
// (0x7FFFFFFF - bits(score)) << 32 | flat index. Scores are sigmoid outputs,
// non-negative, so their bits order as the floats do, and the keys are
// unique: one ascending sort of them (torch.sort, in the wrapper, after a
// 4-byte read of the count) is lax.top_k's order, score descending and
// index ascending on ties, whatever order the warps appended in.
// (b) aliked_dkd_refine_f32: one thread a selected keypoint: the window's
// softmax weights as jax.nn.softmax forms them (exp(x - max) / sum), then
// sum(w * offset) in the window's row-major order.
//
// Bound on the card: bytes. The score map is read once (28 MB at 3072 x
// 2304) and the K keys, positions and scores written: ~8.5 us at 3.35 TB/s.
#include <cuda_runtime.h>

namespace ctt {
namespace aliked_dkd {

constexpr int kMaxRadius = 3;

__global__ void __launch_bounds__(256)
peaks_kernel(int h, int w, int r, float threshold, const float* __restrict__ score,
             unsigned long long* __restrict__ keys, int* __restrict__ count) {
  const int x = blockIdx.x * 32 + threadIdx.x, y = blockIdx.y * 8 + threadIdx.y;
  bool cand = false;
  float s = 0.f;
  if (x < w && y < h) {
    s = __ldg(score + (size_t)y * w + x);
    if (s > threshold) {
      float m = -INFINITY;
      for (int dy = -r; dy <= r; ++dy) {
        const int yy = y + dy;
        if (yy < 0 || yy >= h) continue;
        for (int dx = -r; dx <= r; ++dx) {
          const int xx = x + dx;
          if (xx >= 0 && xx < w) m = fmaxf(m, __ldg(score + (size_t)yy * w + xx));
        }
      }
      cand = s >= m;
    }
  }
  const unsigned mask = __ballot_sync(0xffffffffu, cand);
  if (mask == 0u) return;
  const int lane = (threadIdx.y * 32 + threadIdx.x) & 31;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, leader);
  if (cand) {
    const unsigned long long idx = (unsigned long long)((size_t)y * w + x);
    const unsigned long long hi = 0x7FFFFFFFull - (unsigned long long)__float_as_uint(s);
    keys[base + __popc(mask & ((1u << lane) - 1u))] = (hi << 32) | idx;
  }
}

__global__ void __launch_bounds__(128)
refine_kernel(int h, int w, int r, int n, const float* __restrict__ score,
              const unsigned long long* __restrict__ keys, float* __restrict__ xy,
              float* __restrict__ scores) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const unsigned idx = (unsigned)(keys[i] & 0xFFFFFFFFull);
  const int y = (int)(idx / (unsigned)w), x = (int)(idx % (unsigned)w);
  const int side = 2 * r + 1;
  float v[(2 * kMaxRadius + 1) * (2 * kMaxRadius + 1)];
  float m = -INFINITY;
  for (int a = 0; a < side; ++a) {
    const int yy = min(max(y + a - r, 0), h - 1);
    for (int b = 0; b < side; ++b) {
      const int xx = min(max(x + b - r, 0), w - 1);
      const float t = 20.f * __ldg(score + (size_t)yy * w + xx);
      v[a * side + b] = t;
      m = fmaxf(m, t);
    }
  }
  float sum = 0.f;
  for (int j = 0; j < side * side; ++j) {
    v[j] = expf(v[j] - m);
    sum += v[j];
  }
  float dy = 0.f, dx = 0.f;
  for (int a = 0; a < side; ++a)
    for (int b = 0; b < side; ++b) {
      const float wgt = v[a * side + b] / sum;
      dy += wgt * (float)(a - r);
      dx += wgt * (float)(b - r);
    }
  xy[2 * i] = fminf(fmaxf((float)x + dx, 0.f), (float)w - 1.f);
  xy[2 * i + 1] = fminf(fmaxf((float)y + dy, 0.f), (float)h - 1.f);
  scores[i] = __ldg(score + idx);
}

}  // namespace aliked_dkd
}  // namespace ctt

// score (h, w); appends each peak's key to keys (h * w,) and counts them in
// count (1,), which must be 0. Returns cudaGetLastError().
extern "C" int aliked_dkd_peaks_f32(int h, int w, int r, float threshold, const float* score,
                                    unsigned long long* keys, int* count, cudaStream_t stream) {
  using namespace ctt::aliked_dkd;
  if (r < 0 || r > kMaxRadius) return (int)cudaErrorInvalidValue;
  if (h > 0 && w > 0) {
    const dim3 grid((w + 31) / 32, (h + 7) / 8);
    peaks_kernel<<<grid, dim3(32, 8), 0, stream>>>(h, w, r, threshold, score, keys, count);
  }
  return (int)cudaGetLastError();
}

// keys (n,) sorted; writes xy (n, 2) refined positions and scores (n,).
// Returns cudaGetLastError().
extern "C" int aliked_dkd_refine_f32(int h, int w, int r, int n, const float* score,
                                     const unsigned long long* keys, float* xy, float* scores,
                                     cudaStream_t stream) {
  using namespace ctt::aliked_dkd;
  if (r < 0 || r > kMaxRadius) return (int)cudaErrorInvalidValue;
  if (n > 0) refine_kernel<<<(n + 127) / 128, 128, 0, stream>>>(h, w, r, n, score, keys, xy, scores);
  return (int)cudaGetLastError();
}
